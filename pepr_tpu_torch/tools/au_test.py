"""AU-test CLI: per-site log-likelihoods -> AU/NP p-values per tree
(PyTorch port of `pepr_tpu/tools/au_test.py`).

Native replacement for the reference's CONSEL drive
(TreeComparison.java:812-885: raxml -f g -> makermt --puzzle ->
consel -> catpv).  Input is either a Tree-Puzzle `.sitelh` file (the
format `treecompare.sitelh_text` writes and `-f g` produces) or an
alignment file + trees to score directly with the pruning kernel (on
the card unless -device cpu).

Usage:
  python -m pepr_tpu_torch.tools.au_test -sitelh run.sitelh
  python -m pepr_tpu_torch.tools.au_test -alignment aln.afa -trees trees.nwk
      [-reps 2000] [-seed 1234] [-device cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from pepr_tpu_torch.io.alignio import parse_alignment
from pepr_tpu_torch.models.au_test import au_report, au_test
from pepr_tpu_torch.models.treecompare import per_site_log_likelihoods
from pepr_tpu_torch.tools import read_text
from pepr_tpu_torch.tree import parse_newick
from pepr_tpu_torch.utils.cli import RunProperties


def read_sitelh(path: str) -> np.ndarray:
    """Parse a Tree-Puzzle site-likelihood file: header `T L`, then one
    row per tree: name + L numbers."""
    with open(path) as fh:
        head = fh.readline().split()
        n_trees, length = int(head[0]), int(head[1])
        rows = []
        for _ in range(n_trees):
            toks = fh.readline().split()
            rows.append([float(x) for x in toks[1:length + 1]])
    return np.array(rows)


def main(argv: list[str] | None = None) -> int:
    rp = RunProperties(sys.argv[1:] if argv is None else argv)
    reps = rp.get_int("reps", 2000)
    seed = rp.get_int("seed", 1234)
    if rp.get("sitelh"):
        sl = read_sitelh(rp.get("sitelh"))
        names = None
    elif rp.get("alignment") and rp.get("trees"):
        # the file's text, not its path (the JAX CLI passes the path)
        aln = parse_alignment(read_text(rp.get("alignment")))
        with open(rp.get("trees")) as fh:
            trees = [parse_newick(line.strip()) for line in fh
                     if line.strip()]
        sl = per_site_log_likelihoods(trees, aln.mat, aln.taxa,
                                      device=rp.get("device"))
        names = [f"tree{i + 1}" for i in range(len(trees))]
    else:
        print(__doc__, file=sys.stderr)
        return 2
    res = au_test(np.asarray(sl), n_reps=reps, seed=seed)
    print(au_report(res, names))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
