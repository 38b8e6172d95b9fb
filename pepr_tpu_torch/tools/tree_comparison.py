"""Tree comparison CLI (TreeComparison.java:30-126 role; PyTorch port of
`pepr_tpu/tools/tree_comparison.py`).

Usage: python -m pepr_tpu_torch.tools.tree_comparison t1.nwk t2.nwk
           [-align aln.phy -sitelh out.sitelh] [-device cpu]
Prints RF distance and (normalized) branch-score distance; with an
alignment, writes per-site log-likelihoods in Tree-Puzzle format (the
CONSEL/AU-test input the reference produces via raxml -f g), computed
on the card unless -device cpu."""

from __future__ import annotations

import sys

from pepr_tpu_torch.io.alignio import parse_alignment
from pepr_tpu_torch.models.treecompare import (compare_trees,
                                               per_site_log_likelihoods,
                                               sitelh_text)
from pepr_tpu_torch.tools import read_text
from pepr_tpu_torch.tree import parse_newick
from pepr_tpu_torch.utils.cli import RunProperties


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    files = [a for a in argv if not a.startswith("-")][:2]
    rp = RunProperties(argv)
    if len(files) < 2:
        print(__doc__)
        return 2
    t1 = parse_newick(read_text(files[0]))
    t2 = parse_newick(read_text(files[1]))
    result = compare_trees(t1, t2)
    for k, v in result.items():
        print(f"{k}\t{v}")
    aln = rp.get("align")
    if aln:
        a = parse_alignment(read_text(aln))
        lls = per_site_log_likelihoods([t1, t2], a.mat, a.taxa,
                                       device=rp.get("device"))
        out = rp.get("sitelh", "trees.sitelh")
        with open(out, "w") as fh:
            fh.write(sitelh_text(lls))
        print(f"per-site log-likelihoods written to {out}")
        print(f"total_ll_tree1\t{lls[0].sum():.4f}")
        print(f"total_ll_tree2\t{lls[1].sum():.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
