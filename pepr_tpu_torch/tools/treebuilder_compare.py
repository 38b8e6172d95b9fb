"""Tree-builder comparison harness (TreeBuilderComparator.java:77-119
role; PyTorch port of `pepr_tpu/tools/treebuilder_compare.py`): build a
tree from the same alignment with each requested method, report wall
time, log-likelihood (under WAG+Gamma at the estimated alpha), and
pairwise RF distances.  On the card unless -device cpu; each method's
seconds end when the card has finished its work.

Usage: python -m pepr_tpu_torch.tools.treebuilder_compare aln.afa
           [-methods ml,fast_ml,nj,parsimony_bl] [-device cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from pepr_tpu_torch.device import resolve_device
from pepr_tpu_torch.io.alignio import parse_alignment
from pepr_tpu_torch.models.treebuild import (estimate_gamma_alpha, ml_tree,
                                             nj_start_tree, nj_tree,
                                             parsimony_tree)
from pepr_tpu_torch.ops.likelihood import WagModel, loglik, tree_to_arrays
from pepr_tpu_torch.tools import read_text
from pepr_tpu_torch.tree import rf_distance, to_newick
from pepr_tpu_torch.utils.cli import RunProperties


def compare_builders(mat: np.ndarray, taxa: list[str], methods: list[str],
                     device=None) -> dict:
    """Returns {method: {seconds, log_likelihood, tree}} plus pairwise
    RF distances under key 'rf'."""
    dev = resolve_device(device)

    def synced_clock() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.time()

    alpha = estimate_gamma_alpha(mat, taxa,
                                 nj_start_tree(mat, taxa, device=dev),
                                 device=dev)
    model = WagModel.create(alpha=alpha)
    out: dict = {"alpha": alpha}
    trees = {}
    for m in methods:
        t0 = synced_clock()
        if m == "nj":
            tree = nj_tree(mat, taxa, device=dev)
        elif m == "fast_ml":
            tree, _ = ml_tree(mat, taxa, model, nni_rounds=2,
                              bl_steps=60, bl_refine_steps=30,
                              spr_rounds=0, device=dev)
        elif m == "ml":
            tree, _ = ml_tree(mat, taxa, model, device=dev)
        elif m in ("parsimony", "parsimony_bl"):
            tree, _ = parsimony_tree(mat, taxa, model=model,
                                     branch_lengths=m == "parsimony_bl",
                                     device=dev)
        else:
            raise ValueError(f"unknown method {m!r}")
        secs = synced_clock() - t0
        arr = tree_to_arrays(tree, taxa)
        ll = loglik(mat, arr.children, arr.blen, model, device=dev)
        trees[m] = tree
        out[m] = {"seconds": secs, "log_likelihood": ll,
                  "tree": to_newick(tree)}
    out["rf"] = {f"{a}-{b}": rf_distance(trees[a], trees[b])
                 for i, a in enumerate(methods)
                 for b in methods[i + 1:]}
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    files = [a for a in argv if not a.startswith("-")][:1]
    rp = RunProperties(argv)
    if not files:
        print(__doc__)
        return 2
    a = parse_alignment(read_text(files[0]))
    methods = rp.get("methods", "fast_ml,nj").split(",")
    res = compare_builders(a.mat, a.taxa, methods, device=rp.get("device"))
    print(f"alpha\t{res['alpha']:.4f}")
    for m in methods:
        r = res[m]
        print(f"{m}\tseconds={r['seconds']:.2f}\t"
              f"ll={r['log_likelihood']:.2f}")
    for pair, rf in res["rf"].items():
        print(f"rf\t{pair}\t{rf}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
