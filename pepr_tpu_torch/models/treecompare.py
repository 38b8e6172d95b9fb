"""Offline tree comparison (TreeComparison.java parity; PyTorch port of
`pepr_tpu/models/treecompare.py`).

- Robinson-Foulds distance (:567-571) — pepr_tpu_torch.tree.rf_distance.
- Kuhner-Felsenstein branch-score distance, normalized (:607-747).
- Per-site log-likelihood export in Tree-Puzzle format (:812-885's
  raxml `-f g` step feeding CONSEL) — computed natively with the
  WAG+Gamma pruning kernel, so AU tests can be run downstream on the
  `.sitelh` file without RAxML.
- Common-taxon restriction before comparison (:83-126).

Per-site log-likelihoods score every tree of one shape in one batch:
a bifurcating root is spliced out first where its two edges can merge
into one (a reversible model's likelihood does not see the root), so
binary trees, rooted or not, all take one launch of the pruning forward
kernel over the shared codes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pepr_tpu_torch.device import resolve_device
from pepr_tpu_torch.ops.likelihood import (WagModel, loglik_sites,
                                           model_tensors, tree_to_arrays)

DEFAULT_BLEN = 0.1  # tree_to_arrays' length for a missing edge
from pepr_tpu_torch.tree import Tree, remove_taxa, rf_distance, unroot
from pepr_tpu_torch.tree.bipartition import (canonical, node_leafsets,
                                             taxon_index)


def restrict_to_common_taxa(t1: Tree, t2: Tree) -> tuple[Tree, Tree]:
    """Prune both trees to their shared taxon set
    (TreeComparison.java:83-126)."""
    s1 = set(t1.leaf_labels())
    s2 = set(t2.leaf_labels())
    common = s1 & s2
    out1 = remove_taxa(t1, s1 - common) if s1 - common else t1
    out2 = remove_taxa(t2, s2 - common) if s2 - common else t2
    return out1, out2


def _bipartition_lengths(tree: Tree, index: dict[str, int]) -> dict[int, float]:
    t = unroot(tree)
    full = (1 << len(index)) - 1
    masks = node_leafsets(t, index)
    out: dict[int, float] = {}
    root = t.root
    for node in range(t.n_nodes):
        if node == root:
            continue
        b = t.blen[node]
        if math.isnan(b):
            b = 0.0
        m = masks[node]
        if m == 0 or m == full:
            continue
        key = canonical(m, full)
        out[key] = out.get(key, 0.0) + float(b)
    return out


def branch_score_distance(t1: Tree, t2: Tree,
                          normalized: bool = True) -> float:
    """Kuhner-Felsenstein: sqrt of summed squared branch-length
    differences over the union of bipartitions (missing = 0); when
    `normalized`, branch lengths are first scaled by each tree's total
    length (TreeComparison.java:607-747)."""
    t1, t2 = restrict_to_common_taxa(t1, t2)
    taxa = sorted(t1.leaf_labels())
    index = taxon_index(taxa)
    b1 = _bipartition_lengths(t1, index)
    b2 = _bipartition_lengths(t2, index)
    if normalized:
        s1 = sum(b1.values()) or 1.0
        s2 = sum(b2.values()) or 1.0
        b1 = {k: v / s1 for k, v in b1.items()}
        b2 = {k: v / s2 for k, v in b2.items()}
    keys = set(b1) | set(b2)
    return float(np.sqrt(sum((b1.get(k, 0.0) - b2.get(k, 0.0)) ** 2
                             for k in keys)))


def kernel_tree(tree: Tree) -> Tree:
    """`tree` with a bifurcating root spliced out, scored as the rooted
    tree is: each root edge first takes the length `tree_to_arrays`
    gives it (a missing one 0.1), so the merged edge is the path
    between the root's children that the rooted tree is scored with.
    The root stays where the child that would take its place already
    has 3 children, or where both children are leaves."""
    kids = tree.children[tree.root]
    if len(kids) != 2:
        return tree
    a, b = kids
    if tree.is_leaf(a):
        a, b = b, a
    if tree.is_leaf(a) or len(tree.children[a]) > 2:
        return tree
    t = tree.copy()
    for k in kids:
        x = t.blen[k]
        t.blen[k] = max(float(x), 1e-8) if np.isfinite(x) and x >= 0 \
            else DEFAULT_BLEN
    return unroot(t)


def tree_batches(trees: list[Tree], taxa: list[str], dev
                 ) -> list[tuple[list[int], torch.Tensor, torch.Tensor]]:
    """The kernel arrays of `trees` (each through `kernel_tree`; leaves
    exactly `taxa`) grouped by shape: [(tree indices, children (B,
    n_int, 3) int32, branch lengths (B, V) float32)] on `dev`, one group
    for binary trees."""
    arrs = [tree_to_arrays(kernel_tree(t), taxa, DEFAULT_BLEN)
            for t in trees]
    groups: dict[int, list[int]] = {}
    for i, a in enumerate(arrs):
        groups.setdefault(a.children.shape[0], []).append(i)
    return [(idx,
             torch.as_tensor(np.stack([arrs[i].children for i in idx]),
                             device=dev),
             torch.as_tensor(np.stack([arrs[i].blen for i in idx]),
                             device=dev))
            for idx in groups.values()]


def per_site_log_likelihoods(trees: list[Tree], mat: np.ndarray,
                             taxa: list[str], model: WagModel | None = None,
                             device=None) -> np.ndarray:
    """(n_trees, L) float32 per-site LLs under WAG+Gamma (or `model`)
    for fixed topologies (the `raxmlHPC -f g` role): one forward launch
    per group of `tree_batches`, over the shared codes."""
    dev = resolve_device(device)
    if model is None:
        model = WagModel.create()
    codes = torch.as_tensor(np.asarray(mat, np.int8), device=dev)
    margs = model_tensors(model, dev)
    out = np.zeros((len(trees), codes.shape[1]), np.float32)
    with torch.no_grad():
        for idx, ch, blen in tree_batches(trees, taxa, dev):
            out[idx] = loglik_sites(codes, ch, blen, *margs).cpu().numpy()
    return out


def sitelh_text(site_lls: np.ndarray) -> str:
    """Tree-Puzzle .sitelh format (consumable by CONSEL's makermt,
    the reference's AU-test input, TreeComparison.java:857-876)."""
    n, L = site_lls.shape
    lines = [f"  {n}  {L}"]
    for i in range(n):
        vals = " ".join(f"{x:.6f}" for x in site_lls[i])
        lines.append(f"tr{i + 1}\t{vals}")
    return "\n".join(lines) + "\n"


def compare_trees(t1: Tree, t2: Tree) -> dict:
    a, b = restrict_to_common_taxa(t1, t2)
    return {
        "rf": rf_distance(a, b),
        "branch_score": branch_score_distance(a, b, normalized=False),
        "branch_score_normalized": branch_score_distance(a, b),
        "common_taxa": len(a.leaf_labels()),
    }
