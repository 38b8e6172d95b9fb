"""Outgroup rooting and support statistics.

Reproduces AdvancedTree.setOutGroup/getMostEnrichedNode
(AdvancedTree.java:647-780): root above the first ingroup leaf, score
every node by (outgroup descendants - ingroup descendants), take the
deepest preorder node attaining the max, and root midway on its parent
edge.  Taxon names are compared in "compressed" form
(TreeUtils.java:48-86).  Also the 0-1 -> 0-100 support normalization
(AdvancedTree.java:484-506) and per-node mean descendant supports
(AdvancedTree.java:1061-1098) driving refinement-candidate selection.
"""

from __future__ import annotations

import math
import re

import numpy as np

from pepr_tpu_torch.tree.basic import Tree, reroot_on_edge, unroot

_STRIP = re.compile(r"[._,\s]")


def compress_name(name: str) -> str:
    """Normalize a taxon name for cross-source comparison
    (TreeUtils.compressTaxonNameForComparison)."""
    r = name
    if re.match(r".*\.f.+", r):
        r = r[: r.rindex(".")]
    if r.endswith(".PATRIC"):
        r = r[: r.rindex(".")]
    return _STRIP.sub("", r).lower()


def root_by_outgroup(tree: Tree, outgroup: list[str]) -> Tree:
    """Root the tree to best separate `outgroup` taxa from the rest."""
    og = {compress_name(x) for x in outgroup}
    t = unroot(tree)
    leaves = t.leaves()
    leaf_is_out = {i: compress_name(t.labels[i]) in og for i in leaves}

    # Step 1: root above the first ingroup leaf so the outgroup is
    # somewhere below (AdvancedTree.java:668-686).
    anchor = next((i for i in leaves if not leaf_is_out[i]), leaves[0])
    if t.parent[anchor] >= 0:
        t = reroot_on_edge(t, anchor, 0.5)
        leaves = t.leaves()
        leaf_is_out = {i: compress_name(t.labels[i]) in og for i in leaves}

    # Step 2: out-minus-in enrichment per node; deepest preorder max.
    out_counts = np.zeros(t.n_nodes, dtype=np.int64)
    leaf_counts = np.zeros(t.n_nodes, dtype=np.int64)
    for node in t.postorder():
        kids = t.children[node]
        if not kids:
            leaf_counts[node] = 1
            out_counts[node] = 1 if leaf_is_out.get(node) else 0
        else:
            leaf_counts[node] = sum(leaf_counts[k] for k in kids)
            out_counts[node] = sum(out_counts[k] for k in kids)
    score = out_counts - (leaf_counts - out_counts)
    pre = t.preorder()
    best = pre[0]
    best_score = score[best]
    for node in pre[1:]:
        if score[node] >= best_score:
            best_score = score[node]
            best = node
    if t.parent[best] < 0:
        return t
    return reroot_on_edge(t, int(best), 0.5)


def normalize_supports(tree: Tree, scale_to: float = 100.0) -> Tree:
    """If all support values lie in [0, 1], scale to 0-100 (FastTree
    emits fractions; AdvancedTree.java:484-506)."""
    vals = tree.support[~np.isnan(tree.support)]
    out = tree.copy()
    if len(vals) and vals.max() <= 1.0:
        out.support = np.where(np.isnan(tree.support), tree.support,
                               tree.support * scale_to)
    return out


def mean_descendant_supports(tree: Tree) -> np.ndarray:
    """Per node: mean of the support values on all strictly descendant
    edges that carry one (NaN where no descendant edge has support)."""
    n = tree.n_nodes
    sums = np.zeros(n)
    cnts = np.zeros(n, dtype=np.int64)
    for node in tree.postorder():
        for k in tree.children[node]:
            sums[node] += sums[k]
            cnts[node] += cnts[k]
            if not math.isnan(tree.support[k]):
                sums[node] += tree.support[k]
                cnts[node] += 1
    with np.errstate(invalid="ignore"):
        return np.where(cnts > 0, sums / np.maximum(cnts, 1), math.nan)
