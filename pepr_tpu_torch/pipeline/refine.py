"""Progressive refinement: re-run the pipeline on low-support subtrees
(PyTorch port of `pepr_tpu/pipeline/refine.py`; host code only).

Reproduces PhylogeneticTreeRefiner (PhylogeneticTreeRefiner.java:81-359):
pick the first preorder node (skipping the root and its first child)
with mean descendant support below the cutoff, own branch support at
the cutoff, >= 3 descendant leaves, not all children fully supported,
and a not-yet-refined taxon subset; rebuild that subtree with the
subtree's siblings (up to 2) as outgroup; root the refined subtree by
that outgroup and graft the larger root-child side back, keeping the
old edge length (AdvancedTree.replaceNode:1156-1207 /
BasicTree.replaceSubtreeBelow:976-1077 keep-old-branch semantics).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from pepr_tpu_torch.tree import (Tree, mean_descendant_supports,
                                 root_by_outgroup, unroot)
from pepr_tpu_torch.tree.basic import replace_subtree, subtree_below


@dataclass
class RefineCandidate:
    node: int
    ingroup: list[str]
    outgroup: list[str]


def next_refine_candidate(tree: Tree, cutoff: float,
                          refined_subsets: set[frozenset],
                          min_leaves: int = 3) -> RefineCandidate | None:
    """PhylogeneticTreeRefiner.getNextIndexToRefine (:298-359).  The
    reference marks a failing candidate's subset as refined and returns
    -1 for that probe (retrying on the next call); here we continue the
    scan, which visits candidates in the same preorder priority."""
    mean_sup = mean_descendant_supports(tree)
    pre = [int(x) for x in tree.preorder()]
    for node in pre[2:]:
        if tree.is_leaf(node):
            continue
        leaves = [tree.labels[i] for i in tree.descendant_leaves(node)]
        subset = frozenset(leaves)
        if subset in refined_subsets:
            continue
        sup = tree.support[node]
        m = mean_sup[node]
        if math.isnan(sup) or sup < cutoff:
            continue
        if not (not math.isnan(m) and m < cutoff):
            continue
        if len(leaves) < min_leaves:
            continue
        kids = tree.children[node]
        kid_sups = [tree.support[k] for k in kids]
        if all((not math.isnan(s)) and s >= cutoff for s in kid_sups):
            continue
        refined_subsets.add(subset)
        # outgroup: the parent's other descendants (all of them become
        # the outgroup pool; the sub-run uses outgroup_count <= 2)
        parent = int(tree.parent[node])
        if parent < 0:
            continue
        parent_leaves = [tree.labels[i]
                         for i in tree.descendant_leaves(parent)]
        outgroup = [t for t in parent_leaves if t not in subset]
        if not outgroup:
            continue
        return RefineCandidate(node, leaves, outgroup)
    return None


def graft_refined_subtree(big: Tree, refined: Tree,
                          refine_outgroup: list[str]) -> Tree:
    """Root `refined` by its outgroup, take the larger root-child side,
    and swap it in for the matching clade of `big`."""
    rooted = root_by_outgroup(refined, refine_outgroup)
    kids = rooted.children[rooted.root]
    sides = [(len(rooted.descendant_leaves(k)), k) for k in kids]
    sides.sort(reverse=True)
    ingroup_side = sides[0][1]
    sub = subtree_below(rooted, ingroup_side)
    members = set(sub.leaf_labels())

    target = None
    for node in [int(x) for x in big.preorder()]:
        leaves = {big.labels[i] for i in big.descendant_leaves(node)}
        if len(leaves) <= len(members) and leaves <= members:
            target = node
            break
    if target is None:
        raise ValueError("no graft target found")
    return replace_subtree(big, target, sub)


def refine_tree(initial: Tree, outgroup: list[str], run_subtree_fn, *,
                cutoff: float = 100.0, max_rounds: int = 10,
                on_round=None) -> Tree:
    """The refinement loop.  `run_subtree_fn(ingroup_taxa,
    outgroup_taxa, round_idx) -> Tree` re-runs the pipeline on the
    subset (the recursive `new PhyloPipeline(...)` of the reference).
    """
    tree = root_by_outgroup(initial, outgroup) if outgroup else initial
    refined_subsets: set[frozenset] = set()
    for round_idx in range(1, max_rounds + 1):
        cand = next_refine_candidate(tree, cutoff, refined_subsets)
        if cand is None:
            break
        sub = run_subtree_fn(cand.ingroup, cand.outgroup, round_idx)
        tree = graft_refined_subtree(tree, sub, cand.outgroup)
        tree = unroot(tree)
        if outgroup:
            tree = root_by_outgroup(tree, outgroup)
        if on_round is not None:
            on_round(round_idx, tree)
    return tree
