"""Bipartition (taxon bitset) algebra over trees.

Python arbitrary-precision ints serve as the taxon bitsets (the role of
the reference's ExtendedBitSet, util/ExtendedBitSet.java:7-46).
Bipartitions are canonicalized by always keeping the side that excludes
taxon 0, mirroring the smaller/larger-side canonical form of
Bipartition.java:125-197.  Support decoration counts how many support
trees contain each main-tree bipartition
(TreeSupportDecorator.java:86-163).
"""

from __future__ import annotations

import math

import numpy as np

from pepr_tpu_torch.tree.basic import Tree, unroot


def taxon_index(taxa: list[str]) -> dict[str, int]:
    return {t: i for i, t in enumerate(taxa)}


def node_leafsets(tree: Tree, index: dict[str, int]) -> list[int]:
    """Bitmask of descendant taxa for every node (taxa not in `index`
    are ignored)."""
    masks = [0] * tree.n_nodes
    for node in tree.postorder():
        kids = tree.children[node]
        if not kids:
            i = index.get(tree.labels[node])
            masks[node] = (1 << i) if i is not None else 0
        else:
            m = 0
            for k in kids:
                m |= masks[k]
            masks[node] = m
    return masks


def canonical(mask: int, full: int) -> int:
    """Canonical form of a bipartition: the side not containing bit 0."""
    return (full & ~mask) if (mask & 1) else mask


def bipartitions(tree: Tree, index: dict[str, int],
                 trivial: bool = False) -> set[int]:
    """Set of canonical internal-edge bipartitions of the (unrooted)
    tree over the taxa in `index`."""
    t = unroot(tree)
    full = (1 << len(index)) - 1
    masks = node_leafsets(t, index)
    root = t.root
    out: set[int] = set()
    n_taxa = len(index)
    for node in range(t.n_nodes):
        if node == root:
            continue
        m = masks[node]
        size = bin(m).count("1")
        if not trivial and (size <= 1 or size >= n_taxa - 1):
            continue
        if size == 0 or size == n_taxa:
            continue
        out.add(canonical(m, full))
    return out


def bipartition_counts(trees: list[Tree], index: dict[str, int]) -> dict[int, int]:
    """Multiset of bipartitions over a collection of (support) trees —
    each tree contributes each of its bipartitions once
    (BipartitionSet.java:155-180 counting role)."""
    counts: dict[int, int] = {}
    for t in trees:
        for b in bipartitions(t, index):
            counts[b] = counts.get(b, 0) + 1
    return counts


def decorate_supports(main: Tree, support_trees: list[Tree]) -> Tree:
    """Write onto each internal edge of `main` the number of support
    trees containing that bipartition (TreeSupportDecorator.java:86-163;
    with the default 100 jackknife replicates the count doubles as a
    percentage).  Trivial edges and the root keep NaN."""
    taxa = sorted(main.leaf_labels())
    index = taxon_index(taxa)
    counts = bipartition_counts(support_trees, index)
    full = (1 << len(index)) - 1
    masks = node_leafsets(main, index)
    out = main.copy()
    root = main.root
    n_taxa = len(index)
    root_kids = main.children[root]
    for node in range(main.n_nodes):
        if node == root or main.is_leaf(node):
            continue
        m = masks[node]
        size = bin(m).count("1")
        if size <= 1 or size >= n_taxa - 1:
            continue
        out.support[node] = counts.get(canonical(m, full), 0)
    # A rooted tree's two root edges are the same unrooted bipartition;
    # both get the same count (the reference unroots before counting).
    if len(root_kids) == 2:
        a, b = root_kids
        vals = [out.support[a], out.support[b]]
        good = [v for v in vals if not math.isnan(v)]
        if good:
            v = max(good)
            for k in (a, b):
                if not main.is_leaf(k):
                    out.support[k] = v
    return out


def rf_distance(t1: Tree, t2: Tree) -> int:
    """Robinson-Foulds distance (symmetric difference of bipartition
    sets; AdvancedTree.java:1460-1483)."""
    taxa = sorted(set(t1.leaf_labels()) & set(t2.leaf_labels()))
    index = taxon_index(taxa)
    b1 = bipartitions(t1, index)
    b2 = bipartitions(t2, index)
    return len(b1 ^ b2)


def compatible(a: int, b: int, full: int) -> bool:
    """Two bipartitions are compatible if some side-pair is disjoint
    (Bipartition.java:125-149)."""
    return (a & b) == 0 or (a & ~b & full) == 0 or \
        (~a & b & full) == 0 or (~a & ~b & full) == 0


def conflict_cost(bip: int, counts: dict[int, int], full: int) -> float:
    """Sum of counts of bipartitions in `counts` incompatible with
    `bip`, normalized by total count mass — the per-bipartition conflict
    cost used by the congruence filter (BipartitionSet.java:577-605)."""
    total = sum(counts.values())
    if total == 0:
        return 0.0
    bad = sum(c for b, c in counts.items() if not compatible(bip, b, full))
    return bad / total


def bipartition_supports(counts: dict[int, int],
                         full: int) -> dict[int, float]:
    """Direct support per bipartition: count / (count + total count of
    incompatible bipartitions) (BipartitionSet.java:560-605)."""
    bips = list(counts)
    out: dict[int, float] = {}
    for b in bips:
        bad = sum(counts[c] for c in bips
                  if c != b and not compatible(b, c, full))
        out[b] = counts[b] / (counts[b] + bad)
    return out


def select_compatible(counts: dict[int, int], full: int,
                      support_cutoff: float = 0.5) -> list[int]:
    """Greedy mutually-compatible subset selection
    (BipartitionSet.findCompatibleBipartitionSet, :356-512): first drop
    every bipartition conflicting with one whose direct support exceeds
    `support_cutoff`, then repeatedly drop the lowest-support member
    until the survivors are mutually compatible.  Returns the selected
    bipartitions sorted by descending count."""
    bips = list(counts)
    sup = bipartition_supports(counts, full)
    retained = set(bips)
    for b in bips:
        if sup[b] > support_cutoff:
            for c in bips:
                if not compatible(b, c, full):
                    retained.discard(c)
    cur = sorted(retained, key=lambda b: -counts[b])
    while True:
        worst, worst_sup = None, 1.0
        for b in cur:
            bad = sum(counts[c] for c in cur
                      if c != b and not compatible(b, c, full))
            s = counts[b] / (counts[b] + bad)
            if s < worst_sup:
                worst, worst_sup = b, s
        if worst is None:
            break  # mutually compatible
        cur.remove(worst)
    return cur


def bipartitions_as_matrix(bips: list[int], taxa: list[str],
                           participating: dict[int, int] | None = None
                           ) -> list[str]:
    """0/1/? character matrix: one row per taxon, one column per
    bipartition — '1' if the taxon is on the bipartition's smaller
    side, '0' if it participates on the other side, '?' if it does not
    participate (BipartitionSet.getBipartitionsAsSequenceAlignment,
    :229-267).  `participating` maps bipartition -> participating-taxon
    mask (defaults to all taxa)."""
    n = len(taxa)
    full = (1 << n) - 1
    rows = []
    for i in range(n):
        bit = 1 << i
        chars = []
        for b in bips:
            part = full if participating is None else \
                participating.get(b, full)
            size = bin(b & part).count("1")
            psize = bin(part).count("1")
            small = (b & part) if 2 * size <= psize else (part & ~b)
            if small & bit:
                chars.append("1")
            elif part & bit:
                chars.append("0")
            else:
                chars.append("?")
        rows.append("".join(chars))
    return rows
