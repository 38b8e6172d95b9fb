"""Gene-congruence filter (port of `pepr_tpu/models/congruence.py`, on
the host with Python-int bitsets as there, its two loops over
bipartitions done as numpy array operations: the same bipartitions in
the same order and the same scores).

Reference behavior (PhylogenomicPipeline2.java:429-511): pool the
per-column character bipartitions of all gene alignments, keep the
top 4N most frequent bipartitions, score each gene by the mean
conflict cost of its own column bipartitions against that top set
(BipartitionSet.java:577-605: count mass of incompatible
bipartitions), and drop the worst `drop_fraction` (10%) of genes.
"""

from __future__ import annotations

import numpy as np

from pepr_tpu_torch.alphabet import N_AA
from pepr_tpu_torch.models.msa import Alignment
from pepr_tpu_torch.tree.bipartition import canonical


def _membership(masks: list[int], n: int) -> np.ndarray:
    """(len(masks), n) uint8: bit i of each Python-int bitset."""
    nbytes = max((n + 7) // 8, 1)
    buf = b"".join(m.to_bytes(nbytes, "little") for m in masks)
    rows = np.frombuffer(buf, np.uint8).reshape(len(masks), nbytes)
    return np.unpackbits(rows, axis=1, bitorder="little")[:, :n]


def column_bipartitions(aln: Alignment, t_index: dict[str, int],
                        min_side: int = 2) -> list[int]:
    """Character-class bipartitions of every column
    (SequenceAlignment.java:808-902): each residue class with at least
    `min_side` members on both sides defines a taxon bipartition.

    Vectorized: per residue class, taxon membership over all columns is
    one (n_taxa, n_rows) @ (n_rows, L) contraction; only the qualifying
    (class, column) pairs are materialized as python-int bitsets, packed
    for all of a class's columns at once."""
    n_tot = len(t_index)
    full = (1 << n_tot) - 1
    rows = np.array([t_index.get(t, -1) for t in aln.taxa], dtype=np.int64)
    keep = rows >= 0
    mat = aln.mat[keep]
    ti = rows[keep]
    if mat.size == 0:
        return []
    onehot_t = np.zeros((n_tot, mat.shape[0]), dtype=np.float32)
    onehot_t[ti, np.arange(mat.shape[0])] = 1
    out: list[int] = []
    for a in range(N_AA):
        hit = (mat == a)
        if not hit.any():
            continue
        # (n_tot, L); a float32 product of 0/1 values is exact
        memb = (onehot_t @ hit.astype(np.float32)) > 0
        sizes = memb.sum(axis=0)
        cols = np.nonzero((sizes >= min_side)
                          & (sizes <= n_tot - min_side))[0]
        # each qualifying column's membership as little-endian bytes
        packed = np.ascontiguousarray(
            np.packbits(memb[:, cols], axis=0, bitorder="little").T)
        out.extend(canonical(int.from_bytes(row.tobytes(), "little"), full)
                   for row in packed)
    return out


def congruence_scores(alignments: list[Alignment],
                      top_multiplier: int = 4) -> np.ndarray:
    """Per-gene mean conflict cost (higher = less congruent)."""
    taxa: dict[str, None] = {}
    for a in alignments:
        for t in a.taxa:
            taxa.setdefault(t, None)
    t_index = {t: i for i, t in enumerate(taxa)}
    full = (1 << len(t_index)) - 1

    gene_bips = [column_bipartitions(a, t_index) for a in alignments]
    counts: dict[int, int] = {}
    for bips in gene_bips:
        for b in bips:
            counts[b] = counts.get(b, 0) + 1
    top_n = top_multiplier * len(t_index)
    top = dict(sorted(counts.items(), key=lambda kv: -kv[1])[:top_n])
    total = sum(top.values()) or 1

    # conflict cost of each distinct bipartition: the count mass of the
    # top bipartitions it is incompatible with (no side pair disjoint)
    n = len(t_index)
    distinct = list(counts)
    cost: dict[int, float] = {}
    if distinct and top:
        a = _membership(distinct, n).astype(np.float32)
        t = _membership(list(top), n).astype(np.float32)
        both = a @ t.T  # exact integer counts
        size_a = a.sum(axis=1)[:, None]
        size_t = t.sum(axis=1)[None, :]
        compat = (both == 0) | (both == size_a) | (both == size_t) \
            | (n - size_a - size_t + both == 0)
        bad = (~compat).astype(np.int64) @ np.array(list(top.values()),
                                                     np.int64)
        cost = dict(zip(distinct, (bad / total).tolist()))

    scores = np.zeros(len(alignments))
    for g, bips in enumerate(gene_bips):
        if bips:
            scores[g] = float(np.mean([cost[b] for b in bips]))
    return scores


def filter_congruent(alignments: list[Alignment],
                     drop_fraction: float = 0.1,
                     top_multiplier: int = 4) -> list[Alignment]:
    """Drop the `drop_fraction` least congruent genes."""
    if len(alignments) < 3 or drop_fraction <= 0:
        return alignments
    scores = congruence_scores(alignments, top_multiplier)
    n_drop = int(len(alignments) * drop_fraction)
    if n_drop == 0:
        return alignments
    worst = set(np.argsort(-scores)[:n_drop])
    return [a for g, a in enumerate(alignments) if g not in worst]
