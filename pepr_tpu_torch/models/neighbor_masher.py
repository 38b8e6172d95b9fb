"""MinHash genome sketches and mash-style distances.

Parity with the reference's NeighborMasher utility
(util/NeighborMasher.java:44-673), which shells out to `mash` (MinHash
sketches, defaults k=21 s=100000) for genome-genome distances, expands
the ingroup, selects outgroups by distance thresholds, and builds NJ
trees from the distances.  Host-side numpy implementation (sketching
is an ingest-time operation, not a hot kernel).  A copy of
`pepr_tpu/models/neighbor_masher.py`: the hash relies on numpy's uint64
wrap-around, which torch cannot multiply on the card, so it stays numpy.
"""

from __future__ import annotations

import numpy as np

from pepr_tpu_torch.alphabet import N_AA
from pepr_tpu_torch.io.fasta import SequenceSet
from pepr_tpu_torch.tree import neighbor_joining
from pepr_tpu_torch.tree.basic import Tree

_MULT = np.uint64(0x9E3779B97F4A7C15)


def minhash_sketch(genome: SequenceSet, k: int = 9,
                   sketch_size: int = 10000) -> np.ndarray:
    """Bottom-s MinHash sketch over all amino-acid k-mers of a genome
    (the `mash sketch` role; k adapted for protein alphabets)."""
    hashes = []
    for seq in genome.seqs:
        s = np.asarray(seq, dtype=np.int64)
        if len(s) < k:
            continue
        valid = s < N_AA
        W = len(s) - k + 1
        h = np.zeros(W, dtype=np.uint64)
        ok = np.ones(W, dtype=bool)
        for j in range(k):
            h = h * _MULT + s[j:W + j].astype(np.uint64)
            ok &= valid[j:W + j]
        h = (h ^ (h >> np.uint64(31))) * _MULT
        hashes.append(h[ok])
    if not hashes:
        return np.zeros(0, dtype=np.uint64)
    allh = np.unique(np.concatenate(hashes))
    return allh[:sketch_size]


def mash_distance(a: np.ndarray, b: np.ndarray, k: int = 9) -> float:
    """Mash distance from two bottom sketches: Jaccard estimate over
    the merged bottom-s set, then d = -ln(2j/(1+j))/k."""
    if len(a) == 0 or len(b) == 0:
        return 1.0
    s = min(len(a), len(b))
    merged = np.unique(np.concatenate([a, b]))[:s]
    shared = np.intersect1d(merged, a, assume_unique=True)
    shared = np.intersect1d(shared, b, assume_unique=True)
    j = len(shared) / s
    if j <= 0:
        return 1.0
    return float(-np.log(2 * j / (1 + j)) / k)


def distance_matrix(genomes: list[SequenceSet], k: int = 9,
                    sketch_size: int = 10000):
    sketches = [minhash_sketch(g, k, sketch_size) for g in genomes]
    n = len(genomes)
    d = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            d[i, j] = d[j, i] = mash_distance(sketches[i], sketches[j], k)
    return d, sketches


def mash_nj_tree(genomes: list[SequenceSet], **kw) -> Tree:
    """NJ tree from mash distances (NeighborMasher.java:654-673)."""
    d, _ = distance_matrix(genomes, **kw)
    return neighbor_joining(d, [g.taxon for g in genomes])


def select_outgroups_by_distance(ingroup: list[SequenceSet],
                                 pool: list[SequenceSet], count: int = 2,
                                 k: int = 9,
                                 sketch_size: int = 10000) -> list[str]:
    """Outgroup selection by distance thresholds
    (NeighborMasher.java:483-568): prefer the pool genomes closest to
    the ingroup while still outside the ingroup's own diameter."""
    in_sk = [minhash_sketch(g, k, sketch_size) for g in ingroup]
    po_sk = [minhash_sketch(g, k, sketch_size) for g in pool]
    n_in = len(ingroup)
    diam = 0.0
    for i in range(n_in):
        for j in range(i + 1, n_in):
            diam = max(diam, mash_distance(in_sk[i], in_sk[j], k))
    scored = []
    for gi, sk in enumerate(po_sk):
        dists = [mash_distance(sk, s, k) for s in in_sk]
        mean_d = float(np.mean(dists)) if dists else 1.0
        outside = min(dists) >= diam if dists else True
        scored.append((not outside, mean_d, gi))
    scored.sort()
    return [pool[gi].taxon for _, _, gi in scored[:count]]
