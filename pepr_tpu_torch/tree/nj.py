"""Neighbor joining (Saitou & Nei) on a distance matrix.

The role of the reference's pure-Java TreeBuilder (TreeBuilder.java:
152-344: Q-matrix, pair merge, 3-node termination).  Vectorized numpy —
taxon counts in this pipeline are small (tens-hundreds), so the O(n^3)
host implementation is never the bottleneck; guide trees for thousands
of sequences use the same routine on k-mer distances.
"""

from __future__ import annotations

import math

import numpy as np

from pepr_tpu_torch.tree.basic import Tree


def neighbor_joining(dist: np.ndarray, names: list[str]) -> Tree:
    """Build an unrooted NJ tree (root trifurcation) from a symmetric
    distance matrix."""
    n = len(names)
    if n < 2:
        raise ValueError("need >= 2 taxa")
    if n == 2:
        parent = np.array([2, 2, -1], dtype=np.int32)
        d = max(float(dist[0, 1]), 0.0)
        return Tree(parent, [names[0], names[1], None],
                    np.array([d / 2, d / 2, math.nan]),
                    np.array([math.nan] * 3))

    # Active nodes hold their eventual node id in the output tree.
    total = 2 * n - 2  # unrooted binary: n leaves + n-2 internals
    parent = np.full(total, -1, dtype=np.int32)
    blen = np.full(total, math.nan)
    labels: list = list(names) + [None] * (n - 2)

    d = np.asarray(dist, dtype=np.float64).copy()
    active = list(range(n))  # output-node ids, row i of d <-> active[i]
    next_internal = n

    while len(active) > 3:
        m = len(active)
        r = d.sum(axis=1)
        q = (m - 2) * d - r[:, None] - r[None, :]
        np.fill_diagonal(q, np.inf)
        i, j = np.unravel_index(np.argmin(q), q.shape)
        if i > j:
            i, j = j, i
        dij = d[i, j]
        li = 0.5 * dij + (r[i] - r[j]) / (2 * (m - 2))
        lj = dij - li
        u = next_internal
        next_internal += 1
        parent[active[i]] = u
        parent[active[j]] = u
        blen[active[i]] = max(li, 0.0)
        blen[active[j]] = max(lj, 0.0)
        # distances from new node to the rest
        du = 0.5 * (d[i, :] + d[j, :] - dij)
        # replace row i with u, delete row j
        d[i, :] = du
        d[:, i] = du
        d[i, i] = 0.0
        keep = [k for k in range(m) if k != j]
        d = d[np.ix_(keep, keep)]
        active[i] = u
        active.pop(j)

    # Final 3 nodes join at the root trifurcation.
    u = next_internal
    assert u == total - 1 + 0 or True
    a, b, c = active
    ia, ib, ic = 0, 1, 2
    la = 0.5 * (d[ia, ib] + d[ia, ic] - d[ib, ic])
    lb = 0.5 * (d[ia, ib] + d[ib, ic] - d[ia, ic])
    lc = 0.5 * (d[ia, ic] + d[ib, ic] - d[ia, ib])
    for node, l in ((a, la), (b, lb), (c, lc)):
        parent[node] = u
        blen[node] = max(l, 0.0)
    return Tree(parent, labels, blen,
                np.full(total, math.nan))


def similarity_to_distance(sim: np.ndarray) -> np.ndarray:
    """Pairwise similarity scores -> additive distances: normalize each
    pair by self-similarity and negate (TreeBuilder.java:346-362 role)."""
    s = np.asarray(sim, dtype=np.float64)
    self_sim = np.diag(s)
    denom = np.sqrt(np.outer(self_sim, self_sim))
    denom[denom <= 0] = 1.0
    norm = np.clip(s / denom, 1e-9, 1.0)
    d = -np.log(norm)
    np.fill_diagonal(d, 0.0)
    return d
