"""Markov clustering (MCL) as batched dense matrix iteration.

Replacement for the reference's native `mcl` invocation
(PhyloPipeline.java:882-909: `mcl <abc> --abc -I 1.5 -te <threads>`).

MCL never merges disconnected components, so the hit graph is first
split into connected components on the host (union-find over the edge
list in the native library, `native/fastio.cpp`, as in the JAX
package), the components are bucketed by padded size, and each bucket runs
the expand (batched float32 `torch.bmm`) -> inflate (elementwise power)
-> renormalize loop on the device until convergence.  Self-loops are
added per column with the column's max edge weight (mcl's default loop
heuristic).
"""

from __future__ import annotations

import numpy as np
import torch

from pepr_tpu_torch.device import resolve_device
from pepr_tpu_torch.native import native_connected_components


# -- host side: union-find components -------------------------------------

def connected_components(n: int, edges_i: np.ndarray,
                         edges_j: np.ndarray) -> np.ndarray:
    """Each node's component root, by the native union-find."""
    return native_connected_components(n, edges_i, edges_j)


def connected_components_reference(n: int, edges_i: np.ndarray,
                                   edges_j: np.ndarray) -> np.ndarray:
    """`connected_components` in Python (the same roots)."""
    parent = np.arange(n, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for a, b in zip(edges_i, edges_j):
        ra, rb = find(int(a)), find(int(b))
        if ra != rb:
            parent[rb] = ra
    return np.array([find(i) for i in range(n)], dtype=np.int64)


# -- device side: batched dense MCL ---------------------------------------

def _mcl_iterate(mats: torch.Tensor, inflation: float = 1.5,
                 max_iters: int = 60, prune: float = 1e-5) -> torch.Tensor:
    """Run MCL to (near) convergence on a batch of column-stochastic
    matrices (B, n, n) float32.  Padded rows/cols must be zero except a
    1 on the diagonal (isolated dummy nodes).  Stops after `max_iters`
    rounds or once no entry of the batch moved by more than 1e-8."""

    def normalize(m):
        # columns (dim -2 indexes the row within a column) sum to 1:
        # m[i, j] is the flow j -> i.
        col = m.sum(dim=-2, keepdim=True)
        return m / torch.where(col > 0, col, torch.ones_like(col))

    m = normalize(mats)
    for _ in range(max_iters):
        inf = normalize(torch.pow(torch.bmm(m, m), inflation))
        inf = torch.where(inf < prune, torch.zeros_like(inf), inf)
        inf = normalize(inf)
        delta = float((inf - m).abs().max())
        m = inf
        if not delta > 1e-8:
            break
    return m


def _interpret(mat: np.ndarray, n: int, eps: float = 1e-6) -> list[list[int]]:
    """Clusters from a converged MCL matrix: attractors are nodes with
    positive diagonal mass; each cluster is an attractor's row support;
    overlapping clusters are merged (standard MCL interpretation)."""
    m = mat[:n, :n]
    attractors = np.where(np.diag(m) > eps)[0]
    if len(attractors) == 0:
        return [list(range(n))]
    # merge attractors whose rows overlap
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    assigned = np.full(n, -1, dtype=np.int64)
    for a in attractors:
        support = np.where(m[a, :] > eps)[0]
        for s in support:
            ra, rs = find(int(a)), find(int(s))
            if ra != rs:
                parent[rs] = ra
    for i in range(n):
        assigned[i] = find(i)
    # nodes not reached by any attractor row join their strongest column
    clusters: dict[int, list[int]] = {}
    for i in range(n):
        clusters.setdefault(int(assigned[i]), []).append(i)
    return list(clusters.values())


def mcl_cluster(n: int, edges_i: np.ndarray, edges_j: np.ndarray,
                weights: np.ndarray, inflation: float = 1.5,
                max_iters: int = 60,
                size_buckets: tuple[int, ...] = (16, 32, 64, 128, 256, 512),
                device=None) -> list[list[int]]:
    """Cluster an undirected weighted graph.  Returns list of clusters
    (lists of node indices); singletons included.  The iteration runs
    on `device` (`resolve_device`: the card unless "cpu")."""
    dev = resolve_device(device)
    comp = connected_components(n, edges_i, edges_j)
    comp_ids = {}
    comp_nodes: list[list[int]] = []
    for node, c in enumerate(comp):
        k = comp_ids.setdefault(int(c), len(comp_nodes))
        if k == len(comp_nodes):
            comp_nodes.append([])
        comp_nodes[k].append(node)

    # adjacency per component
    node_comp = np.array([comp_ids[int(c)] for c in comp], dtype=np.int64)
    local_idx = np.zeros(n, dtype=np.int64)
    for nodes in comp_nodes:
        for li, node in enumerate(nodes):
            local_idx[node] = li

    comp_edges: list[list[tuple[int, int, float]]] = [[] for _ in comp_nodes]
    for a, b, w in zip(edges_i, edges_j, weights):
        c = node_comp[int(a)]
        comp_edges[c].append((int(local_idx[int(a)]),
                              int(local_idx[int(b)]), float(w)))

    clusters: list[list[int]] = []
    # bucket components by size
    by_bucket: dict[int, list[int]] = {}
    for ci, nodes in enumerate(comp_nodes):
        sz = len(nodes)
        if sz == 1:
            clusters.append(nodes)
            continue
        bucket = next((b for b in size_buckets if sz <= b), None)
        if bucket is None:
            bucket = int(2 ** np.ceil(np.log2(sz)))
        by_bucket.setdefault(bucket, []).append(ci)

    for bucket, comps in sorted(by_bucket.items()):
        mats = np.zeros((len(comps), bucket, bucket), dtype=np.float32)
        for bi, ci in enumerate(comps):
            sz = len(comp_nodes[ci])
            m = np.zeros((bucket, bucket), dtype=np.float32)
            for a, b, w in comp_edges[ci]:
                if a == b:
                    continue
                m[a, b] = max(m[a, b], w)
                m[b, a] = max(m[b, a], w)
            # self loops: column max (mcl default loop weight heuristic)
            colmax = m.max(axis=0)
            colmax[colmax <= 0] = 1.0
            np.fill_diagonal(m[:sz, :sz], colmax[:sz])
            # padded dummies: isolated self-loops
            for d in range(sz, bucket):
                m[d, d] = 1.0
            mats[bi] = m
        out = _mcl_iterate(torch.as_tensor(mats, device=dev),
                           inflation=inflation,
                           max_iters=max_iters).cpu().numpy()
        for bi, ci in enumerate(comps):
            nodes = comp_nodes[ci]
            for local_cluster in _interpret(out[bi], len(nodes)):
                clusters.append([nodes[i] for i in local_cluster])
    return clusters
