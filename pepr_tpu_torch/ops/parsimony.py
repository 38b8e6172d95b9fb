"""Fitch parsimony scoring (PyTorch port of `pepr_tpu/ops/parsimony.py`).

The parsimony tree methods of the reference (RAxMLRunner.java:134-140
`-y`, and the parsimony_bl two-phase at :215-280) need per-topology
parsimony step counts.  State sets are 20-bit masks in int32 over
sites; the postorder combine (intersect-else-union) walks the internal
nodes as the likelihood kernel does, with a batch of candidate
topologies along a leading axis, each step a gather and a few
elementwise operations over (K, L).

The reference runs this as an XLA `lax.scan`, not a Pallas kernel, so
here it is plain PyTorch on whatever device `codes` lies on.  `TALLY`
counts the batched calls and the topologies scored.
"""

from __future__ import annotations

import numpy as np
import torch

from pepr_tpu_torch.alphabet import N_AA

ALL_STATES = (1 << N_AA) - 1
# batched calls of fitch_sites_batch and the topologies they scored
TALLY = {"batches": 0, "topologies": 0}


def reset_counts() -> None:
    TALLY.update(batches=0, topologies=0)


def leaf_sets(codes: torch.Tensor) -> torch.Tensor:
    """(n_leaves, L) codes -> int32 state masks; ambiguous codes (>= 20)
    are the full set."""
    c = codes.to(torch.int32)
    one = torch.ones_like(c)
    return torch.where(c < N_AA,
                       torch.bitwise_left_shift(one, c.clamp(0, N_AA - 1)),
                       torch.full_like(c, ALL_STATES))


def fitch_sites_batch(codes: torch.Tensor,
                      children: torch.Tensor) -> torch.Tensor:
    """Per-site minimum substitution counts (Fitch), (K, L) int32, for K
    topologies over shared codes.

    codes: (n_leaves, L) int8 (ambiguous codes >= 20 become full sets);
    children: (K, n_int, 3) postorder child ids, -1 padding."""
    n_leaves, L = codes.shape
    K, n_int, width = children.shape
    ch = children.to(device=codes.device, dtype=torch.long)
    buf = torch.empty((K, n_leaves + n_int, L), dtype=torch.int32,
                      device=codes.device)
    buf[:, :n_leaves] = leaf_sets(codes)
    steps = torch.zeros((K, L), dtype=torch.int32, device=codes.device)
    rows = torch.arange(K, device=codes.device)
    for i in range(n_int):
        acc = buf[rows, ch[:, i, 0].clamp_min(0)]
        for k in range(1, width):
            cid = ch[:, i, k]
            child = buf[rows, cid.clamp_min(0)]
            inter = acc & child
            empty = (inter == 0) & (cid >= 0)[:, None]
            acc = torch.where(empty, acc | child,
                              torch.where((cid >= 0)[:, None], inter, acc))
            steps += empty.to(torch.int32)
        buf[:, n_leaves + i] = acc
    TALLY["batches"] += 1
    TALLY["topologies"] += K
    return steps


def fitch_sites(codes: torch.Tensor, children: torch.Tensor) -> torch.Tensor:
    """(L,) int32 Fitch steps per site of one topology (n_int, 3)."""
    return fitch_sites_batch(codes, children[None])[0]


def fitch_score_topologies(codes: torch.Tensor, children_batch: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """Weighted Fitch scores for a batch of topologies, (K,) float64
    (exact for integer steps and weights)."""
    steps = fitch_sites_batch(codes, children_batch)
    return (steps.double() * weights.double()).sum(-1)


def fitch_score(codes, children, site_weights=None, device=None) -> float:
    """Total (weighted) Fitch score of one topology."""
    from pepr_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    steps = fitch_sites(torch.as_tensor(np.asarray(codes, np.int8),
                                        device=dev),
                        torch.as_tensor(np.asarray(children, np.int64),
                                        device=dev))
    if site_weights is not None:
        w = torch.as_tensor(np.asarray(site_weights, np.float64), device=dev)
        return float((steps.double() * w).sum())
    return float(steps.sum())


def fitch_numpy(codes: np.ndarray, children: np.ndarray) -> int:
    """Oracle."""
    n_leaves, L = codes.shape
    total = 0
    for s in range(L):
        sets = {}
        for i in range(n_leaves):
            c = codes[i, s]
            sets[i] = (1 << int(c)) if c < N_AA else ALL_STATES
        steps = 0
        for k in range(children.shape[0]):
            acc = None
            for cid in children[k]:
                if cid < 0:
                    continue
                child = sets[int(cid)]
                if acc is None:
                    acc = child
                elif acc & child:
                    acc &= child
                else:
                    acc |= child
                    steps += 1
            sets[n_leaves + k] = acc
        total += steps
    return total
