"""Batched profile-profile global alignment (affine Needleman-Wunsch),
the DP engine of the progressive MSA (PyTorch port of
`pepr_tpu/ops/profile_align.py`).

Profiles are (L, 20) residue-frequency columns; a column pair scores
the expected substitution score f1' B f2.  The DP runs as an
anti-diagonal wavefront over a batch of profile pairs and emits one
traceback pointer per cell, which the host walks (`traceback`) to get
the merge path.  The reference runs it as an XLA `lax.scan`, not a
Pallas kernel, so here it is plain PyTorch: the column scores are one
`bmm` per call, laid out skewed so that each step reads one contiguous
diagonal, and the per-diagonal gap costs and validity masks are
precomputed, leaving 14 elementwise ops a step.  On the card the step
loop of each (B, L1, L2) shape is captured once as a CUDA graph and
replayed (`_Plan`).

Pointer byte layout per cell: bits 0-1 = winning state of H
(0=M diag, 1=E gap-in-profile-1, 2=F gap-in-profile-2); bit 2 = E came
from gap-open (else extend); bit 3 = F came from gap-open.

Left out: the reference's `packed=` pointers and `unpack_ptrs` (a
transfer measure for the TPU's host link).
"""

from __future__ import annotations

import time
from collections import OrderedDict

import numpy as np
import torch

from pepr_tpu_torch.data.blosum62 import BLOSUM62

NEG = -1e30

PTR_M, PTR_E, PTR_F = 0, 1, 2
E_OPEN_BIT, F_OPEN_BIT = 4, 8

# Slots of a diagonal's state record: F, E, M (the diagonal move) and H.
_F, _E, _M, _H = 0, 1, 2, 3
# Share of the card's memory the cached plans (buffers and graph pools)
# may hold together.
PLAN_CACHE_SHARE = 0.25


def blosum_core(dtype=np.float32) -> np.ndarray:
    """20x20 substitution core used for profile column scores."""
    return BLOSUM62[:20, :20].astype(dtype)


class _Plan:
    """The buffers of one (B, L1, L2) DP shape, and its step loop.

    Diagonal k (cells (i, k - i), i = 0..L1) keeps its F, E, M and H
    values in `x[(k + 2) % 3]`, (4, B, L1 + 2): a ring of three
    diagonals, reset to NEG at the start of a run (diagonals -2 and -1).
    Column 0 holds NEG, so the row-shifted operand of a step (cell
    (i - 1, .)) is a view one column to the left of the unshifted one.
    `sd[k]` holds diagonal k's column scores and `invalid[k]` its cells
    outside (l1, l2); the gap costs of [F, E] are a sliding window over
    `go`/`ge` (F's terminal columns move along the diagonal, E's rows do
    not).  A step is 14 elementwise ops on these views, and H at row l1
    of each diagonal is kept for the score.
    """

    def __init__(self, B: int, L1: int, L2: int, dev: torch.device):
        self.B, self.dev = B, dev
        D, R1 = L1 + L2 + 1, L1 + 1
        self.D, self.R1 = D, R1
        # gap-cost rows: F's costs along the diagonal, reversed (position
        # D - 1 - j for column j), then E's costs by row
        self.wf = D + R1 - 1
        f32 = dict(dtype=torch.float32, device=dev)
        self.sd = torch.zeros((D, B, R1), **f32)
        self.go = torch.empty((B, self.wf + R1), **f32)
        self.ge = torch.empty((B, self.wf + R1), **f32)
        self.invalid = torch.empty((D, B, R1), dtype=torch.bool, device=dev)
        self.row_l1 = torch.zeros((B, 1), dtype=torch.int64, device=dev)
        self.x = torch.full((3, 4, B, R1 + 1), NEG, **f32)
        self.flag = torch.empty((4, B, R1), dtype=torch.uint8, device=dev)
        self.ptr = torch.empty((D, B, R1), dtype=torch.uint8, device=dev)
        self.h_l1 = torch.empty((D, B, 1), **f32)
        self.graph = None
        self.pool_bytes = 0
        # card memory the plan holds: its buffers, and (once captured)
        # the private pool of its graph
        self.nbytes = sum(t.numel() * t.element_size() for t in (
            self.sd, self.go, self.ge, self.invalid, self.x, self.flag,
            self.ptr, self.h_l1))

    def _pair(self, k: int, slot: int, shifts: tuple[int, int],
              gap: int) -> torch.Tensor:
        """(2, B, R1) view of diagonal k's slots `slot` and `slot + gap`
        (gap 0: the same slot twice), shifted left by shifts[0] and
        shifts[1] columns."""
        x = self.x
        rec = x.stride(1)
        base = x.storage_offset() + ((k + 2) % 3) * x.stride(0) + slot * rec
        s0 = 1 - shifts[0]
        s1 = gap * rec + 1 - shifts[1]
        return x.as_strided((2, self.B, self.R1),
                            (s1 - s0, x.stride(2), 1), base + s0)

    def _costs(self, g: torch.Tensor, k: int) -> torch.Tensor:
        """(2, B, R1) gap costs [F, E] of diagonal k's cells."""
        c0 = self.D - 1 - k
        return g.as_strided((2, self.B, self.R1),
                            (self.wf - c0, g.stride(0), 1),
                            g.storage_offset() + c0)

    def step(self, k: int) -> None:
        """Diagonal k from diagonals k-1 and k-2 (the JAX step's
        recurrences, tie order and masking)."""
        cur = self.x[(k + 2) % 3]
        hh = self._pair(k - 1, _H, (1, 0), 0)  # [H(i-1, j), H(i, j-1)]
        ef = self._pair(k - 1, _F, (1, 0), 1)  # [F(i-1, j), E(i, j-1)]
        opened = hh - self._costs(self.go, k)
        extended = ef - self._costs(self.ge, k)
        new_fe = cur[_F:_E + 1, :, 1:]
        torch.maximum(opened, extended, out=new_fe)
        torch.ge(opened, extended, out=self.flag[0:2])  # F, E open bits
        h2s = self.x[k % 3][_H, :, :-1]  # H(i-1, j-1)
        torch.add(h2s, self.sd[k], out=cur[_M, :, 1:])
        h = cur[_H, :, 1:]
        torch.maximum(cur[_M, :, 1:], torch.maximum(new_fe[0], new_fe[1]),
                      out=h)
        torch.ne(cur[_E:_M + 1, :, 1:], h, out=self.flag[2:4])  # h!=e, h!=m
        p = self.ptr[k]
        # state: 0 if h == m, else 1 if h == e, else 2
        torch.mul(self.flag[2], self.flag[3], out=p)
        p.add_(self.flag[3])
        p.add_(self.flag[1], alpha=E_OPEN_BIT)
        p.add_(self.flag[0], alpha=F_OPEN_BIT)
        cur[:, :, 1:].masked_fill_(self.invalid[k], NEG)
        if k == 0:
            cur[_H, :, 1] = 0.0  # the origin cell
        torch.gather(h, 1, self.row_l1, out=self.h_l1[k])

    def steps(self) -> None:
        self.x.fill_(NEG)
        for k in range(self.D):
            self.step(k)

    def capture(self) -> None:
        """Capture `steps` as a CUDA graph (`self.graph`), on a side
        stream that waits for the work queued so far (without
        `torch.cuda.graph`'s synchronize, garbage collection and cache
        release).  The memory the allocator reserves meanwhile is the
        graph's private pool (the step temporaries); it joins `nbytes`."""
        self.graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(self.dev)
        side.wait_stream(torch.cuda.current_stream(self.dev))
        reserved = torch.cuda.memory_reserved(self.dev)
        with torch.cuda.stream(side):
            self.graph.capture_begin()
            self.steps()
            self.graph.capture_end()
        torch.cuda.current_stream(self.dev).wait_stream(side)
        self.pool_bytes = torch.cuda.memory_reserved(self.dev) - reserved
        self.nbytes += self.pool_bytes

    def load(self, p1, p2, l1, l2, gap_open, gap_extend, term_scale,
             core) -> None:
        """Fill the per-diagonal inputs for one batch."""
        B, D, R1 = self.B, self.D, self.R1
        # (B, 20, L2) substitution-transformed profile 2, then (B, L1, L2)
        # column scores, as the reference's two einsums
        p2b = torch.matmul(core, p2.transpose(1, 2))
        s = torch.bmm(p1, p2b)
        # skew: row i shifted right by i + 1, so sd[k, b, i] holds the
        # score of cell (i, k - i) (residues i-1, k-i-1), 0 off the grid
        a = torch.nn.functional.pad(s, (1, R1, 1, 0))  # (B, R1, L2 + 1 + R1)
        skew = a.reshape(B, -1)[:, :R1 * D].reshape(B, R1, D)
        self.sd.copy_(skew.permute(2, 0, 1))

        rows = torch.arange(R1, device=self.dev)
        j = torch.arange(D, device=self.dev)[:, None, None] - rows  # (D,1,R1)
        torch.logical_not((j >= 0) & (j <= l2[None, :, None])
                          & (rows <= l1[None, :, None]), out=self.invalid)
        self.row_l1.copy_(l1[:, None])
        # terminal gaps (E on rows 0 and l1, F on columns 0 and l2) cost
        # the float32 product g * term_scale, as in the reference
        t = torch.arange(self.wf, device=self.dev)
        f_term = (t == D - 1) | (t == D - 1 - l2[:, None])  # (B, wf)
        e_term = (rows == 0) | (rows == l1[:, None])  # (B, R1)
        for g, cost in ((self.go, gap_open), (self.ge, gap_extend)):
            g32 = np.float32(cost)
            term = float(g32 * np.float32(term_scale))
            g.fill_(float(g32))
            g[:, :self.wf].masked_fill_(f_term, term)
            g[:, self.wf:].masked_fill_(e_term, term)

    def score(self, l1, l2) -> torch.Tensor:
        """H at (l1, l2) of the last run."""
        b = torch.arange(self.B, device=self.dev)
        return self.h_l1[l1 + l2, b, 0]


_PLANS: OrderedDict = OrderedDict()

# The plan cache's tally, reset with `reset_graph_counts`: CUDA graphs
# captured, host seconds capturing them, plans evicted.
GRAPHS = {"captured": 0, "capture_seconds": 0.0, "evicted": 0}


def reset_graph_counts() -> None:
    """Zero the tally."""
    GRAPHS.update(captured=0, capture_seconds=0.0, evicted=0)


def _admit(key, plan: _Plan, budget: int) -> None:
    """Cache `plan` under `key`, first dropping the least recently used
    plans while the cache would hold more than `budget` bytes."""
    held = sum(p.nbytes for p in _PLANS.values())
    if _PLANS and held + plan.nbytes > budget:
        if plan.dev.type == "cuda":
            torch.cuda.synchronize(plan.dev)  # queued calls may use them
        while _PLANS and held + plan.nbytes > budget:
            held -= _PLANS.popitem(last=False)[1].nbytes
            GRAPHS["evicted"] += 1
    _PLANS[key] = plan


def release_plans() -> None:
    """Drop every cached plan and give its card memory back to the
    device (`pipeline/stage2.run_stage2` does so once its alignment and
    refinement are done)."""
    devs = {p.dev for p in _PLANS.values() if p.dev.type == "cuda"}
    for dev in devs:
        torch.cuda.synchronize(dev)  # queued calls may use them
    _PLANS.clear()
    if devs:
        torch.cuda.empty_cache()


def _plan(B: int, L1: int, L2: int, dev: torch.device) -> _Plan:
    """The plan of a shape.  On the card plans are cached until
    `release_plans` (least recently used ones dropped past
    PLAN_CACHE_SHARE of the card's memory), and the first call of a
    shape captures its step loop as a CUDA graph that every call
    replays: a capture costs about two eager runs, a replay a small
    share of one (chip_smoke.py's small_align phase times all three).
    On the CPU each call gets a fresh plan and runs eagerly."""
    if dev.type != "cuda":
        return _Plan(B, L1, L2, dev)
    key = (str(dev), B, L1, L2)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _Plan(B, L1, L2, dev)
        t0 = time.time()
        plan.capture()
        GRAPHS["captured"] += 1
        GRAPHS["capture_seconds"] += time.time() - t0
        total = torch.cuda.get_device_properties(dev).total_memory
        _admit(key, plan, int(PLAN_CACHE_SHARE * total))
    _PLANS.move_to_end(key)
    return plan


def nw_profile_dp(p1: torch.Tensor, p2: torch.Tensor, l1: torch.Tensor,
                  l2: torch.Tensor, gap_open: float = 11.0,
                  gap_extend: float = 1.0, term_scale: float = 0.5,
                  core_matrix: torch.Tensor | None = None):
    """`nw_profile_batch` with the pointers diagonal-major: returns
    (score (B,), ptr (L1+L2+1, B, L1+1) uint8).  On the card the
    pointers live in the cached plan of the shape and are overwritten by
    its next call."""
    B, L1 = p1.shape[:2]
    L2 = p2.shape[1]
    dev = p1.device
    core = torch.as_tensor(blosum_core(), device=dev) \
        if core_matrix is None else core_matrix.to(dev, torch.float32)
    l1 = l1.to(dev, torch.int64)
    l2 = l2.to(dev, torch.int64)
    plan = _plan(B, L1, L2, dev)
    plan.load(p1.to(torch.float32), p2.to(torch.float32), l1, l2,
              float(gap_open), float(gap_extend), float(term_scale), core)
    if plan.graph is not None:
        plan.graph.replay()
    else:
        plan.steps()
    return plan.score(l1, l2), plan.ptr


def nw_profile_batch(p1: torch.Tensor, p2: torch.Tensor, l1: torch.Tensor,
                     l2: torch.Tensor, gap_open: float = 11.0,
                     gap_extend: float = 1.0, term_scale: float = 0.5,
                     core_matrix: torch.Tensor | None = None):
    """Global affine alignment of profile pairs, on the tensors' device.

    Args:
      p1: (B, L1, 20) float32 query profiles (frequency columns,
          zero-padded past l1).
      p2: (B, L2, 20) float32.
      l1, l2: (B,) true lengths.
      term_scale: terminal gaps cost `term_scale` * normal (muscle-like
          soft terminal gap handling).

    Returns:
      score: (B,) float32 at cell (l1, l2)
      ptr: (B, L1+L2+1, L1+1) uint8 pointers (diag k, row i)
    """
    score, ptr = nw_profile_dp(p1, p2, l1, l2, gap_open, gap_extend,
                               term_scale, core_matrix)
    return score.clone(), ptr.permute(1, 0, 2).clone()


def traceback(ptr: np.ndarray, l1: int, l2: int) -> list[tuple[int, int]]:
    """Walk packed pointers from (l1, l2) back to (0, 0).  Returns the
    path as a list of moves ('M' pairs both, 'E' consumes profile-2,
    'F' consumes profile-1) encoded as (di, dj) steps, in forward
    order."""
    i, j = l1, l2
    state = int(ptr[i + j, i]) & 3
    moves: list[tuple[int, int]] = []
    while i > 0 or j > 0:
        if i == 0:
            moves.append((0, 1))
            j -= 1
            continue
        if j == 0:
            moves.append((1, 0))
            i -= 1
            continue
        cell = int(ptr[i + j, i])
        if state == PTR_M:
            moves.append((1, 1))
            i -= 1
            j -= 1
            if i > 0 or j > 0:
                state = int(ptr[i + j, i]) & 3
        elif state == PTR_E:
            moves.append((0, 1))
            from_open = bool(cell & E_OPEN_BIT)
            j -= 1
            if from_open:
                state = int(ptr[i + j, i]) & 3
        else:  # PTR_F
            moves.append((1, 0))
            from_open = bool(cell & F_OPEN_BIT)
            i -= 1
            if from_open:
                state = int(ptr[i + j, i]) & 3
    return moves[::-1]


def nw_profile_numpy(p1: np.ndarray, p2: np.ndarray, gap_open=11.0,
                     gap_extend=1.0, term_scale=0.5) -> float:
    """Numpy oracle for the batch kernel's score (same recurrences)."""
    core = blosum_core(np.float64)
    l1, l2 = len(p1), len(p2)
    s = p1 @ core @ p2.T
    H = np.full((l1 + 1, l2 + 1), -1e30)
    E = np.full_like(H, -1e30)
    F = np.full_like(H, -1e30)
    H[0, 0] = 0.0
    for k in range(1, l1 + l2 + 1):
        for i in range(max(0, k - l2), min(k, l1) + 1):
            j = k - i
            e_term = i == 0 or i == l1
            f_term = j == 0 or j == l2
            goe = gap_open * (term_scale if e_term else 1.0)
            gee = gap_extend * (term_scale if e_term else 1.0)
            gof = gap_open * (term_scale if f_term else 1.0)
            gef = gap_extend * (term_scale if f_term else 1.0)
            if j >= 1:
                E[i, j] = max(H[i, j - 1] - goe, E[i, j - 1] - gee)
            if i >= 1:
                F[i, j] = max(H[i - 1, j] - gof, F[i - 1, j] - gef)
            m = H[i - 1, j - 1] + s[i - 1, j - 1] if (i >= 1 and j >= 1) \
                else -1e30
            H[i, j] = max(m, E[i, j], F[i, j])
    return H[l1, l2]
