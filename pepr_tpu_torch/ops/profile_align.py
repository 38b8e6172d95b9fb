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
precomputed, leaving 9 elementwise ops a step.  The steps run in
chunks of CHUNK diagonals; on the card a chunk of each (B, L1) shape is
captured once as a CUDA graph and replayed for every chunk of every
call of that shape (`_Plan`).

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
# Diagonals a chunk of the step loop runs: on the card each chunk is one
# replay of a CUDA graph that every call of a (B, L1) plan shares,
# whatever its L2.
CHUNK = 48


def blosum_core(dtype=np.float32) -> np.ndarray:
    """20x20 substitution core used for profile column scores."""
    return BLOSUM62[:20, :20].astype(dtype)


class _Call:
    """One call's inputs and outputs, diagonal-major over `Dp` (its D
    diagonals rounded up to whole chunks; the extra diagonals lie off
    the grid): the skewed column scores `skew` (B, R1, Dp) (`skew[b, i,
    k]` scores cell (i, k - i)), the terminal-aware F gap costs by
    column `f_open`/`f_ext` (B, Dp + R1 - 1) (position q is column Dp -
    1 - q), each row's first and last valid diagonal, and the pointers
    `ptr` (Dp, B, R1) and H at row l1 `h_l1` (Dp, B, 1) it fills."""

    def __init__(self, plan: "_Plan", D: int):
        self.D = D
        self.Dp = -(-D // CHUNK) * CHUNK
        B, R1, dev = plan.B, plan.R1, plan.dev
        self.ptr = torch.empty((self.Dp, B, R1), dtype=torch.uint8,
                               device=dev)
        self.h_l1 = torch.empty((self.Dp, B, 1), dtype=torch.float32,
                                device=dev)


class _Plan:
    """The buffers of one (B, L1) DP shape, and its step loop.

    The loop runs in chunks of CHUNK diagonals k0..k0 + CHUNK - 1, step
    j on diagonal k0 + j.  Step j keeps its F, E, M and H values in
    `x[j + 2]`, (4, B, L1 + 2); `x[0]` and `x[1]` hold the two diagonals
    before the chunk (NEG at the start of a run: diagonals -2 and -1).
    Column 0 holds NEG, so the row-shifted operand of a step (cell
    (i - 1, .)) is a view one column to the left of the unshifted one.
    `sd[j]` holds step j's column scores and `invalid[j]` its cells
    outside (l1, l2), staged from the call before the chunk, and the gap
    costs of [F, E] are a sliding window over `go`/`ge` (F's terminal
    columns move along the diagonal, E's rows do not).  A step is 9
    elementwise ops on these views and keeps its 4 comparison flags;
    after the chunk its pointers (packed from the flags) and H at row l1
    go to the call.  The first chunk also sets the origin cell, so it
    has a step loop (and a graph) of its own.
    """

    def __init__(self, B: int, L1: int, dev: torch.device):
        self.B, self.dev = B, dev
        C, R1 = CHUNK, L1 + 1
        self.R1 = R1
        # gap-cost rows: F's costs along a chunk's diagonals, reversed
        # (position CHUNK - 1 - j + i for cell i of step j), then E's
        # costs by row
        self.wf = R1 + C - 1
        f32 = dict(dtype=torch.float32, device=dev)
        self.sd = torch.zeros((C, B, R1), **f32)
        self.go = torch.empty((B, self.wf + R1), **f32)
        self.ge = torch.empty((B, self.wf + R1), **f32)
        self.invalid = torch.empty((C, B, R1), dtype=torch.bool, device=dev)
        self.row_l1 = torch.zeros((B, 1), dtype=torch.int64, device=dev)
        self.x = torch.full((C + 2, 4, B, R1 + 1), NEG, **f32)
        self.flag = torch.empty((C, 4, B, R1), dtype=torch.uint8,
                                device=dev)
        self.ptr = torch.empty((C, B, R1), dtype=torch.uint8, device=dev)
        self.h_l1 = torch.empty((C, B, 1), **f32)
        self.rows = torch.arange(R1, device=dev)
        self.diag = torch.arange(C, device=dev)[:, None, None]
        self.graphs = None  # (first chunk's, later chunks') CUDA graphs
        self.pool_bytes = 0
        # card memory the plan holds: its buffers, and (once captured)
        # the private pools of its graphs
        self.nbytes = sum(t.numel() * t.element_size() for t in (
            self.sd, self.go, self.ge, self.invalid, self.x, self.flag,
            self.ptr, self.h_l1))

    def _pair(self, r: int, slot: int, shifts: tuple[int, int],
              gap: int) -> torch.Tensor:
        """(2, B, R1) view of `x[r]`'s slots `slot` and `slot + gap`
        (gap 0: the same slot twice), shifted left by shifts[0] and
        shifts[1] columns."""
        x = self.x
        rec = x.stride(1)
        base = x.storage_offset() + r * x.stride(0) + slot * rec
        s0 = 1 - shifts[0]
        s1 = gap * rec + 1 - shifts[1]
        return x.as_strided((2, self.B, self.R1),
                            (s1 - s0, x.stride(2), 1), base + s0)

    def _costs(self, g: torch.Tensor, j: int) -> torch.Tensor:
        """(2, B, R1) gap costs [F, E] of step j's cells."""
        c0 = CHUNK - 1 - j
        return g.as_strided((2, self.B, self.R1),
                            (self.wf - c0, g.stride(0), 1),
                            g.storage_offset() + c0)

    def step(self, j: int, first: bool) -> None:
        """Step j of a chunk: its diagonal from the two before it (the
        JAX step's recurrences, tie order and masking); in the first
        chunk, diagonal j."""
        cur = self.x[j + 2]
        hh = self._pair(j + 1, _H, (1, 0), 0)  # [H(i-1, j), H(i, j-1)]
        ef = self._pair(j + 1, _F, (1, 0), 1)  # [F(i-1, j), E(i, j-1)]
        opened = hh - self._costs(self.go, j)
        extended = ef - self._costs(self.ge, j)
        new_fe = cur[_F:_E + 1, :, 1:]
        torch.maximum(opened, extended, out=new_fe)
        torch.ge(opened, extended, out=self.flag[j, 0:2])  # F, E open
        h2s = self.x[j][_H, :, :-1]  # H(i-1, j-1)
        torch.add(h2s, self.sd[j], out=cur[_M, :, 1:])
        h = cur[_H, :, 1:]
        torch.maximum(cur[_M, :, 1:], torch.maximum(new_fe[0], new_fe[1]),
                      out=h)
        torch.ne(cur[_E:_M + 1, :, 1:], h, out=self.flag[j, 2:4])  # h!=e, m
        cur[:, :, 1:].masked_fill_(self.invalid[j], NEG)
        if first and j == 0:
            cur[_H, :, 1] = 0.0  # the origin cell

    def chunk(self, first: bool) -> None:
        """CHUNK steps, then their pointers and H at row l1; the last two
        diagonals move to the ring's head for the next chunk."""
        for j in range(CHUNK):
            self.step(j, first)
        f, p = self.flag, self.ptr
        # state: 0 if h == m, else 1 if h == e, else 2
        torch.mul(f[:, 2], f[:, 3], out=p)
        p.add_(f[:, 3])
        p.add_(f[:, 1], alpha=E_OPEN_BIT)
        p.add_(f[:, 0], alpha=F_OPEN_BIT)
        torch.gather(self.x[2:, _H, :, 1:], 2,
                     self.row_l1.expand(CHUNK, self.B, 1), out=self.h_l1)
        self.x[:2].copy_(self.x[CHUNK:])

    def capture(self) -> None:
        """Capture `chunk` (the first one and a later one) as CUDA graphs
        (`self.graphs`), on a side stream that waits for the work queued
        so far (without `torch.cuda.graph`'s synchronize, garbage
        collection and cache release).  The memory the allocator
        reserves meanwhile is the graphs' private pools (the step
        temporaries); it joins `nbytes`."""
        side = torch.cuda.Stream(self.dev)
        side.wait_stream(torch.cuda.current_stream(self.dev))
        reserved = torch.cuda.memory_reserved(self.dev)
        graphs = []
        with torch.cuda.stream(side):
            for first in (True, False):
                graphs.append(torch.cuda.CUDAGraph())
                graphs[-1].capture_begin()
                self.chunk(first)
                graphs[-1].capture_end()
        torch.cuda.current_stream(self.dev).wait_stream(side)
        self.graphs = tuple(graphs)
        self.pool_bytes = torch.cuda.memory_reserved(self.dev) - reserved
        self.nbytes += self.pool_bytes

    def load(self, p1, p2, l1, l2, gap_open, gap_extend, term_scale,
             core) -> _Call:
        """One call's inputs (`_Call`), and its rows' E gap costs and
        row l1 in the plan."""
        B, R1, dev = self.B, self.R1, self.dev
        L2 = p2.shape[1]
        call = _Call(self, R1 + L2)
        Dp = call.Dp
        # (B, 20, L2) substitution-transformed profile 2, then (B, L1, L2)
        # column scores, as the reference's two einsums
        p2b = torch.matmul(core, p2.transpose(1, 2))
        s = torch.bmm(p1, p2b)
        # skew: row i shifted right by i + 1, so skew[b, i, k] holds the
        # score of cell (i, k - i) (residues i-1, k-i-1), 0 off the grid
        a = torch.nn.functional.pad(s, (1, R1 + Dp - call.D, 1, 0))
        call.skew = a.reshape(B, -1)[:, :R1 * Dp].reshape(B, R1, Dp)
        # a row's cells are on the grid from diagonal i (column 0) to
        # i + l2; rows past l1 on none
        call.first = torch.where(self.rows <= l1[:, None], self.rows,
                                 Dp)
        call.last = self.rows + l2[:, None]
        self.row_l1.copy_(l1[:, None])
        # terminal gaps (E on rows 0 and l1, F on columns 0 and l2) cost
        # the float32 product g * term_scale, as in the reference
        col = Dp - 1 - torch.arange(Dp + R1 - 1, device=dev)
        f_term = (col == 0) | (col == l2[:, None])  # (B, Dp + R1 - 1)
        e_term = (self.rows == 0) | (self.rows == l1[:, None])  # (B, R1)
        for name, g, cost in (("f_open", self.go, gap_open),
                              ("f_ext", self.ge, gap_extend)):
            g32 = np.float32(cost)
            term = float(g32 * np.float32(term_scale))
            f = torch.full((B, Dp + R1 - 1), float(g32), dtype=torch.float32,
                           device=dev)
            setattr(call, name, f.masked_fill_(f_term, term))
            g[:, self.wf:].fill_(float(g32)).masked_fill_(e_term, term)
        return call

    def run(self, call: _Call, eager: bool = False) -> None:
        """The step loop over `call`'s diagonals, chunk by chunk: stage
        its scores, validity and F costs, run the chunk (a graph replay
        once captured, unless `eager`) and copy out its pointers and H
        at row l1."""
        self.x.fill_(NEG)
        C = CHUNK
        for k0 in range(0, call.Dp, C):
            self.sd.copy_(call.skew[:, :, k0:k0 + C].permute(2, 0, 1))
            k = self.diag + k0
            torch.lt(k, call.first, out=self.invalid)
            self.invalid.logical_or_(k > call.last)
            q0 = call.Dp - k0 - C
            self.go[:, :self.wf].copy_(call.f_open[:, q0:q0 + self.wf])
            self.ge[:, :self.wf].copy_(call.f_ext[:, q0:q0 + self.wf])
            if self.graphs is not None and not eager:
                self.graphs[k0 > 0].replay()
            else:
                self.chunk(k0 == 0)
            call.ptr[k0:k0 + C].copy_(self.ptr)
            call.h_l1[k0:k0 + C].copy_(self.h_l1)

    def score(self, call: _Call, l1, l2) -> torch.Tensor:
        """H at (l1, l2) of `call`."""
        b = torch.arange(self.B, device=self.dev)
        return call.h_l1[l1 + l2, b, 0]


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


def _plan(B: int, L1: int, dev: torch.device) -> _Plan:
    """The plan of a (B, L1) shape.  On the card plans are cached until
    `release_plans` (least recently used ones dropped past
    PLAN_CACHE_SHARE of the card's memory), and the first call of a
    shape captures its chunk loops as CUDA graphs that every call
    replays, once a chunk: a capture costs about two eager chunks, a
    replay a small share of one (chip_smoke.py's small_align phase times
    all three).  On the CPU each call gets a fresh plan and runs
    eagerly."""
    if dev.type != "cuda":
        return _Plan(B, L1, dev)
    key = (str(dev), B, L1)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _Plan(B, L1, dev)
        t0 = time.time()
        plan.capture()
        GRAPHS["captured"] += len(plan.graphs)
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
    (score (B,), ptr (L1+L2+1, B, L1+1) uint8)."""
    B, L1 = p1.shape[:2]
    dev = p1.device
    core = torch.as_tensor(blosum_core(), device=dev) \
        if core_matrix is None else core_matrix.to(dev, torch.float32)
    l1 = l1.to(dev, torch.int64)
    l2 = l2.to(dev, torch.int64)
    plan = _plan(B, L1, dev)
    call = plan.load(p1.to(torch.float32), p2.to(torch.float32), l1, l2,
                     float(gap_open), float(gap_extend), float(term_scale),
                     core)
    plan.run(call)
    return plan.score(call, l1, l2), call.ptr[:call.D]


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
