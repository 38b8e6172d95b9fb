"""Batched profile-profile global alignment (affine Needleman-Wunsch),
the DP engine of the progressive MSA (PyTorch port of
`pepr_tpu/ops/profile_align.py`).

Profiles are (L, 20) residue-frequency columns; a column pair scores
the expected substitution score f1' B f2, one `bmm` per call
(`column_scores`).  The DP emits one traceback pointer per cell, and a
walk of the pointers from (l1, l2) back to (0, 0) gives the merge path
(`traceback`'s rules).  The reference runs the DP as an XLA `lax.scan`
over anti-diagonals, not a Pallas kernel, and walks on the host.  On
the card both are the hand-written kernel `csrc/profile_dp.cu`, one
launch a call (`profile_dp`, counted in `LAUNCHES`), built by
`ops/_cuda.py` and loaded with `ctypes`: it walks the grid cells only
(the pointers off the grid are undefined) and then the path, so the
main path's entry (`nw_profile_path`) hands the host paths, one byte a
move, and never the pointers.  The plain version (which the CPU runs
and `chip_smoke.py` holds the kernel against on the card) is the DP
`profile_dp_plain` and the walk `traceback_paths` (`traceback`, pair by
pair, encoded as the kernel encodes).  The DP follows the scan diagonal
by diagonal: the column scores laid out skewed so that each step reads
one contiguous diagonal, the per-diagonal gap costs and validity masks
precomputed, 9 elementwise ops a step, the steps in chunks of CHUNK
diagonals (`_Plan`).  Kernel and plain version do the same float32
operations, so they agree bit for bit on the score, every grid pointer
and the path.

Pointer byte layout per cell: bits 0-1 = winning state of H
(0=M diag, 1=E gap-in-profile-1, 2=F gap-in-profile-2); bit 2 = E came
from gap-open (else extend); bit 3 = F came from gap-open.  Path byte:
bit 0 (MOVE_I) the move consumes a column of profile 1, bit 1 (MOVE_J)
one of profile 2; a call's paths are (B, L1 + L2) uint8 with pair b's
moves in forward order in its last path_len[b] bytes (`MOVES` decodes
them to (di, dj)).

Left out: the reference's `packed=` pointers and `unpack_ptrs` (a
transfer measure for the TPU's host link).
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from pepr_tpu_torch.data.blosum62 import BLOSUM62
from pepr_tpu_torch.ops import _cuda

NEG = -1e30

PTR_M, PTR_E, PTR_F = 0, 1, 2
E_OPEN_BIT, F_OPEN_BIT = 4, 8
# Path byte: the move consumes profile 1 (MOVE_I), profile 2 (MOVE_J).
MOVE_I, MOVE_J = 1, 2
# (di, dj) of each path byte value (the byte & 3)
MOVES = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], dtype=np.int64)

# Slots of a diagonal's state record: F, E, M (the diagonal move) and H.
_F, _E, _M, _H = 0, 1, 2, 3
# Diagonals a chunk of the plain version's step loop runs.
CHUNK = 48

SOURCE = _cuda.source_path("profile_dp")

# Launch count, bumped where the wrapper launches the kernel.
LAUNCHES = {"profile_dp": 0}
# The plain walk's tally (`traceback_paths`, the CPU's route): calls,
# the pointer bytes it walked on the host and its seconds.  On the card
# nothing reaches it.
PLAIN_WALK = {"calls": 0, "ptr_bytes": 0, "seconds": 0.0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F32 = ctypes.c_float
# Argument lists of the C functions (checked against the source by the
# tests).
ARGTYPES = {
    "profile_dp_launch": [_P, _P, _P, _I, _I, _I, _F32, _F32, _F32, _F32,
                          _P, _P, _P, _P, _P, _L, _P],
    "profile_dp_plan": [_I, _I, _P],
    "profile_dp_scratch_bytes": [_I, _I, _I],
    "profile_dp_num_regs": [_I],
    "profile_dp_stamps": [_P, _I],
    "profile_dp_error_string": [_I],
}
RESTYPES = {"profile_dp_launch": _I, "profile_dp_plan": _I,
            "profile_dp_scratch_bytes": _L, "profile_dp_num_regs": _I,
            "profile_dp_stamps": _I,
            "profile_dp_error_string": ctypes.c_char_p}

_lib = None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        _lib = _cuda.load("profile_dp", ARGTYPES, RESTYPES)
    return _lib


def blosum_core(dtype=np.float32) -> np.ndarray:
    """20x20 substitution core used for profile column scores."""
    return BLOSUM62[:20, :20].astype(dtype)


def column_scores(p1: torch.Tensor, p2: torch.Tensor,
                  core: torch.Tensor) -> torch.Tensor:
    """(B, L1, L2) float32 column scores s[b, i, j] = p1[b, i]' core
    p2[b, j]: the (B, 20, L2) substitution-transformed profile 2, then a
    batched product, as the reference's two einsums.  The kernel and the
    plain version both take these, so their pointer ties see the same
    scores."""
    p2b = torch.matmul(core, p2.transpose(1, 2))
    return torch.bmm(p1, p2b)


def gap_costs(gap_open: float, gap_extend: float,
              term_scale: float) -> tuple[float, float, float, float]:
    """(go, ge, go_t, ge_t): the float32 gap costs and the terminal ones
    (E on rows 0 and l1, F on columns 0 and l2), each the float32
    product g * term_scale, as in the reference."""
    go, ge = np.float32(gap_open), np.float32(gap_extend)
    ts = np.float32(term_scale)
    return float(go), float(ge), float(go * ts), float(ge * ts)


def on_grid(l1, l2, L1: int, L2: int, device=None) -> torch.Tensor:
    """(L1 + L2 + 1, B, L1 + 1) bool on `device` (default the CPU): the
    cells of the diagonal-major pointers that lie on each pair's grid
    (rows 0..l1, columns 0..l2), the ones the kernel writes and the
    traceback reads."""
    l1 = torch.as_tensor(l1, dtype=torch.int64, device=device)
    l2 = torch.as_tensor(l2, dtype=torch.int64, device=device)
    k = torch.arange(L1 + L2 + 1, device=device)[:, None, None]
    i = torch.arange(L1 + 1, device=device)[None, None, :]
    return (i <= l1[None, :, None]) & (k >= i) \
        & (k <= i + l2[None, :, None])


def grid_cells(l1, l2) -> int:
    """Sum over the pairs of (l1 + 1)(l2 + 1): the cells the kernel
    walks."""
    l1 = np.asarray(l1, np.int64)
    l2 = np.asarray(l2, np.int64)
    return int(((l1 + 1) * (l2 + 1)).sum())


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
    """The buffers of one (B, L1) DP shape, and the plain version's step
    loop.

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
    go to the call.  The first chunk also sets the origin cell.
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

    def load(self, s: torch.Tensor, l1, l2,
             costs: tuple[float, float, float, float]) -> _Call:
        """One call's inputs (`_Call`) from its column scores `s` (B, L1,
        L2) and `gap_costs`, and its rows' E gap costs and row l1 in the
        plan."""
        B, R1, dev = self.B, self.R1, self.dev
        L2 = s.shape[2]
        call = _Call(self, R1 + L2)
        Dp = call.Dp
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
        go, ge, go_t, ge_t = costs
        col = Dp - 1 - torch.arange(Dp + R1 - 1, device=dev)
        f_term = (col == 0) | (col == l2[:, None])  # (B, Dp + R1 - 1)
        e_term = (self.rows == 0) | (self.rows == l1[:, None])  # (B, R1)
        for name, g, cost, term in (("f_open", self.go, go, go_t),
                                    ("f_ext", self.ge, ge, ge_t)):
            f = torch.full((B, Dp + R1 - 1), cost, dtype=torch.float32,
                           device=dev)
            setattr(call, name, f.masked_fill_(f_term, term))
            g[:, self.wf:].fill_(cost).masked_fill_(e_term, term)
        return call

    def run(self, call: _Call) -> None:
        """The step loop over `call`'s diagonals, chunk by chunk: stage
        its scores, validity and F costs, run the chunk and copy out its
        pointers and H at row l1."""
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
            self.chunk(k0 == 0)
            call.ptr[k0:k0 + C].copy_(self.ptr)
            call.h_l1[k0:k0 + C].copy_(self.h_l1)

    def score(self, call: _Call, l1, l2) -> torch.Tensor:
        """H at (l1, l2) of `call`."""
        b = torch.arange(self.B, device=self.dev)
        return call.h_l1[l1 + l2, b, 0]


def _scores(p1, p2, core_matrix) -> torch.Tensor:
    """A call's float32 column scores on p1's device (BLOSUM62's core
    unless `core_matrix`)."""
    dev = p1.device
    core = torch.as_tensor(blosum_core(), device=dev) \
        if core_matrix is None else core_matrix.to(dev, torch.float32)
    return column_scores(p1.to(torch.float32), p2.to(dev, torch.float32),
                         core)


def profile_dp_plain(s: torch.Tensor, l1: torch.Tensor, l2: torch.Tensor,
                     go: float, ge: float, go_t: float, ge_t: float):
    """The plain version of `profile_dp`, with its arguments, on s's
    device: the step loop, which writes every cell's pointer, off the
    grid too."""
    l1 = l1.to(s.device, torch.int64)
    l2 = l2.to(s.device, torch.int64)
    plan = _Plan(s.shape[0], s.shape[1], s.device)
    call = plan.load(s, l1, l2, (go, ge, go_t, ge_t))
    plan.run(call)
    return plan.score(call, l1, l2), call.ptr[:call.D]


def nw_profile_dp_plain(p1: torch.Tensor, p2: torch.Tensor,
                        l1: torch.Tensor, l2: torch.Tensor,
                        gap_open: float = 11.0, gap_extend: float = 1.0,
                        term_scale: float = 0.5,
                        core_matrix: torch.Tensor | None = None):
    """The plain version of `nw_profile_dp`, on p1's device."""
    return profile_dp_plain(_scores(p1, p2, core_matrix), l1, l2,
                            *gap_costs(gap_open, gap_extend, term_scale))


def profile_dp(s: torch.Tensor, l1: torch.Tensor, l2: torch.Tensor,
               go: float, ge: float, go_t: float, ge_t: float,
               events: list | None = None):
    """The kernel: s (B, L1, L2) float32 column scores (`column_scores`),
    l1 and l2 (B,) int32 lengths (at most L1 and L2), all contiguous on
    one CUDA device, and `gap_costs`.  Returns (score (B,) float32, ptr
    (L1 + L2 + 1, B, L1 + 1) uint8, path (B, L1 + L2) uint8, path_len
    (B,) int32): the pointers written on each pair's grid only
    (`on_grid`), pair b's moves in path[b, L1 + L2 - path_len[b]:].
    With `events`, appends a (start, end) pair of CUDA events recorded
    around the launch."""
    dev = s.device
    for name, x in (("s", s), ("l1", l1), ("l2", l2)):
        if x.device != dev or x.device.type != "cuda":
            raise ValueError(f"{name} must be on {dev} (a CUDA device), got "
                             f"{x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if s.dtype != torch.float32 or s.dim() != 3:
        raise ValueError("s must be (B, L1, L2) float32")
    B, L1, L2 = s.shape
    if l1.dtype != torch.int32 or l2.dtype != torch.int32 \
            or l1.shape != (B,) or l2.shape != (B,):
        raise ValueError("l1 and l2 must be (B,) int32")
    if B < 1 or L1 < 1 or L2 < 1 or max(B, L1, L2) >= 1 << 31:
        raise ValueError(f"empty or oversized call (B={B}, L1={L1}, "
                         f"L2={L2})")
    lib = library()
    n_scratch = lib.profile_dp_scratch_bytes(B, L1, L2)
    score = torch.empty(B, dtype=torch.float32, device=dev)
    ptr = torch.empty((L1 + L2 + 1, B, L1 + 1), dtype=torch.uint8,
                      device=dev)
    path = torch.empty((B, L1 + L2), dtype=torch.uint8, device=dev)
    path_len = torch.empty(B, dtype=torch.int32, device=dev)
    scratch = torch.empty(n_scratch, dtype=torch.uint8, device=dev)
    LAUNCHES["profile_dp"] += 1
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        if events is not None:
            events.append((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
            events[-1][0].record(stream)
        rc = lib.profile_dp_launch(s.data_ptr(), l1.data_ptr(),
                                   l2.data_ptr(), B, L1, L2, go, ge, go_t,
                                   ge_t, score.data_ptr(), ptr.data_ptr(),
                                   path.data_ptr(), path_len.data_ptr(),
                                   scratch.data_ptr(), n_scratch,
                                   stream.cuda_stream)
        if events is not None:
            events[-1][1].record(stream)
    if rc != 0:
        raise RuntimeError(f"profile_dp launch failed: CUDA error {rc} "
                           f"({lib.profile_dp_error_string(rc).decode()})")
    return score, ptr, path, path_len


def _card_args(p1, p2, l1, l2, gap_open, gap_extend, term_scale,
               core_matrix) -> tuple:
    """`profile_dp`'s arguments for profiles on the card."""
    dev = p1.device
    return (_scores(p1, p2, core_matrix),
            l1.to(dev, torch.int32).contiguous(),
            l2.to(dev, torch.int32).contiguous(),
            *gap_costs(gap_open, gap_extend, term_scale))


def nw_profile_dp(p1: torch.Tensor, p2: torch.Tensor, l1: torch.Tensor,
                  l2: torch.Tensor, gap_open: float = 11.0,
                  gap_extend: float = 1.0, term_scale: float = 0.5,
                  core_matrix: torch.Tensor | None = None):
    """`nw_profile_batch` with the pointers diagonal-major: returns
    (score (B,), ptr (L1+L2+1, B, L1+1) uint8).  On CUDA tensors one
    launch of the kernel (pointers off the grid undefined); on the CPU
    the plain version."""
    if not p1.is_cuda:
        return nw_profile_dp_plain(p1, p2, l1, l2, gap_open, gap_extend,
                                   term_scale, core_matrix)
    return profile_dp(*_card_args(p1, p2, l1, l2, gap_open, gap_extend,
                                  term_scale, core_matrix))[:2]


def nw_profile_path(p1: torch.Tensor, p2: torch.Tensor, l1: torch.Tensor,
                    l2: torch.Tensor, gap_open: float = 11.0,
                    gap_extend: float = 1.0, term_scale: float = 0.5,
                    core_matrix: torch.Tensor | None = None,
                    events: list | None = None):
    """The MSA's entry: (score (B,), path (B, L1 + L2) uint8, path_len
    (B,) int32), pair b's moves in path[b, L1 + L2 - path_len[b]:].  On
    CUDA tensors one launch of the kernel, DP and walk (the pointers
    stay on the card and are freed with the call; `events` as in
    `profile_dp`); on the CPU the plain DP and the plain walk
    (`traceback_paths`)."""
    if not p1.is_cuda:
        score, ptr = nw_profile_dp_plain(p1, p2, l1, l2, gap_open,
                                         gap_extend, term_scale,
                                         core_matrix)
        return (score, *traceback_paths(ptr, l1, l2))
    score, _, path, path_len = profile_dp(
        *_card_args(p1, p2, l1, l2, gap_open, gap_extend, term_scale,
                    core_matrix), events=events)
    return score, path, path_len


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
      ptr: (B, L1+L2+1, L1+1) uint8 pointers (diag k, row i); on the
          card only the cells of each pair's grid (`on_grid`) are
          defined
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


def encode_moves(moves: list[tuple[int, int]]) -> np.ndarray:
    """`traceback`'s (di, dj) moves as path bytes (di | dj << 1)."""
    mv = np.asarray(moves, dtype=np.uint8).reshape(-1, 2)
    return mv[:, 0] | (mv[:, 1] << 1)


def traceback_paths(ptr: torch.Tensor, l1, l2):
    """The plain version of the kernel's walk, on the host: `traceback`
    of each pair of the diagonal-major pointers ptr (L1 + L2 + 1, B, L1
    + 1), encoded.  Returns (path (B, L1 + L2) uint8, zero before each
    pair's moves, path_len (B,) int32).  Refuses CUDA tensors: on the
    card the kernel walks."""
    if ptr.is_cuda:
        raise ValueError("traceback_paths walks host pointers; on the card "
                         "the kernel walks")
    t0 = time.time()
    D, B, R1 = ptr.shape
    Lp = D - 1
    host = ptr.numpy()
    l1 = np.asarray(l1, np.int64)
    l2 = np.asarray(l2, np.int64)
    path = np.zeros((B, Lp), np.uint8)
    path_len = np.zeros(B, np.int32)
    for b in range(B):
        code = encode_moves(traceback(host[:, b], int(l1[b]), int(l2[b])))
        path_len[b] = len(code)
        path[b, Lp - len(code):] = code
    PLAIN_WALK["calls"] += 1
    PLAIN_WALK["ptr_bytes"] += ptr.numel()
    PLAIN_WALK["seconds"] += time.time() - t0
    return torch.from_numpy(path), torch.from_numpy(path_len)


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
