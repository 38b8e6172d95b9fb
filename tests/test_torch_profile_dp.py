"""The profile DP's kernel (csrc/profile_dp.cu) and its wrapper, on the
CPU, and its tally in the progressive MSA.

The kernel's DP is emulated in numpy, step by step in the kernel's
order, in float32: a block of W warps a pair, the pair's rows cut into
strips of WARP * R rows (spread over the warps when they fit, else the
fewest strips), each walked by a warp as an anti-diagonal wavefront
(row t of a strip t steps behind row 0), a lane's rows bottom to top,
the bottom row's H and F handed to the next lane after each step, and
the boundary that lane WARP-1 of a strip writes and lane 0 of the next
strip reads a step ahead (row -1 above the first strip): when every
strip is in flight, a ring of RING_SLOTS slots of RING_COLS columns
whose full and empty barriers keep the kernel's mbarrier phase
semantics, else a buffer of a whole row with a published count.  The
warps run as generators under a seeded random schedule, so a strip
meets the others only through the boundaries, a wait that never ends
fails, and every value read from a boundary is checked to be the column
it should be.  At staged buckets a warp's column scores come from its
window in shared memory, filled by the kernel's copies (each landing as
early or as late as cp.async allows), every read checked to hold its
score, and the reads and copies checked to fall on 32 banks.  Only the
grid cells are walked, and each pointer byte is written where the
kernel writes it in the diagonal-major layout.  The emulation is held
bit for bit against the port's plain version (`nw_profile_dp_plain`,
itself held against the JAX package in tests/test_torch_msa.py): the
score and every grid pointer equal, every grid cell written once and
nothing off the grid.

The kernel's walk phase is emulated too: the window of WIN_DIAGS
diagonals by WIN_ROWS rows loaded from the pointers as the block loads
it, one thread walking it until it would leave it, every read inside
the window and on the grid; its path bytes equal `traceback`'s moves,
encoded, and `traceback_paths` (the plain walk).

Cases: dyadic profiles (values k/4, exact in float32) with planted
ties, L1 < L2 and L1 > L2, lengths well below their buckets, profiles
spanning several strips in both boundary modes (at the kernel's warp
and at a warp of 4 lanes of 2 rows), the BLOSUM and the nucleotide
cores, terminal-gap rows and columns, and empty profiles.  This
emulation is test code, its layout read from the kernel's source.
Tests marked `cuda` hold the kernel against the plain version on a
card."""

import ctypes
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from test_torch_pruning_wrapper import C_TYPES, _c_signatures

from pepr_tpu_torch.data.nt_scores import NT_GAP_EXTEND, NT_GAP_OPEN, nt_core
from pepr_tpu_torch.models import msa
from pepr_tpu_torch.ops import _cuda
from pepr_tpu_torch.ops import profile_align as pa

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEG = np.float32(-1e30)
UNWRITTEN = 0xFF  # no pointer byte has its high bits set
SOURCE = open(pa.SOURCE).read()
# the kernel's constants, from its source
(WARP, MAX_ROWS, MAX_WARPS, SHARED_WARPS, SHARED_ROWS, STAGE_ROWS, RING_COLS,
 RING_SLOTS, STAGE_COLS, EPOCH, WIN_ROWS, WIN_DIAGS, PUBLISH) = (
    int(re.search(rf"#define {m} (\d+)", SOURCE).group(1))
    for m in ("WARP", "MAX_ROWS", "MAX_WARPS", "SHARED_WARPS", "SHARED_ROWS",
              "STAGE_ROWS", "RING_COLS", "RING_SLOTS", "STAGE_COLS", "EPOCH",
              "WIN_ROWS", "WIN_DIAGS", "PUBLISH"))


def cdiv(a, b):
    return -(-a // b)


class Kernel:
    """The kernel's launch rules at a warp of `warp` lanes: a bucket L1
    takes the shared kernel when its longest pair has at most
    `shared_rows` rows (the source's SHARED_ROWS at 32 lanes, else all
    that fit) and fits spread on `shared_warps` warps at most max_rows a
    lane; else the global one, on at most max_warps warps.  The shared
    kernel's warps are the most its launch may choose (the card's
    occupancy may choose fewer: a launch of many pairs, as
    `shared_warps` set lower)."""

    def __init__(self, warp=WARP, max_rows=MAX_ROWS, max_warps=MAX_WARPS,
                 shared_warps=SHARED_WARPS, shared_rows=None):
        self.warp, self.max_rows, self.max_warps = warp, max_rows, max_warps
        self.shared_warps = shared_warps
        self.shared_rows = (SHARED_ROWS if warp == WARP else
                            warp * shared_warps * max_rows) \
            if shared_rows is None else shared_rows

    def shared(self, L1):
        return L1 + 1 <= min(self.shared_rows,
                             self.warp * self.shared_warps * self.max_rows)

    def warps(self, L1):
        if self.shared(L1):
            return min(cdiv(L1 + 1, self.warp), self.shared_warps)
        return min(cdiv(L1 + 1, self.warp * self.max_rows), self.max_warps)

    def layout(self, l1, L1):
        """(strips, rows a lane) of a pair of l1 + 1 rows in the bucket
        L1: spread over the block's warps in the shared kernel, the
        fewest strips in the global one."""
        rows = l1 + 1
        n = cdiv(rows, self.warp * self.max_rows)
        R = cdiv(rows, self.warp * n)
        if self.shared(L1):
            R = cdiv(rows, self.warp * self.warps(L1))
            n = cdiv(rows, self.warp * R)
        return n, R

    def stage_rows(self, L1):
        if not self.shared(L1) or self.warp != WARP:
            return 0
        R = self.layout(L1, L1)[1]
        return R if R <= STAGE_ROWS else 0


KERNEL = Kernel()


class Barrier:
    """An mbarrier of arrival count 1: its completed phases."""

    def __init__(self):
        self.phases = 0

    def done(self, parity):  # try_wait.parity
        return (self.phases & 1) != parity


class Ring:
    """A boundary in shared memory: slots of (H, F) columns, the column
    each holds, full and empty barriers per slot."""

    def __init__(self):
        self.buf = np.full((RING_SLOTS * RING_COLS, 2), np.nan, np.float32)
        self.col = np.full(RING_SLOTS * RING_COLS, -1)
        self.full = [Barrier() for _ in range(RING_SLOTS)]
        self.empty = [Barrier() for _ in range(RING_SLOTS)]


class Glob:
    """A boundary in global memory: a whole row, the strip that wrote
    each column, its published count."""

    def __init__(self, cols):
        self.buf = np.full((cols, 2), np.nan, np.float32)
        self.strip = np.full(cols, -1)
        self.done = 0


class Window:
    """A warp's staged scores: 32 R rows of STAGE_COLS (+1 for even R),
    physical row r * 32 + lane for row lane * R + r, and the copies in
    flight by commit group; `land` "issue" lets a copy land when it is
    issued, "wait" only at the wait that covers it."""

    def __init__(self, R, warp, land):
        self.R, self.warp, self.land = R, warp, land
        self.RS = STAGE_COLS + (0 if R % 2 else 1)
        self.val = np.full((warp * R, self.RS), np.nan, np.float32)
        self.tag = np.full((warp * R, self.RS), -1)
        self.groups, self.open = [], []

    def fill(self, s, i_base, l1, l2, ep, k):
        """stage_fill: lane L copies, for each r, score column 8 ep - t -
        1 + L % 8 of row t = (k + 8 (L // 8)) R + r."""
        lanes = np.arange(self.warp)
        lr = k + EPOCH * (lanes // EPOCH)
        jj = lanes % EPOCH
        L2 = s.shape[1]
        for r in range(self.R):
            t = lr * self.R + r
            i = i_base + t
            cs = EPOCH * ep - t - 1 + jj
            phys = r * WARP + lr
            col = cs % STAGE_COLS
            banks = (phys * self.RS + col) % 32
            assert len(set(banks.tolist())) == self.warp, banks
            ok = (i >= 1) & (i <= l1) & (cs >= 0) & (cs < l2)
            copies = [(int(phys[x]), int(col[x]), s[i[x] - 1, cs[x]],
                       (i[x] - 1) * L2 + cs[x]) for x in np.nonzero(ok)[0]]
            if self.land == "issue":
                self._land(copies)
            else:
                self.open.extend(copies)

    def _land(self, copies):
        for p, c, v, tag in copies:
            self.val[p, c] = v
            self.tag[p, c] = tag

    def commit(self):
        self.groups.append(self.open)
        self.open = []

    def wait_one(self):  # cp.async.wait_group 1
        for g in self.groups[:-1]:
            self._land(g)
        self.groups = self.groups[-1:]

    def read(self, r, lanes_ok, i, c, L2):
        """Row r's scores of the lanes in lanes_ok at columns c (rows
        i), each checked to be the score the kernel needs."""
        lanes = np.arange(self.warp)
        phys = r * WARP + lanes
        col = (c - 1) % STAGE_COLS
        banks = (phys * self.RS + col) % 32
        assert len(set(banks.tolist())) == self.warp, banks
        out = np.zeros(self.warp, np.float32)
        at = np.nonzero(lanes_ok)[0]
        np.testing.assert_array_equal(self.tag[phys[at], col[at]],
                                      (i[at] - 1) * L2 + c[at] - 1)
        out[at] = self.val[phys[at], col[at]]
        return out


def emulate(s, l1, l2, costs, kernel=KERNEL, seed=0, land="wait"):
    """One pair as profile_dp_kernel walks it under the launch rules of
    `kernel`, the block's warps advanced under a random schedule
    (seeded): s (L1, L2) float32 column scores; returns (score, the
    pair's pointers (D, L1 + 1) uint8, UNWRITTEN where the kernel writes
    nothing, the number of grid cells off the NEG border whose pointer a
    tie decided, and the layout (n, R, ring))."""
    L1, L2 = s.shape
    go, ge, go_t, ge_t = (np.float32(x) for x in costs)
    ptr = np.full((L1 + L2 + 1, L1 + 1), UNWRITTEN, np.uint8)
    out = {"score": None, "ties": 0}
    warp, warps = kernel.warp, kernel.warps(L1)
    n, R = kernel.layout(l1, L1)
    ring = kernel.shared(L1)
    assert not ring or n <= warps
    stage_rows = kernel.stage_rows(L1)
    staged = stage_rows > 0
    if staged:
        assert R <= stage_rows and warp == WARP
    cols = l2 + 1
    lanes = np.arange(warp)
    bounds = [Ring() if ring else Glob(cols) for _ in range(n - 1)]

    def take(st, x):
        """Lane 0 of strip st: column x of the boundary above."""
        b = bounds[st - 1]
        if ring:
            q, use = (x // RING_COLS) % RING_SLOTS, x // (RING_COLS
                                                          * RING_SLOTS)
            if x % RING_COLS == 0:
                while not b.full[q].done(use & 1):
                    yield "blocked"
            at = x % (RING_SLOTS * RING_COLS)
            assert b.col[at] == x, (st, x, b.col[at])
            v = b.buf[at].copy()
            if x % RING_COLS == RING_COLS - 1 or x == cols - 1:
                b.empty[q].phases += 1
            return v
        while b.done < x + 1:
            yield "blocked"
        assert b.strip[x] == st - 1, (st, x)
        return b.buf[x].copy()

    def hand_on(st, c, h, f):
        """Lane WARP-1 of strip st: its bottom row's column c."""
        b = bounds[st]
        if ring:
            q, use = (c // RING_COLS) % RING_SLOTS, c // (RING_COLS
                                                          * RING_SLOTS)
            if c % RING_COLS == 0 and use > 0:
                while not b.empty[q].done((use - 1) & 1):
                    yield "blocked"
            at = c % (RING_SLOTS * RING_COLS)
            b.buf[at] = h, f
            b.col[at] = c
            if c % RING_COLS == RING_COLS - 1 or c == cols - 1:
                b.full[q].phases += 1
            return
        b.buf[c] = h, f
        b.strip[c] = st
        if c % PUBLISH == PUBLISH - 1 or c == cols - 1:
            b.done = c + 1

    def strip(st):
        i_base = st * warp * R
        i0 = i_base + lanes * R
        rmax = l1 - i0
        n_steps = min(warp * R, l1 + 1 - i_base) - 1 + cols
        feeds = st + 1 < n
        e_term = ((i0[:, None] + np.arange(R)) == 0) \
            | ((i0[:, None] + np.arange(R)) == l1)
        goe = np.where(e_term, go_t, go)
        gee = np.where(e_term, ge_t, ge)
        h, e, f, hd = (np.full((warp, R), NEG, np.float32) for _ in range(4))
        hu = np.full(warp, NEG, np.float32)
        fu = np.full(warp, NEG, np.float32)
        win = Window(R, warp, land) if staged else None
        if staged:
            for ep in (0, 1):
                for k in range(EPOCH):
                    win.fill(s, i_base, l1, l2, ep, k)
                win.commit()
        nxt = np.array([NEG, NEG], np.float32)
        if st > 0:
            nxt = yield from take(st, 0)
        for tau in range(n_steps):
            c0 = tau - lanes * R
            hu[0], fu[0] = nxt
            if st > 0 and tau + 1 < cols:  # a column a step ahead
                nxt = yield from take(st, tau + 1)
            if staged:
                k = tau % EPOCH
                if k == 0:
                    win.wait_one()
                win.fill(s, i_base, l1, l2, tau // EPOCH + 2, k)
                if k == EPOCH - 1:
                    win.commit()
            for r in reversed(range(R)):  # bottom to top
                c = c0 - r
                i = i0 + r
                ok = (r <= rmax) & (c >= 0) & (c < cols)
                scored = (r <= rmax) & (c >= 1) & (c <= l2) & (i > 0)
                if staged:
                    sv = win.read(r, scored, i, c, L2)
                else:
                    sv = np.where(scored, s[np.clip(i - 1, 0, L1 - 1),
                                            np.clip(c - 1, 0, L2 - 1)],
                                  np.float32(0))
                ah = (h[:, r - 1] if r else hu).copy()
                af = (f[:, r - 1] if r else fu).copy()
                f_term = (c == 0) | (c == l2)
                eo = h[:, r] - goe[:, r]
                ee = e[:, r] - gee[:, r]
                ev = np.maximum(eo, ee)
                fo = ah - np.where(f_term, go_t, go)
                fe = af - np.where(f_term, ge_t, ge)
                fv = np.maximum(fo, fe)
                m = hd[:, r] + sv
                hv = np.maximum(m, np.maximum(fv, ev))
                state = np.where(hv == m, 0, np.where(hv == ev, 1, 2))
                byte = state + 4 * (eo >= ee) + 8 * (fo >= fe)
                at = np.nonzero(ok)[0]
                k, row = i[at] + c[at], i[at]
                assert (ptr[k, row] == UNWRITTEN).all(), (k, row)
                ptr[k, row] = byte[at]
                # cells whose pointer an equality of two terms decided
                tie = ((hv == m) & ((hv == ev) | (hv == fv))) \
                    | ((hv == ev) & (hv == fv)) | (eo == ee) | (fo == fe)
                out["ties"] += int((ok & tie & (hv > NEG)).sum())
                for a, v in ((h, hv), (e, ev), (f, fv), (hd, ah)):
                    a[ok, r] = v[ok]
            if st == 0 and tau == 0:
                h[0, 0] = 0.0  # the origin, after its pointer
            at = (rmax >= 0) & (rmax < R) & (c0 - rmax == l2)
            if at.any():
                assert out["score"] is None
                lane = int(np.nonzero(at)[0][0])
                out["score"] = h[lane, rmax[lane]]
            c = c0[-1] - (R - 1)
            if feeds and 0 <= c < cols:  # lane WARP-1's bottom row
                yield from hand_on(st, c, h[-1, R - 1], f[-1, R - 1])
            # __shfl_up_sync: lane l takes lane l-1's bottom row, lane 0
            # its own
            hu = np.concatenate([h[:1, R - 1], h[:-1, R - 1]])
            fu = np.concatenate([f[:1, R - 1], f[:-1, R - 1]])
            yield "step"

    def warp_walk(w):
        for st in range(w, n, warps):
            yield from strip(st)

    rng = np.random.default_rng(seed)
    gens = {w: warp_walk(w) for w in range(warps)}
    while gens:
        moved = False
        for w in list(gens):
            for _ in range(int(rng.integers(1, 4))):
                try:
                    moved |= next(gens[w]) == "step"
                except StopIteration:
                    del gens[w]
                    moved = True
                    break
        assert moved, "the warps wait on each other"
    return out["score"], ptr, out["ties"], (n, R, ring)


def emulate_trace(ptr, l1, l2, Lp):
    """The kernel's walk phase on one pair's pointers (D, L1 + 1): the
    window loaded and tabulated as the block does it, thread 0's moves
    until the next would leave it, every pointer it depends on on the
    grid; returns (path (Lp,) uint8, UNWRITTEN before the moves, its
    length, windows loaded)."""
    path = np.full(Lp, UNWRITTEN, np.uint8)
    n = windows = 0
    i, j, state = l1, l2, None
    x = np.arange(WIN_DIAGS * WIN_ROWS)
    d, r = x // WIN_ROWS, x % WIN_ROWS
    while True:
        k0 = i + j
        windows += 1
        kk = k0 - d
        ii = i - (WIN_ROWS - 1) + r
        load = (ii >= 0) & (ii <= kk)
        win = np.zeros(WIN_DIAGS * WIN_ROWS, np.int64)
        win[load] = ptr[kk[load], ii[load]]
        # the state after a move out of each cell, by the state it is in
        ok = (d + 2 < WIN_DIAGS) & (r > 0)
        at = x[ok]
        c = win[at]
        table = np.zeros(WIN_DIAGS * WIN_ROWS, np.int64)
        table[at] = (win[at + 2 * WIN_ROWS - 1] & 3) \
            | np.where(c & pa.E_OPEN_BIT, win[at + WIN_ROWS] & 3,
                       pa.PTR_E) << 2 \
            | np.where(c & pa.F_OPEN_BIT, win[at + WIN_ROWS - 1] & 3,
                       pa.PTR_F) << 4
        a, b, cell = i, j, WIN_ROWS - 1

        def on_grid(a, b):
            assert a >= 0 and b >= 0 and ptr[a + b, a] != UNWRITTEN, (a, b)

        if state is None:
            on_grid(a, b)
            state = int(win[cell]) & 3
        while a > 0 and b > 0 and a - 1 >= i - (WIN_ROWS - 1) \
                and k0 - (a + b - 2) < WIN_DIAGS:
            on_grid(a, b)
            opened = int(win[cell]) & (pa.E_OPEN_BIT if state == pa.PTR_E
                                       else pa.F_OPEN_BIT)
            t = int(table[cell])
            if state == pa.PTR_M:
                move, step = pa.MOVE_I | pa.MOVE_J, 2 * WIN_ROWS - 1
            elif state == pa.PTR_E:
                move, step = pa.MOVE_J, WIN_ROWS
            else:
                move, step = pa.MOVE_I, WIN_ROWS - 1
            a -= move & pa.MOVE_I
            b -= move >> 1
            if state == pa.PTR_M or opened:  # the successor's state read
                on_grid(a, b)
            state = (t >> 2 * state) & 3
            cell += step
            path[Lp - 1 - n] = move
            n += 1
        if a == 0 or b == 0:  # along row 0 or column 0
            for move, m in ((pa.MOVE_J, b), (pa.MOVE_I, a)):
                path[Lp - n - m:Lp - n] = move
                n += m
            a = b = 0
        i, j = a, b
        if i == 0 and j == 0:
            return path, n, windows


def dyadic(rng, B, L, lens, n_codes=20):
    """(B, L, 20) profiles of four draws a column (k/4), a draw past
    `n_codes` adding no mass (a gap); zero past `lens`."""
    p = np.zeros((B, L, 20), np.float32)
    for b, n in enumerate(lens):
        draws = rng.integers(0, n_codes + 4, size=(n, 4))
        for c in range(4):
            hit = draws[:, c] < n_codes
            np.add.at(p[b], (np.nonzero(hit)[0], draws[hit, c]), 0.25)
    return p


def _check(p1, p2, l1, l2, core=None, gaps=(11.0, 1.0), kernel=KERNEL,
           staged=None, seed=0, land="wait"):
    """The emulation == the plain version on every pair: the score's
    bits and every grid pointer; nothing written off the grid; and the
    emulated walk == `traceback` and the plain walk.  The launch is
    `kernel`'s for the bucket p1.shape[1] (`staged`, when given, the
    expected staging).  Returns the plain version's (score, ptr (D, B,
    R1)), the emulation's tie count and the pairs' layouts (n, R,
    ring)."""
    args = [torch.as_tensor(x) for x in (p1, p2, l1, l2)]
    cm = None if core is None else torch.as_tensor(core)
    score, ptr = pa.nw_profile_dp_plain(*args, gaps[0], gaps[1],
                                        core_matrix=cm)
    s = pa.column_scores(args[0], args[1], torch.as_tensor(
        pa.blosum_core() if core is None else core)).numpy()
    costs = pa.gap_costs(gaps[0], gaps[1], 0.5)
    L1, L2 = p1.shape[1], p2.shape[1]
    grid = pa.on_grid(l1, l2, L1, L2).numpy()
    want = ptr.numpy()
    assert staged is None or staged == (kernel.stage_rows(L1) > 0)
    paths, path_len = pa.traceback_paths(ptr, l1, l2)
    ties, layouts = 0, []
    for b in range(len(l1)):
        got_s, got_p, n_ties, lay = emulate(
            s[b], int(l1[b]), int(l2[b]), costs, kernel, seed + b, land)
        ties += n_ties
        layouts.append(lay)
        assert np.float32(got_s).view(np.int32) == \
            score[b].numpy().view(np.int32), b
        written = got_p != UNWRITTEN
        np.testing.assert_array_equal(written, grid[:, b])
        np.testing.assert_array_equal(got_p[written], want[:, b][written])
        got, n, _ = emulate_trace(got_p, int(l1[b]), int(l2[b]), L1 + L2)
        code = pa.encode_moves(pa.traceback(want[:, b], int(l1[b]),
                                            int(l2[b])))
        assert n == len(code) == path_len[b]
        np.testing.assert_array_equal(got[L1 + L2 - n:], code)
        assert (got[:L1 + L2 - n] == UNWRITTEN).all()
        np.testing.assert_array_equal(paths[b, L1 + L2 - n:].numpy(), code)
    return score, ptr, ties, layouts


def planted_ties(rng, L1, L2, l1, l2, n_codes=20):
    """Dyadic profile pairs with ties planted: profile 2 is profile 1's
    columns with a block of repeated columns inserted or cut (so a gap
    can open at several places for the same score) and some columns
    duplicated (so gap open and extend meet)."""
    B = len(l1)
    p1 = dyadic(rng, B, L1, l1, n_codes)
    p2 = np.zeros((B, L2, 20), np.float32)
    for b in range(B):
        base = p1[b, :l1[b]]
        rep = np.repeat(base[:4], 3, axis=0)  # repeated columns
        at = int(rng.integers(0, max(len(base) - 4, 1)))
        cols = np.concatenate([base[:at], rep, base[at:]])
        if len(cols) < l2[b]:
            fill = dyadic(rng, 1, l2[b] - len(cols), [l2[b] - len(cols)],
                          n_codes)[0]
            cols = np.concatenate([cols, fill])
        p2[b, :l2[b]] = cols[:l2[b]]
    return p1, p2


# -- the walk against the plain version ---------------------------------------

@pytest.mark.parametrize("core", ["blosum", "nt"])
@pytest.mark.parametrize("L1,L2", [(64, 128), (128, 64)])
def test_walk_on_planted_ties(L1, L2, core):
    """Planted ties, L1 < L2 and L1 > L2, lengths well below their
    buckets, the BLOSUM and the nucleotide cores (its gap costs): the
    emulated walk (staged scores, strips through the ring) gives the
    plain version's scores, grid pointers and paths."""
    rng = np.random.default_rng(L1 + 3 * L2 + (core == "nt"))
    l1 = np.array([L1 // 3, L1 // 2, 7, L1 - 1], np.int32)
    l2 = np.array([L2 // 2, L2 // 3, 40, L2 - 5], np.int32)
    nt = core == "nt"
    p1, p2 = planted_ties(rng, L1, L2, l1, l2, 4 if nt else 20)
    kw = dict(core=nt_core(), gaps=(float(NT_GAP_OPEN),
                                    float(NT_GAP_EXTEND))) if nt else {}
    _, _, ties, layouts = _check(p1, p2, l1, l2, staged=True, **kw)
    assert ties > 50  # pointers that an equality of two terms decided
    assert all(ring for _, _, ring in layouts)
    assert max(n for n, _, _ in layouts) >= 2


def _two_long_pairs(seed):
    """Profiles of 300 and 600 columns at the kernel's 32-lane warp."""
    rng = np.random.default_rng(seed)
    l1 = np.array([600, 300], np.int32)
    l2 = np.array([90, 200], np.int32)
    return dyadic(rng, 2, 640, l1), dyadic(rng, 2, 256, l2), l1, l2


def test_walk_spans_several_strips_at_the_kernel_width():
    """Profiles of 300 and 600 columns at the kernel's 32-lane warp: on
    8 warps the shared kernel spreads them over 5 and 7 strips in flight
    (the ring, scores staged)."""
    kernel = Kernel(shared_warps=8)
    _, _, _, layouts = _check(*_two_long_pairs(29), kernel=kernel)
    assert layouts == [(7, 3, True), (5, 2, True)]
    assert kernel.stage_rows(640) == 3


def test_walk_spans_strips_through_the_global_buffer():
    """The same pairs on 2 warps: the global kernel takes them in 2 and 3
    strips of the fewest through the global buffer, the third strip on
    the first warp again."""
    kernel = Kernel(max_warps=2, shared_warps=2)
    _, _, _, layouts = _check(*_two_long_pairs(23), kernel=kernel)
    assert layouts == [(3, 7, False), (2, 5, False)]


@pytest.mark.parametrize("gaps", [(11.0, 1.0), (3.0, 3.0), (0.5, 0.25)])
def test_small_warp_many_strips(gaps):
    """A warp of 4 lanes of at most 2 rows, 3 warps a block: in a bucket
    of 48 rows the global kernel takes profiles of up to 40 columns in up
    to 6 strips through the global buffer; in one of 23 the shared kernel
    takes the pairs that fit in up to 3 strips through the ring; profile
    2 as short as 1 column, empty profiles, and gap costs equal (open
    ties extend)."""
    rng = np.random.default_rng(int(gaps[0] * 10 + gaps[1]))
    pairs = [(0, 0), (0, 5), (5, 0), (1, 1), (3, 40), (8, 8), (9, 3),
             (17, 30), (40, 25), (33, 1), (23, 24)]
    l1 = np.array([a for a, _ in pairs], np.int32)
    l2 = np.array([b for _, b in pairs], np.int32)
    p1, p2 = planted_ties(rng, 48, 48, np.maximum(l1, 1),
                          np.maximum(l2, 1))
    small = Kernel(warp=4, max_rows=2, max_warps=3, shared_warps=3)
    _, _, _, layouts = _check(p1, p2, l1, l2, gaps=gaps, kernel=small)
    assert not any(ring for _, _, ring in layouts)
    assert max(n for n, _, _ in layouts) == 6
    fit = l1 <= 23
    _, _, _, layouts = _check(p1[fit, :23], p2[fit], l1[fit], l2[fit],
                              gaps=gaps, kernel=small)
    assert all(ring for _, _, ring in layouts)
    assert max(n for n, _, _ in layouts) == 3


def test_terminal_gap_rows_and_columns():
    """A short profile matching inside a long one, both ways round: the
    paths run along row 0 and row l1 (terminal E gaps) or column 0 and
    column l2 (terminal F gaps), at half cost."""
    rng = np.random.default_rng(31)
    long_ = dyadic(rng, 1, 128, [120])[0]
    short = np.zeros((128, 20), np.float32)
    short[:20] = long_[50:70]
    p1 = np.stack([short, long_])
    p2 = np.stack([long_, short])
    l1 = np.array([20, 120], np.int32)
    l2 = np.array([120, 20], np.int32)
    score, ptr, _, _ = _check(p1, p2, l1, l2,
                              kernel=Kernel(warp=8, max_rows=2))
    p = ptr.numpy()
    for b, (a, z) in enumerate(((20, 120), (120, 20))):
        moves = pa.traceback(p[:, b], a, z)
        lead = 0
        while moves[lead] != (1, 1):
            lead += 1
        assert lead > 30  # a long terminal gap at the start
    assert score[0] == score[1]
    # and at the kernel's width, scores staged
    _check(p1, p2, l1, l2, staged=True)


@pytest.mark.parametrize("land,warps", [("issue", 8), ("wait", 8),
                                        ("wait", 16), ("wait", 4)])
def test_ring_and_window_under_random_schedules(land, warps):
    """The ring's barriers and the score window's copies under several
    random schedules of the warps, each copy landing when it is issued
    or only at its wait: the same scores, pointers and paths, no warp
    waiting for ever, no stale or overwritten boundary column or score
    read, reads and copies on 32 banks.  The shared kernel on at most 8
    warps (rows of 1 to 4 a lane, staged: the window's row stride 33 for
    even R, 32 for odd), 16 (the most) and 4 (a call of many pairs: 3
    rows a lane staged at 256, 5 and 8 unstaged above)."""
    rng = np.random.default_rng(81)
    kernel = Kernel(shared_warps=warps)
    for L1, l1 in ((256, [250, 90]), (512, [512, 300]), (1000, [1000])):
        l1 = np.array(l1, np.int32)
        l2 = np.array([37, 70][:len(l1)], np.int32)
        p1, p2 = planted_ties(rng, L1, 128, l1, l2)
        for seed in (1, 2):
            _, _, _, layouts = _check(p1, p2, l1, l2, kernel=kernel,
                                      seed=seed, land=land)
        assert all(ring for _, _, ring in layouts)
    want = {8: [1, 1, 2, 3, 4], 16: [1, 1, 1, 2, 2], 4: [1, 2, 3, 0, 0]}
    assert [kernel.stage_rows(L) for L in (64, 128, 256, 512, 1000)] == \
        want[warps]


@pytest.mark.parametrize("case", ["ties_blosum", "ties_nt", "terminal",
                                  "l1_0", "l2_0", "ones", "strips"])
def test_trace_emulation_matches_traceback(case):
    """The kernel's walk phase (its window, thread 0's moves) on the
    plain version's pointers gives `traceback`'s moves, encoded, and the
    plain walk's paths: planted ties under both cores, terminal gaps,
    l1 = 0, l2 = 0, l1 = l2 = 1, and pairs over several strips and many
    windows."""
    rng = np.random.default_rng(sum(map(ord, case)))
    gaps, core = (11.0, 1.0), None
    if case.startswith("ties"):
        l1 = np.array([40, 63, 5], np.int32)
        l2 = np.array([60, 30, 64], np.int32)
        nt = case == "ties_nt"
        p1, p2 = planted_ties(rng, 64, 64, l1, l2, 4 if nt else 20)
        if nt:
            gaps, core = (float(NT_GAP_OPEN), float(NT_GAP_EXTEND)), nt_core()
    elif case == "terminal":
        long_ = dyadic(rng, 1, 128, [110])[0]
        short = np.zeros((128, 20), np.float32)
        short[:12] = long_[40:52]
        p1, p2 = np.stack([short, long_]), np.stack([long_, short])
        l1 = np.array([12, 110], np.int32)
        l2 = np.array([110, 12], np.int32)
    else:
        pairs = {"l1_0": [(0, 9), (0, 64), (0, 0)],
                 "l2_0": [(9, 0), (64, 0)], "ones": [(1, 1), (1, 2), (2, 1)],
                 "strips": [(300, 280), (299, 17)]}[case]
        l1 = np.array([a for a, _ in pairs], np.int32)
        l2 = np.array([b for _, b in pairs], np.int32)
        L = 320 if case == "strips" else 64
        p1, p2 = planted_ties(rng, L, L, np.maximum(l1, 1),
                              np.maximum(l2, 1))
    args = [torch.as_tensor(x) for x in (p1, p2, l1, l2)]
    score, ptr = pa.nw_profile_dp_plain(
        *args, *gaps, core_matrix=None if core is None
        else torch.as_tensor(core))
    D, B, _ = ptr.shape
    grid = pa.on_grid(l1, l2, p1.shape[1], p2.shape[1]).numpy()
    host = np.where(grid, ptr.numpy(), UNWRITTEN)  # the grid only
    paths, path_len = pa.traceback_paths(ptr, l1, l2)
    assert paths.shape == (B, D - 1) and path_len.dtype == torch.int32
    windows = []
    for b in range(B):
        got, n, w = emulate_trace(host[:, b], int(l1[b]), int(l2[b]), D - 1)
        moves = pa.traceback(ptr.numpy()[:, b], int(l1[b]), int(l2[b]))
        assert n == len(moves) == int(path_len[b])
        np.testing.assert_array_equal(got[D - 1 - n:], pa.encode_moves(moves))
        np.testing.assert_array_equal(paths[b, D - 1 - n:].numpy(),
                                      got[D - 1 - n:])
        assert (paths[b, :D - 1 - n] == 0).all()
        np.testing.assert_array_equal(pa.MOVES[got[D - 1 - n:]],
                                      np.reshape(moves, (-1, 2)))
        windows.append(w)
    if case == "strips":
        assert min(windows) >= 5  # many windows a pair
    if case == "l1_0":
        assert [int(x) for x in path_len] == [9, 64, 0]


# -- the layout and the kernel's interface ------------------------------------

def test_layout_fits_the_rows():
    """The shared kernel spreads a pair's rows over its launch's warps
    (at most min(ceil((L1 + 1) / 32), SHARED_WARPS) for the bucket L1)
    with the fewest rows a lane that fit (every strip in flight: the
    ring), at buckets of at most SHARED_ROWS rows; the global kernel
    takes the fewest strips of WARP R rows on min(strips, MAX_WARPS)
    warps, the last strip wasting fewer than WARP R rows; the global
    boundaries and their counts are a strip of the fewest each, and the
    score window is sized by the bucket's longest pair."""
    assert (WARP, MAX_ROWS, MAX_WARPS, SHARED_WARPS, SHARED_ROWS) == \
        (32, 8, 8, 16, 2048)
    for kernel in (KERNEL, Kernel(shared_warps=4)):
        for L1 in (64, 128, 256, 512, 1000, 1024, 2048, 8192):
            warps = kernel.warps(L1)
            for l1 in range(0, L1 + 1):
                n, rows = kernel.layout(l1, L1)
                assert 1 <= rows <= MAX_ROWS
                assert n * WARP * rows >= l1 + 1 > (n - 1) * WARP * rows
                if kernel.shared(L1):  # spread: the fewest rows that fit
                    assert n <= warps
                    assert rows == 1 or (rows - 1) * WARP * warps < l1 + 1
                else:
                    assert n == cdiv(l1 + 1, WARP * MAX_ROWS)
    assert [KERNEL.warps(L) for L in (64, 128, 256, 512, 1024, 2048)] == \
        [3, 5, 9, 16, 16, 8]
    assert [KERNEL.shared(L) for L in (1024, 2047, 2048)] == \
        [True, True, False]
    assert KERNEL.layout(255, 256) == (8, 1)
    assert KERNEL.layout(256, 256) == (9, 1)
    assert KERNEL.layout(1022, 1022) == (16, 2)
    assert KERNEL.layout(1024, 1024) == (11, 3)
    assert KERNEL.layout(2046, 2047) == (16, 4)
    assert KERNEL.layout(2048, 2048) == (9, 8)
    assert KERNEL.layout(8192, 8192) == (33, 8)
    assert [KERNEL.stage_rows(L) for L in (1024, 2048)] == [3, 0]
    for text in ("WARP * pl->warps",
                 "pl->warps = n < MAX_WARPS ? n : MAX_WARPS",
                 "pl->warps = w_max < SHARED_WARPS ? w_max : SHARED_WARPS",
                 "const int w_min = ceil_div(L1 + 1, WARP * MAX_ROWS)",
                 "L1 + 1 <= SHARED_ROWS && L1 + 1 <= WARP * SHARED_WARPS * MAX_ROWS",
                 "m.win = m.done + (shared ? 0 : strips_for(L1 + 1)) * 4",
                 "return R <= STAGE_ROWS ? R : 0",
                 "if ((long long)blocks * sms >= B) break"):
        assert text in SOURCE, text


def test_launcher_matches_declared_argtypes_and_build():
    sigs = _c_signatures(pa.SOURCE)
    assert set(sigs) == set(pa.ARGTYPES)
    types = dict(C_TYPES, float=ctypes.c_float)
    for name, (ret, params) in sigs.items():
        assert [types[t] for t in params] == pa.ARGTYPES[name], name
    assert sigs["profile_dp_launch"][0] == "int"  # cudaGetLastError()
    assert pa.RESTYPES["profile_dp_launch"] is ctypes.c_int
    launch = SOURCE[SOURCE.index("int profile_dp_launch("):]
    names = re.findall(r"(\w+)[,)]", launch[:launch.index("{")])
    assert names == ["s", "len1", "len2", "B", "L1", "L2", "go", "ge",
                     "go_t", "ge_t", "score", "ptr", "path", "path_len",
                     "scratch", "scratch_bytes", "stream"]
    for name in ("profile_dp_plan", "profile_dp_stamps",
                 "profile_dp_num_regs"):
        assert pa.RESTYPES[name] is ctypes.c_int
    assert "profile_dp" in _cuda.SOURCES
    cmd = _cuda.nvcc_command("nvcc", pa.SOURCE, "/x/lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and cmd[-1] == pa.SOURCE
    assert not any("fast_math" in x or "fast-math" in x for x in cmd)
    assert "torch/extension.h" not in SOURCE
    assert "pepr_tpu/ops/profile_align.py:157" in SOURCE
    assert _cuda.lib_path("profile_dp").startswith(_cuda.BUILD_DIR)
    assert (pa.MOVE_I, pa.MOVE_J) == tuple(
        int(re.search(rf"#define {m} (\d+)", SOURCE).group(1))
        for m in ("MOVE_I", "MOVE_J"))


def test_shared_memory_plan_within_the_card():
    """The block's shared memory, as smem_plan lays it out, for each
    bucket at the most warps its kernel takes: the score window at most
    32 STAGE_ROWS 33 floats a warp, all of it within the 227 KB a block
    may have (232,448 bytes; above it the launch takes fewer warps)."""
    def plan(L1, kernel=KERNEL):
        warps = kernel.warps(L1)
        edges = warps - 1 if kernel.shared(L1) else 0
        ring = edges * 2 * RING_SLOTS * 8 + edges * RING_SLOTS * RING_COLS * 8
        window = warps * kernel.stage_rows(L1) * WARP * (STAGE_COLS + 1) * 4
        done = 0 if kernel.shared(L1) else cdiv(L1 + 1, WARP * MAX_ROWS) * 4
        return ring + window + done + 2 * WIN_DIAGS * WIN_ROWS + 16
    sizes = {L: plan(L) for L in (64, 128, 256, 512, 1024, 2048, 8192)}
    assert max(sizes.values()) <= 232448
    assert (sizes[512], sizes[1024]) == (145040, 212624)  # 16 warps staged
    assert plan(1700) > 232448 >= plan(1700, Kernel(shared_warps=13))
    assert "m.bytes = m.cur + 4 * 4" in SOURCE
    assert "m.cur = m.win + 2 * WIN_DIAGS * WIN_ROWS" in SOURCE
    assert "if (bytes <= limit)" in SOURCE


def test_on_grid_and_grid_cells():
    l1, l2 = np.array([3, 0, 5]), np.array([2, 4, 0])
    g = pa.on_grid(l1, l2, 6, 4).numpy()
    assert g.shape == (11, 3, 7)
    assert [int(g[:, b].sum()) for b in range(3)] == [12, 5, 6]
    assert pa.grid_cells(l1, l2) == 23
    for b in range(3):
        k, i = np.nonzero(g[:, b])
        j = k - i
        assert set(zip(i.tolist(), j.tolist())) == {
            (x, y) for x in range(l1[b] + 1) for y in range(l2[b] + 1)}


# -- the wrapper --------------------------------------------------------------

@pytest.fixture(scope="module")
def small_call():
    rng = np.random.default_rng(41)
    l1 = np.array([30, 50, 12], np.int32)
    l2 = np.array([60, 20, 64], np.int32)
    return [torch.as_tensor(x) for x in (dyadic(rng, 3, 64, l1),
                                         dyadic(rng, 3, 64, l2), l1, l2)]


def test_cpu_tensors_take_the_plain_version(small_call):
    pa.reset_launch_counts()
    score, ptr = pa.nw_profile_dp(*small_call)
    walked = dict(pa.PLAIN_WALK)
    s_w, path, path_len = pa.nw_profile_path(*small_call)
    assert pa.LAUNCHES == {"profile_dp": 0}
    assert pa.PLAIN_WALK["calls"] == walked["calls"] + 1
    assert pa.PLAIN_WALK["ptr_bytes"] == walked["ptr_bytes"] + ptr.numel()
    s_p, p_p = pa.nw_profile_dp_plain(*small_call)
    assert torch.equal(score, s_p) and torch.equal(ptr, p_p)
    assert torch.equal(s_w, s_p)
    assert ptr.shape == (129, 3, 65) and ptr.dtype == torch.uint8
    assert path.shape == (3, 128) and path.dtype == torch.uint8
    for b in range(3):
        moves = pa.traceback(ptr.numpy()[:, b], int(small_call[2][b]),
                             int(small_call[3][b]))
        n = int(path_len[b])
        np.testing.assert_array_equal(pa.MOVES[path[b, 128 - n:].numpy()],
                                      moves)


def test_kernel_wrapper_refuses_cpu_tensors(small_call):
    p1, p2, l1, l2 = small_call
    s = pa.column_scores(p1, p2, torch.as_tensor(pa.blosum_core()))
    pa.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA device"):
        pa.profile_dp(s, l1, l2, *pa.gap_costs(11.0, 1.0, 0.5))
    assert pa.LAUNCHES == {"profile_dp": 0}


def test_cuda_request_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fam = [np.arange(12, dtype=np.int8), np.arange(2, 14, dtype=np.int8)]
    with pytest.raises(RuntimeError, match="CUDA"):
        msa.align_families([fam], device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        msa.align_families([fam])  # the default is the card


def test_gap_costs_are_float32_products():
    go, ge, go_t, ge_t = pa.gap_costs(11.0, 1.0, 0.5)
    assert (go, ge, go_t, ge_t) == (11.0, 1.0, 5.5, 0.5)
    costs = pa.gap_costs(0.1, 0.3, 0.7)
    assert costs[2] == float(np.float32(0.1) * np.float32(0.7))
    assert costs[3] == float(np.float32(0.3) * np.float32(0.7))
    assert all(float(np.float32(x)) == x for x in costs)


def test_a_pair_does_not_depend_on_its_batch(small_call):
    """Each pair alone gives its score, grid pointers and path in the
    batch: why align_families may leave a call's batch unpadded."""
    score, ptr = pa.nw_profile_dp(*small_call)
    _, path, path_len = pa.nw_profile_path(*small_call)
    grid = pa.on_grid(small_call[2], small_call[3], 64, 64)
    for b in range(3):
        one = [x[b:b + 1] for x in small_call]
        s_one, p_one = pa.nw_profile_dp(*one)
        assert torch.equal(s_one, score[b:b + 1])
        assert torch.equal(p_one[:, 0][grid[:, b]], ptr[:, b][grid[:, b]])
        _, q_one, n_one = pa.nw_profile_path(*one)
        assert torch.equal(q_one, path[b:b + 1])
        assert torch.equal(n_one, path_len[b:b + 1])


def test_traceback_paths_refuses_card_tensors():
    class OnTheCard:  # what the plain walk sees of a CUDA tensor
        is_cuda = True

    with pytest.raises(ValueError, match="on the card the kernel walks"):
        pa.traceback_paths(OnTheCard(), [2], [2])


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_small_align_inputs_and_bound(smoke):
    """chip_smoke.py's small_align inputs (float profiles, nucleotide
    pairs of k/4 columns) and the DP's bound: 4 bytes a scored cell and
    1 a grid cell, and the walk's byte read and byte written a move,
    over 3.35 TB/s."""
    rng = np.random.default_rng(71)
    p, lens = smoke.float_profiles(rng, 5, 256)
    assert p.shape == (5, 256, 20) and ((lens >= 64) & (lens < 128)).all()
    on = np.arange(256)[None, :] < lens[:, None]
    mass = p.sum(-1)[on]  # a column's residues, the rest gaps
    assert ((mass > 0.25 - 1e-6) & (mass < 1 + 1e-6)).all()
    assert (p[~on] == 0).all()
    p1, l1, p2, l2 = smoke.nt_profile_pairs(rng, 3, 512, lengths=(300, 400))
    for q, n in ((p1, l1), (p2, l2)):
        assert q.shape == (3, 512, 20) and (n <= 400).all() and (n > 250).all()
        assert np.array_equal(q * 4, np.round(q * 4))
        assert (q[:, :, 4:] == 0).all()
        on = np.arange(512)[None, :] < n[:, None]
        assert (q.sum(-1)[on] == 1).all() and (q[~on] == 0).all()
    ms, by = smoke.dp_bound([3], [4], [6])
    assert by == "bytes"
    assert ms == pytest.approx(
        1e3 * (4 * 12 + 20 + 12 + 2 * 6 + 4) / smoke.PEAK_BYTES)
    # the same pairs, one call and two: the bound adds up
    ms2, _ = smoke.dp_bound([3, 3], [4, 4], [6, 6])
    assert ms2 == pytest.approx(2 * ms)


# -- the MSA's tally ----------------------------------------------------------

def test_align_tally_counts_grid_cells_and_unpadded_calls(monkeypatch):
    rng = np.random.default_rng(51)
    fams = [[rng.integers(0, 20, size=int(n)).astype(np.int8)
             for n in rng.integers(30, 90, size=k)] for k in (3, 2, 4, 5)]
    seen = []
    dp = msa.nw_profile_path

    def record(p1, p2, l1, l2, **kw):
        seen.append((p1.shape, p2.shape, l1.numpy().copy(),
                     l2.numpy().copy()))
        return dp(p1, p2, l1, l2, **kw)

    monkeypatch.setattr(msa, "nw_profile_path", record)
    msa.reset_align_counts()
    pa.reset_launch_counts()
    got = msa.align_families(fams, device="cpu")
    tally = dict(msa.ALIGN)
    assert set(tally) == {"calls", "launches", "dp_steps", "cells",
                          "ptr_bytes", "path_bytes", "traceback_seconds",
                          "merge_seconds", "kernel_ms"}
    assert tally["calls"] == len(seen) > 0
    assert tally["launches"] == 0 == pa.LAUNCHES["profile_dp"]
    # every pair of a call is a real merge: no batch padding
    assert sum(len(x[2]) for x in seen) == sum(len(f) - 1 for f in fams)
    assert tally["cells"] == sum(pa.grid_cells(a, b)
                                 for _, _, a, b in seen)
    assert tally["dp_steps"] == sum(s1[1] + s2[1] + 1
                                    for s1, s2, _, _ in seen)
    # the CPU walks the pointers on the host: the plain walk's input
    assert tally["ptr_bytes"] == sum((s1[1] + s2[1] + 1) * s1[0] * (s1[1] + 1)
                                     for s1, s2, _, _ in seen)
    assert tally["path_bytes"] == sum(s1[0] * (s1[1] + s2[1] + 4)
                                      for s1, s2, _, _ in seen)
    assert tally["traceback_seconds"] > 0 and tally["merge_seconds"] > 0
    assert tally["kernel_ms"] == {}  # no kernel on the CPU
    for g, f in zip(got, fams):
        assert g.shape[0] == len(f)
    msa.reset_align_counts()
    assert all(not v for v in msa.ALIGN.values())


# -- on a card ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("core", ["blosum", "nt"])
def test_kernel_matches_plain_version_on_card(cuda_device, core):
    rng = np.random.default_rng(61)
    L1, L2 = 256, 512
    l1 = rng.integers(1, L1 + 1, size=12).astype(np.int32)
    l2 = rng.integers(1, L2 + 1, size=12).astype(np.int32)
    nt = core == "nt"
    p1, p2 = planted_ties(rng, L1, L2, l1, l2, 4 if nt else 20)
    args = [torch.as_tensor(x, device=cuda_device)
            for x in (p1, p2, l1, l2)]
    kw = {}
    if nt:
        kw = dict(gap_open=float(NT_GAP_OPEN),
                  gap_extend=float(NT_GAP_EXTEND),
                  core_matrix=torch.as_tensor(nt_core()))
    pa.reset_launch_counts()
    s_k, p_k = pa.nw_profile_dp(*args, **kw)
    assert pa.LAUNCHES == {"profile_dp": 1}
    s_p, p_p = pa.nw_profile_dp_plain(*args, **kw)
    grid = pa.on_grid(l1, l2, L1, L2).to(cuda_device)
    assert torch.equal(s_k.view(torch.int32), s_p.view(torch.int32))
    assert torch.equal(p_k[grid], p_p[grid])


@pytest.mark.cuda
@pytest.mark.parametrize("L1,L2", [(128, 128), (256, 512), (1024, 256),
                                   (4096, 128)])
def test_kernel_paths_match_plain_walk_on_card(cuda_device, L1, L2):
    """`nw_profile_path` on the card (one launch, DP and walk) against
    the plain DP and the plain walk on the CPU: scores, path lengths and
    every move, staged buckets and not, ring and global boundaries."""
    rng = np.random.default_rng(L1 + L2)
    l1 = rng.integers(0, L1 + 1, size=6).astype(np.int32)
    l2 = rng.integers(0, L2 + 1, size=6).astype(np.int32)
    l1[0], l2[0] = L1, L2
    p1, p2 = planted_ties(rng, L1, L2, np.maximum(l1, 1), np.maximum(l2, 1))
    host = [torch.as_tensor(x) for x in (p1, p2, l1, l2)]
    pa.reset_launch_counts()
    walked = dict(pa.PLAIN_WALK)
    s_k, q_k, n_k = pa.nw_profile_path(*(x.to(cuda_device) for x in host))
    assert pa.LAUNCHES == {"profile_dp": 1}
    assert pa.PLAIN_WALK == walked  # the card never reaches the plain walk
    s_p, q_p, n_p = pa.nw_profile_path(*host)
    assert torch.equal(s_k.cpu().view(torch.int32), s_p.view(torch.int32))
    assert torch.equal(n_k.cpu(), n_p)
    q_k = q_k.cpu()
    for b in range(6):
        n = int(n_p[b])
        assert torch.equal(q_k[b, L1 + L2 - n:], q_p[b, L1 + L2 - n:])
