"""The profile DP's kernel (csrc/profile_dp.cu) and its wrapper, on the
CPU, and its tally in the progressive MSA.

The kernel's walk is emulated in numpy, step by step in the kernel's
order, in float32: lanes of R rows of profile 1, strips of WARP * R
rows each walked by a warp as an anti-diagonal wavefront (row t of a
strip t steps behind row 0), a lane's rows bottom to top, the bottom
row's H and F handed to the next lane after each step, the boundary
buffer that lane WARP-1 of a strip writes and lane 0 of the next strip
reads a step ahead (row -1 above the first strip), only the grid cells
walked, and each pointer byte written where the kernel writes it in the
diagonal-major layout.  The strips run one after the other here; on the
card several run at once, meeting only through the buffer, whose
columns lane 0 reads once they are published.
The emulation is held bit for bit against the port's plain version
(`nw_profile_dp_plain`, itself held against the JAX package in
tests/test_torch_msa.py): the score and every grid pointer equal, every
grid cell written once and nothing off the grid.  Cases: dyadic
profiles (values k/4, exact in float32) with planted ties, L1 < L2 and
L1 > L2, lengths well below their buckets, profiles spanning several
strips (at the kernel's warp and at a warp of 4 lanes of 2 rows), the
BLOSUM and the nucleotide cores, terminal-gap rows and columns, and
empty profiles.  This emulation is test code, its layout read from the
kernel's source.  A test marked `cuda`
holds the kernel against the plain version on a card."""

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
# the kernel's lanes a warp and most rows a lane, from its source
WARP, MAX_ROWS = (int(re.search(rf"#define {m} (\d+)", SOURCE).group(1))
                  for m in ("WARP", "MAX_ROWS"))


def layout(l1, warp=WARP, max_rows=MAX_ROWS):
    """(strips, rows a lane) of the kernel's walk over l1 + 1 rows:
    strips of warp * rows rows, as few as max_rows allows."""
    rows = l1 + 1
    n = -(-rows // (warp * max_rows))
    return n, -(-rows // (warp * n))


def emulate(s, l1, l2, costs, warp=WARP, max_rows=MAX_ROWS):
    """One pair as profile_dp_kernel walks it, its strips one after the
    other (the kernel runs several at once; they meet only through the
    boundary buffer): s (L1, L2) float32 column scores; returns (score,
    the pair's pointers (D, L1 + 1) uint8, UNWRITTEN where the kernel
    writes nothing, and the number of grid cells off the NEG border whose
    pointer a tie decided)."""
    L1, L2 = s.shape
    go, ge, go_t, ge_t = (np.float32(x) for x in costs)
    ptr = np.full((L1 + L2 + 1, L1 + 1), UNWRITTEN, np.uint8)
    score = None
    ties = 0
    n, R = layout(l1, warp, max_rows)
    cols = l2 + 1
    lanes = np.arange(warp)
    # the boundary before the strip: its (H, F) by column, and the strip
    # that wrote each column (-1: row -1, which no strip writes)
    bin_ = np.full((cols, 2), NEG, np.float32)
    bin_strip = np.full(cols, -1)
    for st in range(n):
        i0 = st * warp * R + lanes * R
        rmax = l1 - i0
        n_steps = min(warp * R, l1 + 1 - st * warp * R) - 1 + cols
        feeds = st + 1 < n
        bout = np.full((cols, 2), NEG, np.float32)
        bout_strip = np.full(cols, -2)
        e_term = ((i0[:, None] + np.arange(R)) == 0) \
            | ((i0[:, None] + np.arange(R)) == l1)
        goe = np.where(e_term, go_t, go)
        gee = np.where(e_term, ge_t, ge)
        h, e, f, hd = (np.full((warp, R), NEG, np.float32) for _ in range(4))
        hu = np.full(warp, NEG, np.float32)
        fu = np.full(warp, NEG, np.float32)
        nxt = bin_[0].copy()
        assert bin_strip[0] == st - 1
        for tau in range(n_steps):
            c0 = tau - lanes * R
            hu[0], fu[0] = nxt
            if tau + 1 < cols:  # lane 0 reads a column a step ahead
                assert bin_strip[tau + 1] == st - 1, (st, tau)
                nxt = bin_[tau + 1].copy()
            for r in reversed(range(R)):  # bottom to top
                c = c0 - r
                i = i0 + r
                ok = (r <= rmax) & (c >= 0) & (c < cols)
                sv = np.where(ok & (i > 0) & (c > 0),
                              s[np.clip(i - 1, 0, L1 - 1),
                                np.clip(c - 1, 0, L2 - 1)], np.float32(0))
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
                ties += int((ok & tie & (hv > NEG)).sum())
                for a, v in ((h, hv), (e, ev), (f, fv), (hd, ah)):
                    a[ok, r] = v[ok]
            if st == 0 and tau == 0:
                h[0, 0] = 0.0  # the origin, after its pointer
            at = (rmax >= 0) & (rmax < R) & (c0 - rmax == l2)
            if at.any():
                assert score is None
                lane = int(np.nonzero(at)[0][0])
                score = h[lane, rmax[lane]]
            c = c0[-1] - (R - 1)
            if feeds and 0 <= c < cols:  # lane 31's bottom row
                bout[c] = h[-1, R - 1], f[-1, R - 1]
                bout_strip[c] = st
            # __shfl_up_sync: lane l takes lane l-1's bottom row, lane 0
            # its own
            hu = np.concatenate([h[:1, R - 1], h[:-1, R - 1]])
            fu = np.concatenate([f[:1, R - 1], f[:-1, R - 1]])
        bin_, bin_strip = bout, bout_strip
    return score, ptr, ties


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


def _check(p1, p2, l1, l2, core=None, gaps=(11.0, 1.0), warp=WARP,
           max_rows=MAX_ROWS):
    """The emulation == the plain version on every pair: the score's
    bits and every grid pointer; nothing written off the grid.  Returns
    the plain version's (score, ptr (D, B, R1)) and the emulation's tie
    count."""
    args = [torch.as_tensor(x) for x in (p1, p2, l1, l2)]
    cm = None if core is None else torch.as_tensor(core)
    score, ptr = pa.nw_profile_dp_plain(*args, gaps[0], gaps[1],
                                        core_matrix=cm)
    s = pa.column_scores(args[0], args[1], torch.as_tensor(
        pa.blosum_core() if core is None else core)).numpy()
    costs = pa.gap_costs(gaps[0], gaps[1], 0.5)
    grid = pa.on_grid(l1, l2, p1.shape[1], p2.shape[1]).numpy()
    want = ptr.numpy()
    ties = 0
    for b in range(len(l1)):
        got_s, got_p, n_ties = emulate(s[b], int(l1[b]), int(l2[b]), costs,
                                       warp, max_rows)
        ties += n_ties
        assert np.float32(got_s).view(np.int32) == \
            score[b].numpy().view(np.int32), b
        written = got_p != UNWRITTEN
        np.testing.assert_array_equal(written, grid[:, b])
        np.testing.assert_array_equal(got_p[written], want[:, b][written])
    return score, ptr, ties


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
    emulated walk gives the plain version's scores and grid pointers."""
    rng = np.random.default_rng(L1 + 3 * L2 + (core == "nt"))
    l1 = np.array([L1 // 3, L1 // 2, 7, L1 - 1], np.int32)
    l2 = np.array([L2 // 2, L2 // 3, 40, L2 - 5], np.int32)
    nt = core == "nt"
    p1, p2 = planted_ties(rng, L1, L2, l1, l2, 4 if nt else 20)
    kw = dict(core=nt_core(), gaps=(float(NT_GAP_OPEN),
                                    float(NT_GAP_EXTEND))) if nt else {}
    _, _, ties = _check(p1, p2, l1, l2, **kw)
    assert ties > 50  # pointers that an equality of two terms decided


def test_walk_spans_several_strips_at_the_kernel_width():
    """Profiles of 300 and 600 columns: 2 and 3 strips of the kernel's
    32-lane warp, the strips handed on through the buffer."""
    rng = np.random.default_rng(21)
    l1 = np.array([600, 300], np.int32)
    l2 = np.array([90, 200], np.int32)
    assert layout(600) == (3, 7) and layout(300) == (2, 5)
    p1 = dyadic(rng, 2, 640, l1)
    p2 = dyadic(rng, 2, 256, l2)
    _check(p1, p2, l1, l2)


@pytest.mark.parametrize("gaps", [(11.0, 1.0), (3.0, 3.0), (0.5, 0.25)])
def test_small_warp_many_strips(gaps):
    """A warp of 4 lanes of at most 2 rows: profiles of up to 40 columns
    take up to 6 strips, profile 2 as short as 1 column (P = 5 > l2 +
    1), empty profiles, and gap costs equal (open ties extend)."""
    rng = np.random.default_rng(int(gaps[0] * 10 + gaps[1]))
    pairs = [(0, 0), (0, 5), (5, 0), (1, 1), (3, 40), (8, 8), (9, 3),
             (17, 30), (40, 25), (33, 1), (24, 24)]
    l1 = np.array([a for a, _ in pairs], np.int32)
    l2 = np.array([b for _, b in pairs], np.int32)
    p1, p2 = planted_ties(rng, 48, 48, np.maximum(l1, 1),
                          np.maximum(l2, 1))
    _check(p1, p2, l1, l2, gaps=gaps, warp=4, max_rows=2)


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
    score, ptr, _ = _check(p1, p2, l1, l2, warp=8, max_rows=2)
    p = ptr.numpy()
    for b, (a, z) in enumerate(((20, 120), (120, 20))):
        moves = pa.traceback(p[:, b], a, z)
        lead = 0
        while moves[lead] != (1, 1):
            lead += 1
        assert lead > 30  # a long terminal gap at the start
    assert score[0] == score[1]


# -- the layout and the kernel's interface ------------------------------------

def test_layout_fits_the_rows():
    """Strips of WARP R rows, R <= MAX_ROWS, the last one wasting fewer
    than WARP R rows; the source's launch gives a pair min(strips,
    MAX_WARPS) warps and its boundary buffers and counts a strip each."""
    assert (WARP, MAX_ROWS) == (32, 8)
    for l1 in range(0, 8193):
        n, rows = layout(l1)
        assert 1 <= rows <= MAX_ROWS
        assert n * WARP * rows >= l1 + 1 > (n - 1) * WARP * rows
    assert layout(255) == (1, 8)
    assert layout(256) == (2, 5)
    assert layout(8192) == (33, 8)
    for text in ("WARP * warps_for(L1)",
                 "return n < MAX_WARPS ? n : MAX_WARPS",
                 "strips_for(L1 + 1) * sizeof(int)"):
        assert text in SOURCE, text


def test_launcher_matches_declared_argtypes_and_build():
    sigs = _c_signatures(pa.SOURCE)
    assert set(sigs) == set(pa.ARGTYPES)
    types = dict(C_TYPES, float=ctypes.c_float)
    for name, (ret, params) in sigs.items():
        assert [types[t] for t in params] == pa.ARGTYPES[name], name
    assert sigs["profile_dp_launch"][0] == "int"  # cudaGetLastError()
    assert pa.RESTYPES["profile_dp_launch"] is ctypes.c_int
    assert "profile_dp" in _cuda.SOURCES
    cmd = _cuda.nvcc_command("nvcc", pa.SOURCE, "/x/lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and cmd[-1] == pa.SOURCE
    assert not any("fast_math" in x or "fast-math" in x for x in cmd)
    assert "torch/extension.h" not in SOURCE
    assert "pepr_tpu/ops/profile_align.py:157" in SOURCE
    assert _cuda.lib_path("profile_dp").startswith(_cuda.BUILD_DIR)


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
    assert pa.LAUNCHES == {"profile_dp": 0}
    s_p, p_p = pa.nw_profile_dp_plain(*small_call)
    assert torch.equal(score, s_p) and torch.equal(ptr, p_p)
    assert ptr.shape == (129, 3, 65) and ptr.dtype == torch.uint8


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
    """Each pair alone gives its score and grid pointers in the batch:
    why align_families may leave a call's batch unpadded."""
    score, ptr = pa.nw_profile_dp(*small_call)
    grid = pa.on_grid(small_call[2], small_call[3], 64, 64)
    for b in range(3):
        one = [x[b:b + 1] for x in small_call]
        s_one, p_one = pa.nw_profile_dp(*one)
        assert torch.equal(s_one, score[b:b + 1])
        assert torch.equal(p_one[:, 0][grid[:, b]], ptr[:, b][grid[:, b]])


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
    1 a grid cell over 3.35 TB/s."""
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
    ms, by = smoke.dp_bound([3], [4])
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * (4 * 12 + 20 + 12) / smoke.PEAK_BYTES)
    # the same pairs, one call and two: the bound adds up
    ms2, _ = smoke.dp_bound([3, 3], [4, 4])
    assert ms2 == pytest.approx(2 * ms)


# -- the MSA's tally ----------------------------------------------------------

def test_align_tally_counts_grid_cells_and_unpadded_calls(monkeypatch):
    rng = np.random.default_rng(51)
    fams = [[rng.integers(0, 20, size=int(n)).astype(np.int8)
             for n in rng.integers(30, 90, size=k)] for k in (3, 2, 4, 5)]
    seen = []
    dp = msa.nw_profile_dp

    def record(p1, p2, l1, l2, **kw):
        seen.append((p1.shape, p2.shape, l1.numpy().copy(),
                     l2.numpy().copy()))
        return dp(p1, p2, l1, l2, **kw)

    monkeypatch.setattr(msa, "nw_profile_dp", record)
    msa.reset_align_counts()
    pa.reset_launch_counts()
    got = msa.align_families(fams, device="cpu")
    tally = dict(msa.ALIGN)
    assert set(tally) == {"calls", "launches", "dp_steps", "cells",
                          "ptr_bytes", "host_seconds"}
    assert tally["calls"] == len(seen) > 0
    assert tally["launches"] == 0 == pa.LAUNCHES["profile_dp"]
    # every pair of a call is a real merge: no batch padding
    assert sum(len(x[2]) for x in seen) == sum(len(f) - 1 for f in fams)
    assert tally["cells"] == sum(pa.grid_cells(a, b)
                                 for _, _, a, b in seen)
    assert tally["dp_steps"] == sum(s1[1] + s2[1] + 1
                                    for s1, s2, _, _ in seen)
    assert tally["ptr_bytes"] == sum((s1[1] + s2[1] + 1) * s1[0] * (s1[1] + 1)
                                     for s1, s2, _, _ in seen)
    assert tally["host_seconds"] > 0
    for g, f in zip(got, fams):
        assert g.shape[0] == len(f)
    msa.reset_align_counts()
    assert all(v == 0 for v in msa.ALIGN.values())


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
