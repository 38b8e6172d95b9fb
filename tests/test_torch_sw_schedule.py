"""The Smith-Waterman kernel's walk (csrc/sw.cu), emulated in numpy on
the CPU, step by step in the kernel's order: one warp per pair, lanes
of R query rows, strips of WARP * R rows with no gap between them, the
bottom rows handed to the next lane after each step, the strip buffer
that lane WARP-1 writes and lane 0 reads a step ahead (the boundary row
before the first strip), the PAD tails cut off by the real lengths,
each row's best by a strict > along the target and the (score, -row)
key reduction.  The emulation is held, exactly on all five outputs,
against the numpy oracle `sw_align_numpy` and the port's plain
`sw_align_batch` (which walks the whole padded rectangle): on planted
ties across strip and lane boundaries, at query lengths of 32 R - 1,
32 R and 32 R + 1, with gap_open or gap_extend 0, and on pairs embedded
in larger buckets.  It asserts on the way that every buffer read finds
the column that the strip above wrote, before it was overwritten.  This
emulation is test code; the package holds only the layout
(`ops/sw.strip_layout`)."""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from pepr_tpu_torch.data.nt_scores import nt_kernel_matrix
from pepr_tpu_torch.ops import sw
from pepr_tpu_torch.ops.smith_waterman import (kernel_matrix, sw_align_batch,
                                               sw_align_numpy)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("score", "matches", "length", "q_end", "t_end")
NEG = -(1 << 28)
PAD = 24


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _clamp(x):
    x = np.asarray(x, np.int64)
    return np.where((x < 0) | (x > PAD), PAD, x)


def real_length(x) -> int:
    real = np.nonzero(_clamp(x) != PAD)[0]
    return int(real[-1]) + 1 if len(real) else 0


def layout(lq, warp, max_rows):
    n = max(1, -(-lq // (warp * max_rows)))
    return n, max(1, -(-lq // (warp * n)))


def emulate(q, t, sub, go=11, ge=1, warp=sw.WARP, max_rows=sw.MAX_ROWS):
    """One pair (PAD-filled code rows of any length) as one warp of
    sw_kernel walks it; returns the five outputs."""
    sub = np.asarray(sub, np.int64)
    qc_all, tc_all = _clamp(q), _clamp(t)
    lq, lt = real_length(q), real_length(t)
    lanes = np.arange(warp)
    bv_l = np.zeros(warp, np.int64)       # the lane's best
    brow_l = lanes.copy()
    bj_l = np.zeros(warp, np.int64)
    bml_l = np.zeros(warp, np.int64)
    if lq and lt:
        n, R = layout(lq, warp, max_rows)
        P = max(lt, warp + 1)

        def fold(mask, s):
            i0 = s * warp * R + lanes * R
            for r in range(R):
                better = mask & (bv[:, r] > bv_l)
                bv_l[better] = bv[better, r]
                brow_l[better] = (i0 + r)[better]
                bj_l[better] = bj[better, r]
                bml_l[better] = bml[better, r]

        shape = (warp, R)
        qc = np.full(shape, PAD)
        hp, mlh, mle = (np.zeros(shape, np.int64) for _ in range(3))
        e = np.full(shape, NEG, np.int64)
        bv, bml, bj = (np.zeros(shape, np.int64) for _ in range(3))
        c, s = -lanes, np.zeros(warp, np.int64)
        dh, dml = np.zeros(warp, np.int64), np.zeros(warp, np.int64)
        up = np.zeros((4, warp), np.int64)
        up[1] = NEG
        tc = np.full(warp, PAD)
        # the strip buffer starts as the boundary row (strip -1)
        buf = np.tile(np.array([0, NEG, 0, 0], np.int64), (lt, 1))
        buf_strip = np.full(lt, -1)     # strip whose bottom row a column holds

        def lane0_inputs(s0, c0):
            """Lane 0's load for its cell (s0, c0) of the next step."""
            if s0 < n and c0 < lt:
                assert buf_strip[c0] == s0 - 1, (s0, c0)
                return buf[c0].copy(), tc_all[c0]
            return np.zeros(4, np.int64), PAD   # not used

        nxt, nxt_t = lane0_inputs(0, 0)
        ps, pc = 0, 0
        for g in range(n * P + warp - 1):
            start = (c == 0) & (s < n)
            if start.any():
                fold(start & (s > 0), s - 1)
                i = (s * warp * R + lanes * R)[:, None] + np.arange(R)
                codes = np.where(i < lq, qc_all[np.minimum(i, lq - 1)], PAD)
                qc[start] = codes[start]
                for a in (hp, mlh, mle, bv, bml, bj):
                    a[start] = 0
                e[start] = NEG
                dh[start] = dml[start] = 0
            up[:, 0] = nxt
            tc[0] = nxt_t
            pc += 1
            if pc == P:
                pc, ps = 0, ps + 1
            nxt, nxt_t = lane0_inputs(ps, pc)
            act = (c >= 0) & (c < lt) & (s < n)
            out = np.zeros((4, warp), np.int64)
            out[1] = NEG
            if act.any():
                ah, af, aml, amlf = up.copy()
                gh, gml = dh.copy(), dml.copy()
                for r in range(R):
                    d = gh + sub[qc[:, r], tc]
                    mld = gml + np.where(qc[:, r] == tc, 0x10001, 1)
                    eo = hp[:, r] - go
                    ev = np.maximum(e[:, r] - ge, eo)
                    mle_v = np.where(ev == eo, mlh[:, r], mle[:, r]) + 1
                    fo = ah - go
                    fv = np.maximum(af - ge, fo)
                    mlf_v = np.where(fv == fo, aml, amlf) + 1
                    h = np.maximum(np.maximum(d, ev), np.maximum(fv, 0))
                    ml = np.where(h == d, mld, np.where(h == ev, mle_v, mlf_v))
                    ml = np.where(h > 0, ml, 0)
                    better = act & (h > bv[:, r])
                    bv[better, r] = h[better]
                    bml[better, r] = ml[better]
                    bj[better, r] = c[better]
                    gh = np.where(act, hp[:, r], gh)
                    gml = np.where(act, mlh[:, r], gml)
                    for a, v in ((hp, h), (e, ev), (mlh, ml), (mle, mle_v)):
                        a[act, r] = v[act]
                    ah, af, aml, amlf = h, fv, ml, mlf_v
                dh = np.where(act, up[0], dh)
                dml = np.where(act, up[2], dml)
                out = np.where(act, np.stack([ah, af, aml, amlf]), out)
                last = warp - 1
                if act[last] and s[last] + 1 < n:
                    buf[c[last]] = out[:, last]
                    buf_strip[c[last]] = s[last]
            # __shfl_up_sync: lane l takes lane l-1's values, lane 0 its own
            up = np.concatenate([out[:, :1], out[:, :-1]], axis=1)
            tc = np.concatenate([tc[:1], tc[:-1]])
            c = c + 1
            wrap = c == P
            c[wrap] = 0
            s[wrap] += 1
        fold(np.ones(warp, bool), np.full(warp, n - 1))
    key = bv_l * (1 << 32) + (0xFFFFFFFF - brow_l)
    w = int(np.argmax(key))
    return {"score": float(bv_l[w]), "matches": int(bml_l[w] >> 16),
            "length": int(bml_l[w] & 0xFFFF), "q_end": int(brow_l[w]),
            "t_end": int(bj_l[w])}


def _plain(q, t, sub, go, ge):
    got = sw_align_batch(torch.as_tensor(q), torch.as_tensor(t), sub, go, ge)
    return [{k: float(got[k][b]) for k in KEYS} for b in range(len(q))]


def _check(pairs, sub, go=11, ge=1, warp=sw.WARP, max_rows=sw.MAX_ROWS,
           embed=2, oracle=True):
    """Emulation == plain version == oracle on each pair, in its own
    bucket and embedded in one `embed` times larger; returns the
    emulation's outputs."""
    lq = max(len(a) for a, _ in pairs)
    lt = max(len(b) for _, b in pairs)
    outs = []
    for fq, ft in ((1, 1), (embed, embed)):
        q = np.full((len(pairs), fq * lq), PAD, np.int8)
        t = np.full((len(pairs), ft * lt), PAD, np.int8)
        for b, (x, y) in enumerate(pairs):
            q[b, :len(x)], t[b, :len(y)] = x, y
        plain = _plain(q, t, sub, go, ge)
        got = [{k: float(v) for k, v in emulate(q[b], t[b], sub, go, ge,
                                                 warp, max_rows).items()}
               for b in range(len(pairs))]
        assert got == plain
        outs.append(got)
    assert outs[0] == outs[1]
    if oracle:
        for (x, y), got in zip(pairs, outs[0]):
            want = sw_align_numpy(_clamp(x), _clamp(y), np.asarray(sub),
                                  go, ge)
            assert got == {k: float(want[k]) for k in KEYS}
    return outs[0]


# -- the layout and the kernel's interface ------------------------------------

def test_layout_matches_the_source():
    src = open(sw.SOURCE).read()
    for macro, value in (("WARP", sw.WARP), ("MAX_ROWS", sw.MAX_ROWS)):
        assert re.search(rf"#define {macro} {value}\b", src), macro
    for lq in range(1, 4097):
        n, rows = sw.strip_layout(lq)
        assert (n, rows) == layout(lq, sw.WARP, sw.MAX_ROWS)
        assert 1 <= rows <= sw.MAX_ROWS
        assert n * sw.WARP * rows >= lq > (n * sw.WARP * rows
                                           - n * sw.WARP)
    assert sw.strip_layout(256) == (1, 8)
    assert sw.strip_layout(257) == (2, 5)
    assert sw.strip_layout(4096) == (16, 8)


@pytest.mark.parametrize("where", ["row", "column"])
def test_wrapper_refuses_positive_pad_scores(where):
    m = sw.integer_sub(kernel_matrix())
    if where == "row":
        m[PAD, 3] = 1
    else:
        m[5, PAD] = 2
    q = torch.zeros((1, 8), dtype=torch.int8)
    sw.reset_launch_counts()
    with pytest.raises(ValueError, match="PAD"):
        sw.sw_align(q, q, m)
    assert sw.LAUNCHES == {"sw": 0}
    sw.check_pad_scores(sw.integer_sub(kernel_matrix()))
    sw.check_pad_scores(sw.integer_sub(nt_kernel_matrix()))


# -- the walk against the plain version and the oracle ------------------------

def test_planted_ties_across_strips_and_lanes(smoke):
    """Two top cells of 105 either side of the first strip boundary (or
    of a lane boundary), both orders, and twice in one row: the first
    row, then the first column, wins."""
    pairs = smoke.planted_tie_pairs()
    got = _check(pairs, kernel_matrix())
    for k, L in enumerate(smoke.TIE_LENGTHS):
        n, rows = sw.strip_layout(L)
        b = sw.WARP * rows if n > 1 else rows * (sw.WARP // 2)
        x_first, z_first, same_row = got[3 * k:3 * k + 3]
        assert x_first == dict(score=105, matches=10, length=10,
                               q_end=b - 1, t_end=56), L
        assert z_first == dict(score=105, matches=26, length=27,
                               q_end=b - 1, t_end=56), L
        assert same_row == dict(score=105, matches=10, length=10,
                                q_end=b - 1, t_end=14), L
    # the ties are real: without the winning motif the other cell holds
    # the same top score
    q, t = pairs[0]
    q = q.copy()
    q[q == smoke.TIE_X[0]] = smoke.TIE_QFILL
    assert emulate(q, t, kernel_matrix())["score"] == 105


@pytest.mark.parametrize("lq", [255, 256, 257])
def test_random_pairs_at_strip_lengths(lq):
    rng = np.random.default_rng(lq)
    pairs = []
    for _ in range(2):
        t = rng.integers(0, 20, size=90).astype(np.int8)
        q = rng.integers(0, 20, size=lq).astype(np.int8)
        at = int(rng.integers(0, lq - 60))
        q[at:at + 60] = t[20:80]
        mut = rng.random(lq) < 0.15
        q[mut] = rng.integers(0, 23, size=int(mut.sum()))
        pairs.append((q, t))
    _check(pairs, kernel_matrix(), oracle=False)


@pytest.mark.parametrize("gaps", [(0, 0), (0, 2), (4, 0), (11, 1), (5, 2)])
def test_small_warp_many_strips(gaps):
    """A warp of 4 lanes of at most 2 rows: queries of up to 40 rows take
    up to 5 strips, targets as short as 3 columns (P = 5 > lt)."""
    go, ge = gaps
    rng = np.random.default_rng(100 + go * 10 + ge)
    sub = kernel_matrix() if go != 5 else nt_kernel_matrix()
    hi = 20 if go != 5 else 4
    pairs = []
    for lq, lt in ((1, 1), (3, 40), (8, 8), (9, 3), (17, 30), (40, 25),
                   (33, 9), (24, 24)):
        t = rng.integers(0, hi, size=lt).astype(np.int8)
        q = rng.integers(0, hi, size=lq).astype(np.int8)
        if lq >= 6 and lt >= 6:
            n = min(lq, lt) // 2
            q[:n] = t[lt - n:]
        pairs.append((q, t))
    _check(pairs, sub, go, ge, warp=4, max_rows=2, embed=3)


def test_inner_pad_codes_and_empty_sequences():
    """A code outside 0..24 inside a sequence reads as PAD and is
    walked; an all-PAD side gives zeros."""
    rng = np.random.default_rng(5)
    t = rng.integers(0, 20, size=50).astype(np.int8)
    q = t[5:45].copy()
    q[10], q[20] = 24, -3
    t[30] = 99
    empty = np.full(12, PAD, np.int8)
    got = _check([(q, t), (empty, t), (q, empty)], kernel_matrix(),
                 warp=8, max_rows=2)
    assert got[0]["score"] > 100
    for g in got[1:]:
        assert g == dict(score=0, matches=0, length=0, q_end=0, t_end=0)


# -- the launches of chip_smoke.py's per-bucket table -------------------------

def test_bucket_table_cuts_launches_as_the_main_path(smoke, monkeypatch):
    """`sw_bucket_table` launches the kernel on the very batches that
    `_bucketed_sw` gives it (each bucket sorted by real cells, largest
    first, then cut), and counts pairs, launches and cells right.  On
    the CPU the plain version stands in for the kernel and a fixed time
    for the CUDA events."""
    from pepr_tpu_torch.models import homology
    from pepr_tpu_torch.utils.simulate import simulate_genomes

    ing, _, _ = simulate_genomes(np.random.default_rng(3), n_ingroup=3,
                                 n_families=12, n_random=2, median_len=140.0,
                                 max_len=300, n_long=1,
                                 long_lengths=(520, 600))
    cpu = torch.device("cpu")
    monkeypatch.setattr(homology, "CPU_BATCH_CELLS", 2 * 512)
    pairs_q, ulens, eff_q, eff_t, buckets, codes = smoke.stage1_pair_list(
        ing, cpu)
    sub = sw.integer_sub(kernel_matrix())
    seen = {"table": [], "main": []}

    def launch(key):
        def fn(q, t, s, *a, **k):
            seen[key].append((q.clone(), t.clone()))
            return sw_align_batch(q, t, s, *a, **k)
        return fn

    monkeypatch.setattr(sw, "sw_align", launch("table"))
    monkeypatch.setattr(smoke, "time_ms", lambda fn, reps: fn() and 2.0)
    table = smoke.sw_bucket_table(ulens, eff_q, eff_t, buckets, codes, sub,
                                  cpu, 1980.0)
    monkeypatch.setattr(homology, "sw_align_batch_fast", launch("main"))
    universe = homology.ProteinUniverse.build(ing)
    pq, pt = homology.candidate_union(universe, device=cpu)
    homology._bucketed_sw(universe, pq, pt, device="cpu")
    assert len(seen["table"]) == len(seen["main"]) == table["launches"]
    for (a, b), (c, d) in zip(seen["table"], seen["main"]):
        assert torch.equal(a, c) and torch.equal(b, d)
    rows = table["rows"]
    assert sum(r[2] for r in rows) == len(pairs_q)
    assert sum(r[4] for r in rows) == int((ulens[eff_q] * ulens[eff_t]).sum())
    for r, ((blq, blt), idx) in zip(rows, buckets.items()):
        step = homology.batch_pairs(blq, blt, cpu)
        assert r[:4] == [blq, blt, len(idx), -(-len(idx) // step)]
        assert r[5] == len(idx) * blq * blt and r[6] == 2.0 * r[3]
    assert max(r[3] for r in rows) >= 2  # some bucket takes two launches
