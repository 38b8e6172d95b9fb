"""The port's profile HMMs (pepr_tpu_torch.ops.hmm, ops/hmm_kernel,
csrc/hmm.cu) against the JAX package's `pepr_tpu/ops/hmm.py` on the CPU.

Tolerances: profile builds and packs bit-identical; plain scores within
1e-4 bits absolute + 1e-6 relative of JAX's (both float32 on the CPU;
sums in another order in the log-sum-exp2 reductions); the numpy
emulation of the kernel's warp walk within 1e-4 bits + 1e-6 relative of
the plain version (a lane-blocked delete chain and per-lane totals
against the Kogge-Stone doubling and per-row sums).  On a machine with a
CUDA card only (marker `cuda`), the kernel against its plain version
within chip_smoke.py's HMM_ATOL + HMM_RTOL."""

import ctypes
import functools
import importlib.util
import os
import pickle
import re

import numpy as np
import pytest
import torch

from test_torch_pruning_wrapper import C_TYPES, _c_signatures

from pepr_tpu.ops import hmm as jh

from pepr_tpu_torch.alphabet import GAP, PAD, X
from pepr_tpu_torch.ops import _cuda, hmm, hmm_kernel

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MSAS = os.path.join(ROOT, "conformance", "aqu_ckpt",
                    "hmm_group_alignments.pkl")
ATOL, RTOL = 1e-4, 1e-6
HMM_FIELDS = ("match_logodds", "log_tmm", "log_tmi", "log_tmd", "log_tim",
              "log_tii", "log_tdm", "log_tdd")


def _close(got, want, atol=ATOL, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _msa(rng, M: int, n: int = 6, rate: float = 0.25, gaps: float = 0.1):
    base = rng.integers(0, 20, size=M)
    aln = np.stack([np.where(rng.random(M) < rate,
                             rng.integers(0, 20, size=M), base)
                    for _ in range(n)]).astype(np.int8)
    aln[rng.random(aln.shape) < gaps] = GAP
    return aln, base.astype(np.int8)


@pytest.fixture(scope="module")
def profiles():
    """Profiles of 40-300 columns (built by the port; identical to the
    JAX builds, test below) and their consensus bases."""
    rng = np.random.default_rng(11)
    out = [_msa(rng, M) for M in (40, 63, 64, 65, 130, 300)]
    return [hmm.build_profile_hmm(a) for a, _ in out], [b for _, b in out]


@pytest.fixture(scope="module")
def sequences(profiles):
    """Sequences at and around the bucket edges (127-129, 511-513) and
    crossing the 512-position segment boundary, with X and PAD codes
    inside, some carrying a profile's consensus."""
    rng = np.random.default_rng(12)
    _, bases = profiles
    seqs = []
    for i, L in enumerate((20, 127, 128, 129, 300, 511, 512, 513, 640)):
        s = rng.integers(0, 20, size=L).astype(np.int8)
        b = bases[i % len(bases)]
        start = int(rng.integers(0, max(1, L - len(b))))
        s[start:start + len(b)] = b[:L - start]
        s[rng.random(L) < 0.03] = X
        if i % 3 == 0:
            s[rng.integers(0, L)] = PAD
        seqs.append(s)
    return seqs


# -- builds -------------------------------------------------------------

def test_builds_and_packs_bit_identical_on_real_msas():
    """Every MSA of conformance/aqu_ckpt/hmm_group_alignments.pkl (2,154
    real Aquificales group alignments): profiles and packs identical."""
    with open(MSAS, "rb") as fh:
        msas = pickle.load(fh)
    assert len(msas) == 2154
    got = [hmm.build_profile_hmm(m, name=str(i)) for i, m in enumerate(msas)]
    want = [jh.build_profile_hmm(m, name=str(i)) for i, m in enumerate(msas)]
    for g, w in zip(got, want):
        assert g.name == w.name and g.length == w.length
        for f in HMM_FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    for sel in (slice(0, 300), slice(1000, 1400)):
        for length in (None, 256):
            e_t, f_t, m_t = hmm.pack_profiles(got[sel], length)
            e_j, f_j, m_j = jh.pack_profiles(want[sel], length)
            assert np.array_equal(e_t, e_j) and np.array_equal(m_t, m_j)
            assert f_t.keys() == f_j.keys()
            for k in f_t:
                assert np.array_equal(f_t[k], f_j[k]), k


def test_builds_with_gaps_and_options(profiles):
    rng = np.random.default_rng(13)
    for M, gaps in ((50, 0.6), (80, 0.0), (30, 0.3)):
        aln, _ = _msa(rng, M, gaps=gaps)
        aln[:, 5] = PAD
        for kw in ({}, {"entropy_target": None}, {"pseudo": 0.5}):
            g = hmm.build_profile_hmm(aln, **kw)
            w = jh.build_profile_hmm(aln, **kw)
            for f in HMM_FIELDS:
                assert np.array_equal(getattr(g, f), getattr(w, f)), (M, kw)


# -- the plain DP against JAX's scan -------------------------------------

@pytest.mark.parametrize("forward", [True, False])
def test_plain_scores_match_jax(profiles, sequences, forward):
    """viterbi_score_batch on every (sequence, profile) pair of the
    fixtures at one padded shape (640 positions, two segments of 512;
    profiles packed to 512)."""
    hmms, _ = profiles
    codes, lens = hmm.pack_sequences(sequences)
    codes = codes[:, :640]
    emit, fields, ml = hmm.pack_profiles(hmms, 512)
    si, hi = np.meshgrid(np.arange(len(sequences)), np.arange(len(hmms)),
                         indexing="ij")
    si, hi = si.ravel(), hi.ravel()
    args = [codes[si], lens[si], emit[hi]] + \
        [fields[k][hi] for k in hmm.TRANSITIONS] + [ml[hi]]
    got = hmm.viterbi_score_batch(*[torch.as_tensor(a) for a in args],
                                  forward=forward)
    want = jh.viterbi_score_batch(*args, forward=forward)
    _close(got.numpy(), np.asarray(want))
    # the segment size changes nothing
    again = hmm.viterbi_score_batch(*[torch.as_tensor(a) for a in args],
                                    segment=200, forward=forward)
    assert torch.equal(again, got)


def test_profile_score_pairs_matches_jax(profiles, sequences):
    """A seeded pair list over the (lpad, mpad) buckets (128, 64),
    (128, 256), (512, 64) and (512, 256), Forward with the null
    correction and Viterbi without."""
    hmms = [h for h in profiles[0] if h.length <= 256]
    seqs = [s for s in sequences if len(s) <= 512]
    rng = np.random.default_rng(14)
    pairs = [(int(a), int(b)) for a, b in zip(
        rng.integers(0, len(seqs), 40), rng.integers(0, len(hmms), 40))]
    pairs += [(len(seqs) - 1, len(hmms) - 1), (0, 0)]
    counts: dict = {}
    for alg, null in (("forward", 0.22), ("viterbi", 0.0)):
        got = hmm.profile_score_pairs(seqs, hmms, pairs, algorithm=alg,
                                      null_per_col=null, device="cpu",
                                      counts=counts, batch_size=16)
        want = jh.profile_score_pairs(seqs, hmms, pairs, algorithm=alg,
                                      null_per_col=null, batch_size=16)
        assert got.dtype == np.float32 and got.shape == (len(pairs),)
        _close(got, want)
    buckets = counts["pairs_by_bucket"]
    assert set(buckets) == {"128x64", "128x256", "512x64", "512x256"}
    assert sum(buckets.values()) == len(pairs)
    assert 0 < counts["real_cells"] < counts["padded_cells"]


def test_long_sequence_is_cut_at_4096():
    """A sequence longer than the largest bucket is scored on its first
    4,096 residues, as the reference cuts it."""
    rng = np.random.default_rng(15)
    aln, base = _msa(rng, 40)
    h = hmm.build_profile_hmm(aln)
    long_seq = np.concatenate([rng.integers(0, 20, 4100).astype(np.int8),
                               base])
    cut = long_seq[:4096]
    got = hmm.profile_score_pairs([long_seq, cut], [h], [(0, 0), (1, 0)],
                                  device="cpu", algorithm="viterbi")
    assert got[0] == got[1]
    assert hmm.p4(5000, hmm.SEQ_BUCKET0) == hmm.MAX_BUCKET == 4096
    assert [hmm.p4(n, 128) for n in (1, 128, 129, 512, 513)] == \
        [128, 128, 512, 512, 2048]
    assert [hmm.eff_batch(4096, lp, mp) for lp, mp in
            ((128, 64), (512, 1024), (4096, 4096))] == [4096, 4096, 512]


def test_buckets_of_arrays_match_p4():
    """`p4_all` is `p4` element by element, and `pair_buckets` keeps each
    bucket's pairs in pair order."""
    x = np.arange(0, 9000, 7)
    for lo in (hmm.SEQ_BUCKET0, hmm.HMM_BUCKET0):
        assert hmm.p4_all(x, lo).tolist() == [hmm.p4(int(v), lo) for v in x]
    rng = np.random.default_rng(19)
    seq_lens, hmm_lens = rng.integers(1, 5000, 50), rng.integers(1, 5000, 9)
    pairs = list(zip(rng.integers(0, 50, 400), rng.integers(0, 9, 400)))
    want: dict = {}
    for k, (si, hi) in enumerate(pairs):
        want.setdefault((hmm.p4(int(seq_lens[si]), hmm.SEQ_BUCKET0),
                         hmm.p4(int(hmm_lens[hi]), hmm.HMM_BUCKET0)),
                        []).append(k)
    got = hmm.pair_buckets(seq_lens, hmm_lens, pairs)
    assert {k: v.tolist() for k, v in got.items()} == want


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_profile_score_pairs_resumes_from_a_store(profiles, sequences,
                                                  tmp_path, monkeypatch):
    """With a store and `ckpt_key`, a call stopped before its n-th launch
    (chip_smoke.py's countdown) under the card's plan (one launch a
    pack; the plain version scores it on the CPU) and resumed under the
    reference buckets, and the other way round, gives one call's bits
    exactly: the store's progress is a mask over the pairs, whatever
    plan wrote it.  Unknown algorithms still raise, and no pairs give no
    bits."""
    from pepr_tpu_torch.pipeline.checkpoint import (CheckpointStore,
                                                    Incomplete)
    smoke = _smoke()
    hmms = [h for h in profiles[0] if h.length <= 256]
    seqs = [s for s in sequences if len(s) <= 512]
    rng = np.random.default_rng(14)
    pairs = [(int(a), int(b)) for a, b in zip(
        rng.integers(0, len(seqs), 40), rng.integers(0, len(hmms), 40))]
    kw = dict(device="cpu", batch_size=16)
    one = hmm.profile_score_pairs(seqs, hmms, pairs, **kw)
    stopped = 0
    for first, then in ((True, False), (False, True)):
        for n in range(1, 16):
            store = CheckpointStore(str(tmp_path / f"{first}_{n}"))
            monkeypatch.setattr(hmm, "card_plan", lambda dev: first)
            try:
                hmm.profile_score_pairs(seqs, hmms, pairs, store=store,
                                        deadline=smoke.Countdown(n),
                                        ckpt_key="hmm_viterbi", **kw)
                break  # n - 1 launches are all the plan has
            except Incomplete as e:
                assert e.stage == "profile HMM scoring"
                stopped += 1
            done = store.load("hmm_viterbi")["done"]
            assert done.dtype == bool and done.sum() < len(pairs)
            monkeypatch.setattr(hmm, "card_plan", lambda dev: then)
            got = hmm.profile_score_pairs(seqs, hmms, pairs, store=store,
                                          ckpt_key="hmm_viterbi", **kw)
            assert np.array_equal(got, one)
            assert store.load("hmm_viterbi")["done"].all()
    assert stopped >= 2 + 4  # two packs; four buckets of up to 16 pairs
    with pytest.raises(ValueError):
        hmm.profile_score_pairs(seqs, hmms, [(0, 0)], algorithm="msv",
                                device="cpu")
    assert hmm.profile_score_pairs(seqs, hmms, [], device="cpu").shape == \
        (0,)


# -- the kernel's walk, emulated ----------------------------------------

F32 = np.float32
NEG = F32(hmm.NEG)
WARP = 32


def _op2(a, b, forward):
    """csrc/hmm.cu's op2 on float32 arrays: max + lg2(1 + ex2(-|a - b|))
    (the card's ex2/lg2 are approximate; numpy's float32 exp2/log2 stand
    in for them)."""
    if not forward:
        return np.maximum(a, b)
    return np.maximum(a, b) + np.log2(F32(1) + np.exp2(-np.abs(a - b)))


def _op4(a, b, c, d, forward):
    """The match state's op(op(a, b), op(c, d)), as the reference and the
    kernel take it."""
    return _op2(_op2(a, b, forward), _op2(c, d, forward), forward)


def _scan(A, S, forward):
    """Inclusive Kogge-Stone scan of maps (A, S) over the last axis, as
    the kernel's shuffles compose them."""
    A, S = A.copy(), S.copy()
    d = 1
    while d < A.shape[-1]:
        A0, S0 = A.copy(), S.copy()
        S[..., d:] = _op2(S0[..., d:], S0[..., :-d] + A0[..., d:], forward)
        A[..., d:] = A0[..., d:] + A0[..., :-d]
        d *= 2
    return A, S


def emulate_walk(seq, L, rec, em, M, T, forward):
    """csrc/hmm.cu's walk of one pair in float32 numpy, vectorised over
    the group's T threads, read from the profile's walk pack (rec
    (slots, 8), em (21, slots)): thread t owns columns [t ce, t ce + ce);
    per position each thread walks vm', vi', its total and the delete
    chain with nothing entering, the threads' maps are scanned (by warps,
    then over the warps' maps), and vd' = op(S_{j-1}, x_in + A_{j-1});
    totals per thread, combined by warp (a max, a shuffle-down sum) and
    then over warps in order."""
    W = T // WARP
    ce = -(-M // T)
    t = np.arange(T)
    n = np.clip(M - t * ce, 0, ce)
    entry = F32(-np.log2(max(F32(M), F32(1))))
    slot = [j * T + t for j in range(ce)]
    Ap = np.zeros((ce, T), F32)
    a_sum = np.zeros(T, F32)
    for j in range(ce):
        a_sum = np.where(j < n, a_sum + rec[slot[j], 6], a_sum)
        Ap[j] = a_sum
    vm = np.full((ce, T), NEG, F32)
    vi, vd = vm.copy(), vm.copy()
    last = np.full((3, T), NEG, F32)
    tot_m, tot_s = np.full(T, NEG, F32), np.zeros(T, F32)
    for i in range(L):
        c = int(seq[i])
        row = c if 0 <= c < 20 else 20
        pm, pi, pd = (np.concatenate([[NEG], x[:-1]]).astype(F32)
                      for x in last)
        S = np.full(T, NEG, F32)
        nm, ni = S.copy(), S.copy()
        for j in range(ce):
            on = j < n
            q, e = rec[slot[j]], em[row, slot[j]]
            om, oi, od = vm[j].copy(), vi[j].copy(), vd[j].copy()
            m_ = e + _op4(pm + q[:, 0], pi + q[:, 1], pd + q[:, 2], entry,
                          forward)
            i_ = _op2(om + q[:, 3], oi + q[:, 4], forward)
            if forward:
                d = m_ - tot_m
                x = np.exp2(-np.abs(d))
                tot_s = np.where(on, np.where(d > 0, tot_s * x + F32(1),
                                              tot_s + x), tot_s)
            tot_m = np.where(on, np.maximum(tot_m, m_), tot_m)
            vd[j] = np.where(on, S, od)
            S = np.where(on, _op2(m_ + q[:, 5], S + q[:, 6], forward), S)
            vm[j], vi[j] = np.where(on, m_, om), np.where(on, i_, oi)
            nm, ni = np.where(on, m_, nm), np.where(on, i_, ni)
            pm, pi, pd = (np.where(on, o, p) for o, p in ((om, pm), (oi, pi),
                                                           (od, pd)))
        A, Sw = _scan(a_sum.reshape(W, WARP), S.reshape(W, WARP), forward)
        xs = np.concatenate([np.full((W, 1), NEG, F32), Sw[:, :-1]], 1)
        xa = np.concatenate([np.zeros((W, 1), F32), A[:, :-1]], 1)
        _, ws = _scan(A[:, -1], Sw[:, -1], forward)
        before = np.concatenate([[NEG], ws[:-1]]).astype(F32)
        x_in = np.where(np.arange(W)[:, None] > 0,
                        _op2(xs, before[:, None] + xa, forward), xs).ravel()
        lv = x_in.copy()
        for j in range(ce):
            on = j < n
            v = x_in if j == 0 else _op2(vd[j], x_in + Ap[j - 1], forward)
            vd[j] = np.where(on, v, vd[j])
            lv = np.where(on, v, lv)
        last = np.stack([nm, ni, lv])
    m = tot_m.reshape(W, WARP).max(1)
    if not forward:
        return F32(m.max())
    s = (tot_s * np.exp2(tot_m - np.repeat(m, WARP))).reshape(W, WARP)
    for d in (16, 8, 4, 2, 1):
        s[:, :WARP - d] = s[:, :WARP - d] + s[:, d:]
    mm, ss = F32(m.max()), F32(0)
    for w in range(W):
        ss = F32(ss + s[w, 0] * np.exp2(F32(m[w] - mm)))
    return F32(mm + np.log2(ss)) if ss > 0 else NEG


def _emulated_against_plain(rng, M, L, T, forward, mpad, gaps=0.1):
    """A profile built from a seeded M-column MSA (M match states when
    `gaps` is 0), a sequence half its consensus: the emulated walk of T
    threads against the plain version."""
    aln, base = _msa(rng, M, n=5, gaps=gaps)
    h = hmm.build_profile_hmm(aln)
    M = h.length
    emit, fields, ml = hmm.pack_profiles([h], mpad)
    seq = np.concatenate([base[:L // 2], rng.integers(0, 25, L - L // 2)
                          ]).astype(np.int8)[:L]
    codes = np.full((1, 128), PAD, np.int8)
    codes[0, :len(seq)] = seq
    trans = [torch.as_tensor(fields[k]) for k in hmm.TRANSITIONS]
    want = hmm.viterbi_score_batch(
        torch.as_tensor(codes), torch.tensor([len(seq)]),
        torch.as_tensor(emit), *trans, torch.as_tensor(ml), forward=forward)
    walk = hmm_kernel.walk_pack(torch.as_tensor(emit), trans,
                                torch.as_tensor(ml), threads=T)
    got = emulate_walk(seq, len(seq), walk.rec[0].numpy(),
                       walk.emit[0].numpy(), M, T, forward)
    _close([got], want.numpy())


@pytest.mark.parametrize("forward", [True, False])
def test_kernel_walk_emulation_matches_plain(forward):
    """The warp's walk (32 threads a pair) on profiles of 1, 20, 33, 64
    and 97 columns (fewer columns than lanes, one a lane, ragged last
    lanes, idle lanes), sequences with X and PAD codes."""
    rng = np.random.default_rng(16)
    for M, L in ((1, 8), (20, 40), (33, 25), (64, 50), (97, 60)):
        _emulated_against_plain(rng, M, L, 32, forward, 128)


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("T,M", [(32, 31), (32, 32), (32, 33), (32, 127),
                                 (32, 128), (32, 129), (128, 127),
                                 (128, 128), (128, 129), (128, 1025),
                                 (256, 1025), (64, 129), (512, 1025),
                                 (512, 4096)])
def test_walk_emulation_at_boundaries(T, M, forward):
    """The warp's and the block's walks at and around lane and warp
    boundaries (M of 31-33 and 127-129 columns, so ce and the idle
    threads change there), at the smallest profile of the widest pack
    (1,025 columns) and at its full width on the widest pack's 512
    threads, within 1e-4 bits + 1e-6 relative of the plain version."""
    mpad = hmm.p4(M, hmm.HMM_BUCKET0)
    rng = np.random.default_rng(1000 + M + T)
    _emulated_against_plain(rng, M, 12 if M > 500 else 30, T, forward, mpad,
                            gaps=0.0)


@pytest.mark.parametrize("T", [32, 64, 128, 256])
def test_walk_pack_gathers_back_to_the_pack(profiles, T):
    """Every (h, k) of a pack sits in exactly one slot of its walk pack,
    slot j T + t for k = t ce + j, with the shifted and unshifted
    transitions of column k (0 for the shifted ones at k = 0), its
    emissions and a zero row; every other slot is zero."""
    hmms, _ = profiles
    mpad = 512 if T < 128 else 1024
    emit, fields, ml = hmm.pack_profiles(hmms, mpad)
    trans = [torch.as_tensor(fields[k]) for k in hmm.TRANSITIONS]
    walk = hmm_kernel.walk_pack(torch.as_tensor(emit), trans,
                                torch.as_tensor(ml), threads=T)
    slots = T * -(-mpad // T)
    assert walk.rec.shape == (len(hmms), slots, 8) and walk.threads == T
    assert walk.emit.shape == (len(hmms), 21, slots)
    f = {k: fields[k] for k in hmm.TRANSITIONS}
    rec, em = walk.rec.numpy(), walk.emit.numpy()
    for h, M in enumerate(ml):
        ce = -(-int(M) // T)
        used = np.zeros(slots, bool)
        for k in range(M):
            sl = (k % ce) * T + k // ce
            assert not used[sl]
            used[sl] = True
            prev = [f[x][h, k - 1] if k else 0.0 for x in ("tmm", "tim",
                                                            "tdm")]
            here = [f[x][h, k] for x in ("tmi", "tii", "tmd", "tdd")]
            assert np.array_equal(rec[h, sl], np.array(prev + here + [0.0],
                                                       np.float32))
            assert np.array_equal(em[h, :20, sl], emit[h, :, k])
        assert not em[h, 20].any()
        assert not rec[h, ~used].any() and not em[h, :, ~used].any()


# -- the wrapper ----------------------------------------------------------

def test_launcher_matches_declared_argtypes():
    sigs = _c_signatures(hmm_kernel.SOURCE)
    assert set(sigs) == set(hmm_kernel.ARGTYPES)
    for name, (ret, types) in sigs.items():
        assert [C_TYPES[t] for t in types] == hmm_kernel.ARGTYPES[name], name
    assert sigs["hmm_launch"][0] == "int"  # returns cudaGetLastError()
    assert hmm_kernel.RESTYPES["hmm_launch"] is ctypes.c_int
    src = open(hmm_kernel.SOURCE).read()
    assert "hmm" in _cuda.SOURCES and "torch/extension.h" not in src
    assert f"#define MAX_MPAD {hmm_kernel.MAX_MPAD}" in src
    assert f"#define EMIT_ROWS {hmm_kernel.EMIT_ROWS}" in src
    assert "pepr_tpu/ops/hmm.py:206 viterbi_segment" in src
    assert "atomic" not in src  # a pair's score depends only on the pair
    assert _cuda.lib_path("hmm").startswith(_cuda.BUILD_DIR)
    # every pack width the scorer makes has a kernel for its threads
    block = src[src.index("#define HMM_CONFIGS(X)"):]
    block = block[:block.index("static constexpr")]
    configs = [tuple(map(int, m)) for m in
               re.findall(r"X\((\d+), (\d+), (\d+)\)", block)]
    assert len(configs) >= 4
    for mpad in (64, 256, 1024, 4096, 512, 2048):
        threads = hmm_kernel.threads_for(mpad)
        assert any(t == threads and c * t >= mpad for t, c, _ in configs)


def _packs(profiles, sequences, dev="cpu"):
    hmms, _ = profiles
    codes, lens = hmm.pack_sequences(sequences)
    emit, fields, ml = hmm.pack_profiles(hmms, 512)
    t = functools.partial(torch.as_tensor, device=dev)
    return (t(codes), t(lens), t(emit), [t(fields[k]) for k in
                                         hmm.TRANSITIONS], t(ml))


def test_cpu_route_takes_the_plain_version(profiles, sequences, monkeypatch):
    """On CPU tensors score_chunk runs the plain version and never the
    kernel; the wrapper refuses CPU tensors."""
    packs = _packs(profiles, sequences)
    si = torch.tensor([0, 4, 8], dtype=torch.int32)
    hi = torch.tensor([1, 2, 5], dtype=torch.int32)

    def no_kernel(*a, **k):
        raise AssertionError("the kernel route was taken on the CPU")

    monkeypatch.setattr(hmm_kernel, "hmm_score", no_kernel)
    got = hmm.score_chunk(*packs, si, hi, 2048, True)
    c, l_, e, tr, m = hmm.gather_pairs(*packs, si, hi, 2048, 512)
    assert torch.equal(got, hmm.viterbi_score_batch(c, l_, e, *tr, m,
                                                    forward=True))
    monkeypatch.undo()
    hmm_kernel.reset_launch_counts()
    walk = hmm_kernel.walk_pack(*packs[2:])
    with pytest.raises(ValueError, match="CUDA"):
        hmm_kernel.hmm_score(*packs[:2], walk, si, hi, 2048, True)
    assert hmm_kernel.LAUNCHES == {"hmm": 0}


def _pairs(n_seqs, n_hmms, seed, n=40):
    rng = np.random.default_rng(seed)
    pairs = [(int(a), int(b)) for a, b in zip(rng.integers(0, n_seqs, n),
                                              rng.integers(0, n_hmms, n))]
    return pairs + [pairs[0], (n_seqs - 1, n_hmms - 1)]


@pytest.mark.parametrize("forward", [True, False])
def test_card_plan_scores_each_pair_once_as_the_buckets(profiles, sequences,
                                                        forward):
    """The card's plan (`card_score_plan` at the sequence pack's width): one
    launch a pack, lpad at the cap, every pair exactly once, longest
    first; scoring it with the plain version on the CPU gives exactly the
    reference buckets' scores (lpad enters only as the cap on L)."""
    hmms, _ = profiles
    pairs = _pairs(len(sequences), len(hmms), 18)
    codes, lens = hmm.pack_sequences(sequences)
    hmm_lens = np.array([h.length for h in hmms])
    plan = hmm.card_score_plan(lens, hmm_lens, pairs, codes.shape[1])
    ref = hmm.score_plan(lens, hmm_lens, pairs)
    assert [(m, ms) for m, ms, _ in plan] == [(m, ms) for m, ms, _ in ref]
    got = np.full(len(pairs), np.nan, np.float32)
    seen = []
    for mpad, members, buckets in plan:
        assert len(buckets) == 1 and len(buckets[0].launches()) == 1
        b = buckets[0]
        assert b.lpad == min(hmm.MAX_BUCKET, codes.shape[1])
        cells = [b.real_cells(lens, hmm_lens[members], slice(i, i + 1))
                 for i in range(len(b.pairs))]
        keys = [(-c, int(k)) for c, k in zip(cells, b.pairs)]
        assert keys == sorted(keys)  # longest first, ties in list order
        seen += list(b.pairs)
        pack, _ = hmm.device_pack([hmms[i] for i in members], mpad, "cpu")
        got[b.pairs] = hmm.score_chunk(
            torch.as_tensor(codes), torch.as_tensor(lens), *pack,
            torch.as_tensor(b.seq_idx), torch.as_tensor(b.hmm_idx), b.lpad,
            forward).numpy()
    assert sorted(seen) == list(range(len(pairs)))
    want = hmm.profile_score_pairs(sequences, hmms, pairs, device="cpu",
                                   null_per_col=0.0, algorithm="forward"
                                   if forward else "viterbi")
    assert np.array_equal(got, want)


def test_card_branch_plans_the_reference_buckets_only_for_counts(
        profiles, sequences, monkeypatch):
    """On the card profile_score_pairs launches the card plan alone; it
    cuts the reference's buckets only when `counts` asks for them."""
    hmms, _ = profiles
    pairs = _pairs(len(sequences), len(hmms), 19)
    ref_plan = hmm.score_plan
    made = []

    def score_plan(*a, **k):
        made.append(1)
        return ref_plan(*a, **k)

    def chunk(codes, lens, emit, trans, m_lens, si, hi, lpad, forward,
              walk=None):
        return torch.zeros(len(si))

    monkeypatch.setattr(hmm, "score_plan", score_plan)
    monkeypatch.setattr(hmm, "score_chunk", chunk)
    monkeypatch.setattr(hmm, "card_plan", lambda dev: True)
    hmm.profile_score_pairs(sequences, hmms, pairs, device="cpu")
    assert not made
    counts: dict = {}
    hmm.profile_score_pairs(sequences, hmms, pairs, device="cpu",
                            counts=counts)
    assert made == [1]
    assert sum(counts["pairs_by_bucket"].values()) == len(pairs)


def test_smoke_launches_are_the_scorers(profiles, sequences, monkeypatch):
    """chip_smoke.py's per-launch table (`hmm_launch_table`, on the packs
    of `hmm_packs`) launches the kernel on the very launches that
    profile_score_pairs makes on the card (its card branch, taken here on
    the CPU with a recorder standing in for the kernel): the same walk
    packs, index vectors and lpad, launch for launch, in one order, one a
    pack, every pair once; its cells are the scorer's counts, which are
    the reference buckets'.  A fixed time stands in for the CUDA
    events."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    hmms, _ = profiles
    rng = np.random.default_rng(17)
    # 4,100 pairs in the (128, 64) bucket: two reference launches
    pairs = [(0, 0)] * 4100 + [(int(a), int(b)) for a, b in zip(
        rng.integers(0, len(sequences), 300), rng.integers(0, len(hmms), 300))]
    seen = {"table": [], "main": []}

    def launch(codes, lens, walk, si, hi, lpad, forward):
        seen["table"].append((walk, si, hi, lpad, forward))
        return torch.zeros(len(si))

    def chunk(codes, lens, emit, trans, m_lens, si, hi, lpad, forward,
              walk=None):
        seen["main"].append((walk, si, hi, lpad, forward))
        return torch.zeros(len(si))

    monkeypatch.setattr(hmm_kernel, "hmm_score", launch)
    monkeypatch.setattr(smoke, "timed", lambda fn: (fn(), 2.0))
    cpu = torch.device("cpu")
    p = smoke.hmm_packs((sequences, hmms, pairs), cpu)
    rows, _ = smoke.hmm_launch_table(p, cpu, 1980.0)
    monkeypatch.setattr(hmm, "score_chunk", chunk)
    monkeypatch.setattr(hmm, "card_plan", lambda dev: True)
    counts: dict = {}
    hmm.profile_score_pairs(sequences, hmms, pairs, device="cpu",
                            counts=counts)
    assert len(seen["table"]) == len(seen["main"]) == len(rows) == len(
        p["packs"]) == smoke.hmm_card_launches((sequences, hmms, pairs))
    for a, b in zip(seen["table"], seen["main"]):
        assert torch.equal(a[0].rec, b[0].rec) and torch.equal(a[0].emit,
                                                               b[0].emit)
        assert a[0].threads == b[0].threads and a[0].mpad == b[0].mpad
        assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
        assert a[3:] == b[3:]
    assert sum(r[2] for r in rows) == len(pairs)
    assert [r[0] for r in rows] == sorted(p["packs"])
    assert len(counts["pairs_by_bucket"]) >= 3
    assert sum(counts["pairs_by_bucket"].values()) == len(pairs)
    assert sum(r[3] for r in rows) == counts["real_cells"]
    assert all(r[5] == 2.0 and r[6] > 0 for r in rows)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("forward", [True, False])
def test_kernel_matches_plain_version_on_card(profiles, sequences,
                                              cuda_device, forward):
    packs = _packs(profiles, sequences, cuda_device)
    n_s, n_h = len(sequences), len(profiles[0])
    si = torch.arange(n_s, dtype=torch.int32,
                      device=cuda_device).repeat_interleave(n_h)
    hi = torch.arange(n_h, dtype=torch.int32, device=cuda_device).repeat(n_s)
    hmm_kernel.reset_launch_counts()
    got = hmm.score_chunk(*packs, si, hi, 1024, forward)
    assert hmm_kernel.LAUNCHES == {"hmm": 1}
    c, l_, e, tr, m = hmm.gather_pairs(*packs, si, hi, 1024, 512)
    want = hmm.viterbi_score_batch(c, l_, e, *tr, m, forward=forward)
    d = (got - want).abs()
    assert bool((d <= 1e-3 + 1e-5 * want.abs()).all()), float(d.max())
    perm = torch.randperm(len(si), device=cuda_device)
    again = hmm.score_chunk(*packs, si[perm].contiguous(),
                            hi[perm].contiguous(), 1024, forward)
    assert torch.equal(again, got[perm])
