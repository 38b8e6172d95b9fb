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


def test_profile_score_pairs_refuses_what_is_not_ported(profiles):
    hmms, bases = profiles
    with pytest.raises(NotImplementedError, match="item 14"):
        hmm.profile_score_pairs(bases, hmms, [(0, 0)], store=object(),
                                device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        hmm.profile_score_pairs(bases, hmms, [(0, 0)], ckpt_key="k",
                                device="cpu")
    with pytest.raises(ValueError):
        hmm.profile_score_pairs(bases, hmms, [(0, 0)], algorithm="msv",
                                device="cpu")
    assert hmm.profile_score_pairs(bases, hmms, [], device="cpu").shape == \
        (0,)


# -- the kernel's walk, emulated ----------------------------------------

F32 = np.float32
NEG = F32(hmm.NEG)
# the kernel's logaddexp2: max + log1p(exp2(-|a - b|)) times
# float32(1 / ln 2), as jnp.logaddexp2 computes it
INV_LN2 = F32(1.0 / np.log(2.0))


def _op(a, b, forward):
    a, b = F32(a), F32(b)
    if forward:
        return F32(max(a, b) + INV_LN2 *
                   F32(np.log1p(np.exp2(F32(-abs(F32(a - b)))))))
    return max(a, b)


def emulate_kernel(seq, L, emit, tr, M, forward, W=32):
    """csrc/hmm.cu's walk of one pair in float32 numpy: lane l owns the
    columns [l C, l C + C), C = ceil(M / 32); per position the lanes
    compute vm', vi' and compose their columns' delete-chain maps, a
    Kogge-Stone scan over the lanes' maps gives each lane its chain
    input, and a second walk writes vd'; totals per lane (an online
    log-sum-exp2, or a max), combined at the end."""
    tmm, tmi, tmd, tim, tii, tdm, tdd = (tr[k] for k in hmm.TRANSITIONS)
    entry = F32(-np.log2(max(F32(M), F32(1))))
    C = (M + W - 1) // W
    k0 = [l * C for l in range(W)]
    n = [max(0, min(C, M - k)) for k in k0]
    vm = np.full(M, NEG, F32)
    vi, vd = vm.copy(), vm.copy()
    tot_m, tot_s = [NEG] * W, [F32(0)] * W
    for i in range(L):
        c = int(seq[i])
        emits = 0 <= c < 20
        last = [(vm[k0[l] + n[l] - 1], vi[k0[l] + n[l] - 1],
                 vd[k0[l] + n[l] - 1]) if n[l] else (NEG, NEG, NEG)
                for l in range(W)]
        new_vm, new_vi = vm.copy(), vi.copy()
        A, S, prev_new = [F32(0)] * W, [NEG] * W, [NEG] * W
        for l in range(W):
            pm, pi, pd = last[l - 1] if l else (NEG, NEG, NEG)
            for j in range(n[l]):
                k = k0[l] + j
                om, oi, od = vm[k], vi[k], vd[k]
                t = (NEG, NEG, NEG) if k == 0 else (tmm[k - 1], tim[k - 1],
                                                   tdm[k - 1])
                best = _op(_op(F32(pm + t[0]), F32(pi + t[1]), forward),
                           _op(F32(pd + t[2]), entry, forward), forward)
                nvm = F32((emit[c, k] if emits else F32(0)) + best)
                new_vm[k] = nvm
                new_vi[k] = _op(F32(om + tmi[k]), F32(oi + tii[k]), forward)
                if forward:
                    if nvm > tot_m[l]:
                        tot_s[l] = F32(tot_s[l] * np.exp2(F32(tot_m[l] - nvm))
                                       + F32(1))
                        tot_m[l] = nvm
                    else:
                        tot_s[l] = F32(tot_s[l] + np.exp2(F32(nvm - tot_m[l])))
                else:
                    tot_m[l] = max(tot_m[l], nvm)
                if j > 0:
                    S[l] = _op(F32(prev_new[l] + tmd[k - 1]),
                               F32(S[l] + tdd[k - 1]), forward)
                    A[l] = F32(A[l] + tdd[k - 1])
                prev_new[l] = nvm
                pm, pi, pd = om, oi, od
        before = [prev_new[0]] + prev_new[:-1]
        for l in range(W):
            if n[l]:
                a0, s0 = (NEG, NEG) if k0[l] == 0 else (
                    tdd[k0[l] - 1], F32(before[l] + tmd[k0[l] - 1]))
                S[l] = _op(S[l], F32(s0 + A[l]), forward)
                A[l] = F32(a0 + A[l])
        d = 1
        while d < W:
            A0, S0 = A[:], S[:]
            for l in range(d, W):
                S[l] = _op(S0[l], F32(S0[l - d] + A0[l]), forward)
                A[l] = F32(A0[l - d] + A0[l])
            d *= 2
        xin = [NEG] + S[:-1]
        vm, vi = new_vm, new_vi
        for l in range(W):
            x, pv = xin[l], before[l]
            for j in range(n[l]):
                k = k0[l] + j
                a, sk = (NEG, NEG) if k == 0 else (tdd[k - 1],
                                                   F32(pv + tmd[k - 1]))
                x = _op(sk, F32(x + a), forward)
                vd[k] = x
                pv = vm[k]
    if forward:
        m = max(tot_m)
        s = F32(sum(F32(ts * np.exp2(F32(tm - m)))
                    for ts, tm in zip(tot_s, tot_m)))
        return F32(m + np.log2(s)) if s > 0 else NEG
    return max(tot_m)


@pytest.mark.parametrize("forward", [True, False])
def test_kernel_walk_emulation_matches_plain(forward):
    """Profiles of 1, 20, 33, 64 and 97 columns (fewer columns than
    lanes, one a lane, ragged last lanes, idle lanes), sequences with X
    and PAD codes."""
    rng = np.random.default_rng(16)
    for M, L in ((1, 8), (20, 40), (33, 25), (64, 50), (97, 60)):
        aln, base = _msa(rng, M, n=5)
        h = hmm.build_profile_hmm(aln)
        emit, fields, ml = hmm.pack_profiles([h], 128)
        seq = np.concatenate([base[:L // 2], rng.integers(0, 25, L - L // 2)
                              ]).astype(np.int8)[:L]
        codes = np.full((1, 128), PAD, np.int8)
        codes[0, :len(seq)] = seq
        want = hmm.viterbi_score_batch(
            torch.as_tensor(codes), torch.tensor([len(seq)]),
            torch.as_tensor(emit),
            *[torch.as_tensor(fields[k]) for k in hmm.TRANSITIONS],
            torch.as_tensor(ml), forward=forward)
        got = emulate_kernel(seq, len(seq), emit[0],
                             {k: fields[k][0] for k in hmm.TRANSITIONS},
                             h.length, forward)
        _close([got], want.numpy())


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
    assert "pepr_tpu/ops/hmm.py:206 viterbi_segment" in src
    assert "atomic" not in src  # a pair's score depends only on the pair
    assert _cuda.lib_path("hmm").startswith(_cuda.BUILD_DIR)


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
    with pytest.raises(ValueError, match="CUDA"):
        hmm_kernel.hmm_score(*packs, si, hi, 2048, True)
    assert hmm_kernel.LAUNCHES == {"hmm": 0}



def test_smoke_launches_are_the_scorers(profiles, sequences, monkeypatch):
    """chip_smoke.py's per-bucket table (`hmm_bucket_table`, on the packs
    of `hmm_packs`) launches the kernel on the very chunks that
    profile_score_pairs gives it: the same packs, index vectors and
    lpad, launch for launch, in one order; its pairs and cells are the
    scorer's counts.  On the CPU a recorder stands in for the kernel and
    a fixed time for the CUDA events."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    hmms, _ = profiles
    rng = np.random.default_rng(17)
    # 4,100 pairs in the (128, 64) bucket: two launches of at most 4,096
    pairs = [(0, 0)] * 4100 + [(int(a), int(b)) for a, b in zip(
        rng.integers(0, len(sequences), 300), rng.integers(0, len(hmms), 300))]
    seen = {"table": [], "main": []}

    def record(key):
        def launch(codes, lens, emit, trans, m_lens, si, hi, lpad, forward):
            seen[key].append((emit, trans, m_lens, si, hi, lpad, forward))
            return torch.zeros(len(si))
        return launch

    monkeypatch.setattr(hmm_kernel, "hmm_score", record("table"))
    monkeypatch.setattr(smoke, "time_ms", lambda fn, reps, warmup=1:
                        (fn(), 2.0)[1])
    cpu = torch.device("cpu")
    rows = smoke.hmm_bucket_table(smoke.hmm_packs((sequences, hmms, pairs),
                                                  cpu), cpu, 1980.0)
    monkeypatch.setattr(hmm, "score_chunk", record("main"))
    counts: dict = {}
    hmm.profile_score_pairs(sequences, hmms, pairs, device="cpu",
                            counts=counts)
    assert len(seen["table"]) == len(seen["main"]) == sum(r[3] for r in rows)
    for a, b in zip(seen["table"], seen["main"]):
        assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
        assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
        assert torch.equal(a[3], b[3]) and torch.equal(a[4], b[4])
        assert a[5:] == b[5:]
    assert {f"{r[0]}x{r[1]}": r[2] for r in rows} == counts["pairs_by_bucket"]
    assert len(rows) >= 3 and max(r[3] for r in rows) == 2
    assert sum(r[4] for r in rows) == counts["real_cells"]
    assert sum(r[5] for r in rows) == counts["padded_cells"]
    assert all(r[6] == 2.0 * r[3] and r[7] > 0 for r in rows)

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
