"""The port's progressive MSA (ops/profile_align.py, models/msa.py)
against the JAX package's, on the CPU, inputs from seeded numpy.

The reference rounds profiles to bfloat16 before the DP
(`pepr_tpu/models/msa.py:201-202`); the port keeps float32.  So the
exact comparisons use profiles whose values are k/4, which both hold
exactly: the DP's scores and pointers bit for bit (BLOSUM62 and blastn
cores), and whole alignments of families of at most 3 sequences (merged
clusters of at most 2 rows) and of 8-sequence families merged by a
balanced guide (clusters of 1, 2 and 4 rows).  On 12-row families with
their k-mer UPGMA guides the agreement is stated: all 8 alignments were
identical and the SP scores equal when this test was written; it
asserts at least 6 of 8 and SP within 1% relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pepr_tpu.models import msa as jmsa
from pepr_tpu.ops import profile_align as jpa

from pepr_tpu_torch.alphabet import GAP
from pepr_tpu_torch.data.nt_scores import NT_GAP_EXTEND, NT_GAP_OPEN, nt_core
from pepr_tpu_torch.io.fasta import SequenceSet
from pepr_tpu_torch.models import msa as tmsa
from pepr_tpu_torch.ops import profile_align as tpa
from pepr_tpu_torch.utils.simulate import random_tree, simulate_alignment

torch.set_num_threads(2)


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


def with_deletions(row, rng):
    """0-3 seeded deletions of 1-8 residues."""
    for _ in range(int(rng.integers(0, 4))):
        n = int(rng.integers(1, 9))
        s = int(rng.integers(0, len(row) - n))
        row = np.concatenate([row[:s], row[s + n:]])
    return row


def families(rng, n_fam, n_seq, lo, hi, nt=False):
    out = []
    for _ in range(n_fam):
        tree = random_tree([f"t{i}" for i in range(n_seq)], rng, scale=0.15)
        codes, _ = simulate_alignment(tree, int(rng.integers(lo, hi)), rng,
                                      alpha=0.5)
        if nt:
            codes = (codes % 4).astype(np.int8)
        out.append([with_deletions(r, rng) for r in codes])
    return out


@pytest.mark.parametrize("core", ["blosum", "nt"])
@pytest.mark.parametrize("L1,L2", [(64, 64), (128, 64), (128, 256)])
def test_nw_profile_batch_bit_identical_on_dyadic_profiles(L1, L2, core):
    rng = np.random.default_rng(L1 * 7 + L2 + (core == "nt"))
    B = 6
    l1 = rng.integers(L1 // 2, L1, size=B).astype(np.int32)
    l2 = rng.integers(L2 // 2, L2, size=B).astype(np.int32)
    n_codes = 4 if core == "nt" else 20
    p1, p2 = dyadic(rng, B, L1, l1, n_codes), dyadic(rng, B, L2, l2, n_codes)
    kw = {}
    if core == "nt":
        kw = dict(gap_open=float(NT_GAP_OPEN), gap_extend=float(NT_GAP_EXTEND))
    cm = nt_core() if core == "nt" else tpa.blosum_core()
    s_j, p_j = jpa.nw_profile_batch(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(l1), jnp.asarray(l2),
        packed=False, core_matrix=jnp.asarray(cm), **kw)
    s_t, p_t = tpa.nw_profile_batch(
        torch.as_tensor(p1), torch.as_tensor(p2), torch.as_tensor(l1),
        torch.as_tensor(l2), core_matrix=torch.as_tensor(cm), **kw)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert p_t.dtype == torch.uint8 and p_t.shape == (B, L1 + L2 + 1, L1 + 1)
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))


def test_nw_score_matches_numpy_oracle_on_float_profiles():
    rng = np.random.default_rng(4)
    lens = [(17, 40), (39, 5), (60, 61)]
    P1 = np.zeros((3, 64, 20), np.float32)
    P2 = np.zeros((3, 64, 20), np.float32)
    want = []
    for b, (n1, n2) in enumerate(lens):
        p1 = rng.random((n1, 20)).astype(np.float32)
        p2 = rng.random((n2, 20)).astype(np.float32)
        p1 /= p1.sum(1, keepdims=True)
        p2 /= p2.sum(1, keepdims=True)
        P1[b, :n1], P2[b, :n2] = p1, p2
        want.append(tpa.nw_profile_numpy(p1.astype(np.float64),
                                         p2.astype(np.float64)))
        assert want[-1] == jpa.nw_profile_numpy(p1.astype(np.float64),
                                                p2.astype(np.float64))
    score, _ = tpa.nw_profile_batch(
        torch.as_tensor(P1), torch.as_tensor(P2),
        torch.tensor([n for n, _ in lens]), torch.tensor([n for _, n in lens]))
    np.testing.assert_allclose(score.numpy(), want, rtol=1e-4)


def test_traceback_moves_identical():
    rng = np.random.default_rng(5)
    B, L1, L2 = 8, 64, 128
    l1 = rng.integers(20, L1, size=B)
    l2 = rng.integers(20, L2, size=B)
    p1 = rng.random((B, L1, 20)).astype(np.float32)
    p2 = rng.random((B, L2, 20)).astype(np.float32)
    _, ptr = tpa.nw_profile_batch(torch.as_tensor(p1), torch.as_tensor(p2),
                                  torch.as_tensor(l1), torch.as_tensor(l2))
    ptr = ptr.numpy()
    for b in range(B):
        got = tpa.traceback(ptr[b], int(l1[b]), int(l2[b]))
        assert got == jpa.traceback(ptr[b], int(l1[b]), int(l2[b]))
        assert sum(m[0] for m in got) == l1[b]
        assert sum(m[1] for m in got) == l2[b]


def test_upgma_profile_merge_and_sp_score_identical():
    rng = np.random.default_rng(6)
    d = rng.random((9, 9))
    d = d + d.T
    np.fill_diagonal(d, 0)
    assert tmsa.upgma(d) == jmsa.upgma(d)
    mat = rng.integers(0, 25, size=(7, 50)).astype(np.int8)
    np.testing.assert_array_equal(tmsa._profile(mat), jmsa._profile(mat))
    assert tmsa._profile(mat).dtype == np.float32
    assert tmsa.sp_score(mat) == jmsa.sp_score(mat)
    assert tmsa.sp_score(mat % 4, nt_core()) == jmsa.sp_score(mat % 4,
                                                               nt_core())
    a = mat[:3, :40]
    b = mat[3:, :30]
    moves = [(1, 1)] * 25 + [(1, 0)] * 15 + [(0, 1)] * 5
    got = tmsa._merge(tmsa._Cluster([0, 1, 2], a), tmsa._Cluster([3, 4, 5, 6],
                                                                  b), moves)
    want = jmsa._merge(jmsa._Cluster([0, 1, 2], a),
                       jmsa._Cluster([3, 4, 5, 6], b), moves)
    assert got.rows == want.rows
    np.testing.assert_array_equal(got.mat, want.mat)


@pytest.fixture(scope="module")
def small_families():
    rng = np.random.default_rng(7)
    return families(rng, 10, 3, 40, 150) + families(rng, 5, 2, 40, 150) \
        + [[np.arange(20, dtype=np.int8)]]


def test_align_families_identical_on_families_of_at_most_3(small_families):
    want = jmsa.align_families(small_families)
    got = tmsa.align_families(small_families, device="cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for g, fam in zip(got, small_families):
        for row, seq in zip(g, fam):
            np.testing.assert_array_equal(row[row != GAP], seq)


def test_align_families_nt_core_identical():
    rng = np.random.default_rng(8)
    fams = families(rng, 6, 3, 60, 140, nt=True)
    kw = dict(core=nt_core(), gap_open=float(NT_GAP_OPEN),
              gap_extend=float(NT_GAP_EXTEND))
    want = jmsa.align_families(fams, **kw)
    got = tmsa.align_families(fams, device="cpu", **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_align_families_identical_under_balanced_guides():
    rng = np.random.default_rng(9)
    fams = families(rng, 5, 8, 40, 130)
    guide = [(0, 1), (2, 3), (4, 5), (6, 7), (8, 9), (10, 11), (12, 13)]
    want = jmsa.align_families(fams, guide_merges=[guide] * len(fams))
    got = tmsa.align_families(fams, guide_merges=[guide] * len(fams),
                              device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_refine_families_identical_on_3_row_families(small_families):
    mats = jmsa.align_families(small_families)
    want, n_want = jmsa.refine_families(mats, iters=2)
    got, n_got = tmsa.refine_families(mats, iters=2, device="cpu")
    assert n_got == n_want
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_align_agreement_on_12_row_families():
    rng = np.random.default_rng(10)
    fams = families(rng, 8, 12, 60, 150)
    want = jmsa.align_families(fams)
    got = tmsa.align_families(fams, device="cpu")
    same = sum(np.array_equal(g, w) for g, w in zip(got, want))
    rel = max(abs(tmsa.sp_score(g) - jmsa.sp_score(w)) / abs(jmsa.sp_score(w))
              for g, w in zip(got, want))
    assert same >= 6, same
    assert rel <= 0.01, rel


def test_align_tally_chunked_and_single_family_entry_points(small_families):
    tmsa.reset_align_counts()
    tpa.reset_graph_counts()
    got = tmsa.align_families_chunked(small_families, chunk=4, device="cpu")
    want = tmsa.align_families(small_families, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        tmsa.align_family(small_families[0], device="cpu"), want[0])
    sets = [SequenceSet(f"g{i}", [f"p{j} [T{j}]" for j in range(len(f))], f)
            for i, f in enumerate(small_families[:3])]
    alns = tmsa.align_sequence_sets(sets, device="cpu")
    for a, s, w in zip(alns, sets, want):
        assert (a.name, a.taxa, a.titles) == (s.name, s.taxa, s.titles)
        np.testing.assert_array_equal(a.mat, w)
    tally = dict(tmsa.ALIGN)
    assert tally["calls"] > 0 and tally["dp_steps"] > tally["calls"]
    assert tally["ptr_bytes"] > 0 and tally["host_seconds"] > 0
    assert tpa.GRAPHS["captured"] == 0  # no CUDA graph on the CPU
    tmsa.reset_align_counts()
    assert all(v == 0 for v in tmsa.ALIGN.values())


def test_plan_cache_evicts_least_recently_used_and_releases():
    cpu = torch.device("cpu")
    plans = {k: tpa._Plan(2, 64, L2, cpu) for k, L2 in
             (("a", 64), ("b", 128), ("c", 64))}
    size = plans["a"].nbytes
    assert plans["b"].nbytes > size == plans["c"].nbytes
    tpa.release_plans()
    tpa.reset_graph_counts()
    try:
        tpa._admit("a", plans["a"], 3 * size)
        tpa._admit("b", plans["b"], 3 * size)
        assert list(tpa._PLANS) == ["a", "b"]
        tpa._PLANS.move_to_end("a")  # a used after b
        # c fits only once the least recently used plan (b) is gone
        tpa._admit("c", plans["c"], 3 * size)
        assert list(tpa._PLANS) == ["a", "c"] and tpa.GRAPHS["evicted"] == 1
        # a budget below one plan keeps the newest alone
        tpa._admit("b", plans["b"], size)
        assert list(tpa._PLANS) == ["b"] and tpa.GRAPHS["evicted"] == 3
    finally:
        tpa.release_plans()
    assert not tpa._PLANS
    tpa.reset_graph_counts()
    assert all(v == 0 for v in tpa.GRAPHS.values())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_nw_profile_batch_card_equals_cpu(cuda_device):
    rng = np.random.default_rng(11)
    l1 = rng.integers(64, 128, size=16)
    l2 = rng.integers(128, 256, size=16)
    host = [torch.as_tensor(x) for x in (dyadic(rng, 16, 128, l1),
                                         dyadic(rng, 16, 256, l2), l1, l2)]
    s_c, p_c = tpa.nw_profile_batch(*host)
    for _ in range(2):  # capture, then replay
        s_g, p_g = tpa.nw_profile_batch(*(x.to(cuda_device) for x in host))
        assert torch.equal(s_g.cpu(), s_c) and torch.equal(p_g.cpu(), p_c)


@pytest.mark.cuda
def test_release_plans_gives_back_the_memory(cuda_device):
    rng = np.random.default_rng(12)
    tpa.release_plans()
    lens = rng.integers(32, 64, size=8)
    prof = torch.as_tensor(dyadic(rng, 8, 64, lens), device=cuda_device)
    n = torch.as_tensor(lens, device=cuda_device)
    tpa.nw_profile_batch(prof, prof, n, n)
    (plan,) = tpa._PLANS.values()
    buffers = plan.nbytes - plan.pool_bytes
    del plan
    allocated = torch.cuda.memory_allocated(cuda_device)
    tpa.release_plans()
    assert not tpa._PLANS
    assert allocated - torch.cuda.memory_allocated(cuda_device) >= buffers
