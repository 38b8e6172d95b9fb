"""The port's HMM set enhancement (pepr_tpu_torch.models.hmm_enhancer)
against the JAX package on the CPU (stage 1 with use_hmm=True:
tests/test_torch_homology.py).

Tolerances: consensus keys, enhanced groups (titles in order) and
selected outgroups identical; prefilter pairs identical but for ties
broken by float rounding (below); the pool genomes' score sums
within 1e-3 bits absolute + 1e-6 relative (sums of float32 Forward
scores that agree within 1e-4 bits, tests/test_torch_hmm.py).

The pinned cases give both packages the same MSAs (each package's
`align_families_chunked` replaced by one function), so that F3 (the JAX
package's bfloat16 profiles against the port's float32, ROADMAP Queue 3)
cannot be told for an enhancer fault; the unpinned case has groups of 3
rows, where the two aligners agree exactly.  The JAX scorer runs with a
batch of 64 pairs instead of 4,096 (chunks are padded; a pair's score
does not depend on its chunk), which keeps it fast on the CPU."""

import functools

import numpy as np
import pytest
import torch

import pepr_tpu.models.hmm_enhancer as jenh
from pepr_tpu.io.fasta import SequenceSet as JSet
from pepr_tpu.ops.hmm import profile_score_pairs as j_profile_score_pairs

import pepr_tpu_torch.models.hmm_enhancer as tenh
from pepr_tpu_torch.alphabet import GAP, PAD
from pepr_tpu_torch.io.fasta import SequenceSet
from pepr_tpu_torch.models.msa import align_families_chunked
from pepr_tpu_torch.utils.simulate import simulate_genomes

torch.set_num_threads(2)


def _jax_sets(sets):
    return [JSet(s.name, list(s.titles), list(s.seqs)) for s in sets]


@pytest.fixture(autouse=True)
def small_jax_batches(monkeypatch):
    monkeypatch.setattr(jenh, "profile_score_pairs", functools.partial(
        j_profile_score_pairs, batch_size=64))


@pytest.fixture(scope="module")
def genomes():
    """4 ingroup genomes and 2 pool genomes of ~24 proteins under 128
    residues, and their homolog groups by family (ingroup members)."""
    ing, pool, _ = simulate_genomes(
        np.random.default_rng(21), n_ingroup=4, n_pool=2, n_families=20,
        n_random=4, median_len=90.0, max_len=127, n_long=0)
    fams: dict[str, tuple[list, list]] = {}
    for g in ing:
        for t, s in zip(g.titles, g.seqs):
            if t.startswith("fam"):
                titles, seqs = fams.setdefault(t.split("_")[0], ([], []))
                titles.append(t)
                seqs.append(s)
    groups = [SequenceSet(f"set_{k}", ts, ss)
              for k, (ts, ss) in sorted(fams.items()) if len(ts) >= 2]
    return ing, pool, groups


def _compare(got, want):
    assert [s.name for s in got.enhanced_sets] == \
        [s.name for s in want.enhanced_sets]
    assert [s.titles for s in got.enhanced_sets] == \
        [s.titles for s in want.enhanced_sets]
    for a, b in zip(got.enhanced_sets, want.enhanced_sets):
        assert all(np.array_equal(x, y) for x, y in zip(a.seqs, b.seqs))
    assert got.selected_outgroups == want.selected_outgroups
    assert got.genome_scores.keys() == want.genome_scores.keys()
    np.testing.assert_allclose(
        [got.genome_scores[k] for k in got.genome_scores],
        [want.genome_scores[k] for k in got.genome_scores],
        atol=1e-3, rtol=1e-6)


def test_consensus_sequence_identical():
    rng = np.random.default_rng(22)
    for n, L in ((1, 10), (3, 40), (6, 120), (9, 77)):
        aln = rng.integers(0, 20, size=(n, L)).astype(np.int8)
        aln[rng.random(aln.shape) < 0.3] = GAP
        aln[:, :2] = PAD
        aln[:, 3] = GAP
        got = tenh.consensus_sequence(aln)
        want = jenh.consensus_sequence(aln)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    aln = np.array([[0, 1, 23, 2], [0, 1, 23, 3], [0, 4, 23, 2]], np.int8)
    assert list(tenh.consensus_sequence(aln)) == [0, 1, 2]


def test_enhancer_matches_jax_with_pinned_alignments(genomes, monkeypatch):
    ing, pool, groups = genomes
    mats = align_families_chunked([g.seqs for g in groups], device="cpu")
    pinned = []

    def fixed(families, **kw):
        pinned.append(len(families))
        return [m.copy() for m in mats]

    monkeypatch.setattr(tenh, "align_families_chunked", fixed)
    monkeypatch.setattr(jenh, "align_families_chunked", fixed)
    timings, counts = {}, {}
    got = tenh.enhance_homolog_groups(groups, ing, pool, outgroup_count=1,
                                      min_bits=40.0, device="cpu",
                                      timings=timings, counts=counts)
    want = jenh.enhance_homolog_groups(_jax_sets(groups), _jax_sets(ing),
                                       _jax_sets(pool), outgroup_count=1,
                                       min_bits=40.0)
    assert pinned == [len(groups)] * 2
    _compare(got, want)
    # the run is not degenerate: a pool genome is selected and groups grow
    assert got.selected_outgroups and \
        sum(len(s) for s in got.enhanced_sets) > sum(len(g) for g in groups)
    assert {"hmm_align", "hmm_prefilter", "hmm_scoring"} <= set(timings)
    assert counts["hmm_prefilter_pairs"] == sum(
        counts["hmm_pairs_by_bucket"].values()) > 0


def test_prefilter_pairs_agree_but_for_float_ties(genomes, monkeypatch):
    """The union of the seed and cosine candidates against the consensi,
    recorded in both packages: identical, but for candidates at the
    cosine top-k's cut whose similarity ties another's in exact
    arithmetic, where the two float32 dot products round apart and pick
    different members of the tie (ROADMAP Queue 3, F5).  With smaller
    blocks of consensi the port scores a superset."""
    from pepr_tpu_torch.ops.kmer_filter import kmer_profiles
    ing, pool, groups = genomes
    mats = align_families_chunked([g.seqs for g in groups], device="cpu")
    seen = {}

    def recorder(name, orig):
        def rec(seqs, hmms, pairs, **kw):
            seen[name] = list(pairs)
            return orig(seqs, hmms, pairs, **kw)
        return rec

    for mod in (tenh, jenh):
        monkeypatch.setattr(mod, "align_families_chunked",
                            lambda f, **kw: [m.copy() for m in mats])
        monkeypatch.setattr(mod, "profile_score_pairs",
                            recorder(mod.__name__, mod.profile_score_pairs))
    tenh.enhance_homolog_groups(groups, ing, pool, min_bits=40.0,
                                device="cpu")
    jenh.enhance_homolog_groups(_jax_sets(groups), _jax_sets(ing),
                                _jax_sets(pool), min_bits=40.0)
    got, want = set(seen[tenh.__name__]), set(seen[jenh.__name__])
    assert len(got) == len(want) > len(ing + pool) * 10
    seqs = [s for g in pool + ing for s in g.seqs]
    sims = kmer_profiles(seqs).astype(np.float64) @ kmer_profiles(
        [tenh.consensus_sequence(m) for m in mats]).astype(np.float64).T
    differ = got ^ want
    assert len(differ) <= 0.01 * len(got)
    for p in {p for p, _ in differ}:
        a = sorted(h for q, h in got - want if q == p)
        b = sorted(h for q, h in want - got if q == p)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert abs(sims[p, x] - sims[p, y]) < 1e-6, (p, x, y)
    monkeypatch.setattr(tenh, "CONSENSUS_BLOCK", 8)
    tenh.enhance_homolog_groups(groups, ing, pool, min_bits=40.0,
                                device="cpu")
    assert set(seen[tenh.__name__]) >= got


def test_enhancer_matches_jax_on_three_row_groups(genomes):
    """Unpinned: groups of 3 rows (the first three ingroup genomes'
    members of each family), aligned by each package's own aligner."""
    ing, pool, groups = genomes
    small = [SequenceSet(g.name, g.titles[:3], g.seqs[:3]) for g in groups
             if len(g) >= 3]
    got = tenh.enhance_homolog_groups(small, ing, pool, outgroup_count=2,
                                      min_bits=40.0, device="cpu")
    want = jenh.enhance_homolog_groups(_jax_sets(small), _jax_sets(ing),
                                       _jax_sets(pool), outgroup_count=2,
                                       min_bits=40.0)
    _compare(got, want)


def test_rebuild_skips_equal_score_duplicates():
    """tests/test_hmm.py's case in both packages
    (HMMSetEnhancer.java:266-279): two identical copies of a gene in one
    genome score equally and must not end the rebuild."""
    rng = np.random.default_rng(23)
    L = 60
    base = rng.integers(0, 20, size=L).astype(np.int8)

    def mut(rate):
        s = base.copy()
        m = rng.random(L) < rate
        s[m] = rng.integers(0, 20, m.sum())
        return s

    dup = mut(0.0)
    c1, c2 = mut(0.15), mut(0.2)
    g0 = SequenceSet("g0", ["a [T0]", "b [T0]"], [dup, dup.copy()])
    g1 = SequenceSet("g1", ["c [T1]"], [c1])
    g2 = SequenceSet("g2", ["d [T2]"], [c2])
    hg = [SequenceSet("set_0", ["a [T0]", "c [T1]", "d [T2]"],
                      [dup, c1, c2])]
    got = tenh.enhance_homolog_groups(hg, [g0, g1, g2], [],
                                      outgroup_count=0, min_bits=5.0,
                                      device="cpu")
    want = jenh.enhance_homolog_groups(_jax_sets(hg),
                                       _jax_sets([g0, g1, g2]), [],
                                       outgroup_count=0, min_bits=5.0)
    assert set(got.enhanced_sets[0].taxa) == {"T0", "T1", "T2"}
    _compare(got, want)


def test_enhancer_resumes_from_a_store(genomes, tmp_path):
    """The unpinned 3-row case with a store, stopped at every poll that
    follows saved work (chip_smoke.py's countdowns, each run resuming the
    last one's store: alignment slices of 4 groups, the prefilter, each
    scoring bucket): the end is one call's result exactly and the JAX
    package's under `_compare`.  No groups give no groups."""
    from test_torch_checkpoint import smoke

    from pepr_tpu_torch.models import msa
    from pepr_tpu_torch.pipeline.checkpoint import CheckpointStore
    ing, pool, groups = genomes
    small = [SequenceSet(g.name, g.titles[:3], g.seqs[:3]) for g in groups
             if len(g) >= 3]
    kw = dict(outgroup_count=2, min_bits=40.0, device="cpu")
    chunk, msa.ALIGN_CHUNK = msa.ALIGN_CHUNK, 4
    try:
        one = tenh.enhance_homolog_groups(small, ing, pool, **kw)
        root = str(tmp_path / "ck")
        got, saved, _ = smoke.interrupted_runs(
            lambda d: tenh.enhance_homolog_groups(
                small, ing, pool, store=CheckpointStore(root), deadline=d,
                **kw), root, restart=True)
    finally:
        msa.ALIGN_CHUNK = chunk
    for stage in ("family alignment", "group alignment", "profile prefilter",
                  "profile HMM scoring", "profile scoring"):
        assert stage in saved, (stage, saved)
    assert [s.titles for s in got.enhanced_sets] == \
        [s.titles for s in one.enhanced_sets]
    assert got.selected_outgroups == one.selected_outgroups
    assert got.genome_scores == one.genome_scores
    want = jenh.enhance_homolog_groups(_jax_sets(small), _jax_sets(ing),
                                       _jax_sets(pool), outgroup_count=2,
                                       min_bits=40.0)
    _compare(got, want)
    assert tenh.enhance_homolog_groups([], ing, pool, device="cpu") \
        .enhanced_sets == []
