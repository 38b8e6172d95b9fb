"""A rehearsal of chip_smoke.py's stage-1 phases on the CPU, at a tiny
size: seeded genomes from simulate_genomes, the SW pair list and its
length buckets as the sw_kernel phase builds them, the planted blastn
pairs, the bound, run_stage1(use_hmm=False, device="cpu") end to end
and the family-recovery measure of the stage1 phase.  Port only: the
JAX package is held against the port in test_torch_homology.py."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from pepr_tpu_torch.data.nt_scores import (NT_GAP_EXTEND, NT_GAP_OPEN,
                                           nt_kernel_matrix)
from pepr_tpu_torch.io.fasta import taxon_from_title
from pepr_tpu_torch.models.homology import (ProteinUniverse, batch_pairs,
                                            candidate_union, pack_codes,
                                            sw_buckets)
from pepr_tpu_torch.ops.smith_waterman import sw_align_batch, sw_align_numpy
from pepr_tpu_torch.pipeline.stage1 import Stage1Config, run_stage1
from pepr_tpu_torch.utils.simulate import simulate_genomes

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def genomes():
    return simulate_genomes(np.random.default_rng(7), n_ingroup=4,
                            n_families=30, n_random=3, median_len=150.0,
                            max_len=300, n_long=1, long_lengths=(300, 400))


def test_simulated_genomes_shape(genomes):
    ing, pool, tree = genomes
    assert len(ing) == 4 and len(pool) == 1
    assert sorted(tree.leaf_labels()) == sorted(g.taxon for g in ing + pool)
    for g in ing + pool:
        assert {taxon_from_title(t) for t in g.titles} == {g.taxon}
        assert sum(t.startswith("rnd") for t in g.titles) == 3
        assert all(s.dtype == np.int8 and s.max() < 20 for s in g.seqs)
    lens = np.concatenate([g.lengths() for g in ing])
    assert lens.min() >= 50 and 300 < lens.max() <= 400


def test_sw_phase_inputs(genomes, smoke):
    ing, _, _ = genomes
    universe = ProteinUniverse.build(ing)
    pq, pt = candidate_union(universe, device="cpu")
    assert len(pq) == len(np.unique(pq * universe.n + pt))
    eff_q, eff_t, buckets = sw_buckets(universe.lengths, pq, pt)
    assert sum(len(i) for i in buckets.values()) == len(pq)
    assert len(buckets) >= 3
    codes = pack_codes(universe.seqs)
    assert codes.shape == (universe.n, 512) and codes.dtype == torch.int8
    for (blq, blt), idx in buckets.items():
        assert blq <= blt
        assert (universe.lengths[eff_q[idx]] <= blq).all()
        assert (universe.lengths[eff_t[idx]] <= blt).all()
        assert batch_pairs(blq, blt, torch.device("cuda")) >= 1 << 15
    ms, by = smoke.sw_bound(10 ** 12, 10 ** 6, 1000, 1980.0)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 20e12 / (132 * 64 * 1980e6))


def test_planted_nt_pairs(smoke):
    q, t = smoke.planted_nt_pairs(np.random.default_rng(0), 6, 64, 128)
    sub = nt_kernel_matrix()
    got = sw_align_batch(torch.as_tensor(q), torch.as_tensor(t), sub,
                         NT_GAP_OPEN, NT_GAP_EXTEND)
    for b in range(len(q)):
        want = sw_align_numpy(q[b], t[b], sub, NT_GAP_OPEN, NT_GAP_EXTEND)
        assert float(got["score"][b]) == want["score"]
        assert int(got["length"][b]) == want["length"]
    assert float(got["score"].min()) >= 16  # the planted copies align


def test_run_stage1_end_to_end(genomes, smoke):
    ing, pool, _ = genomes
    res = run_stage1(ing, pool, Stage1Config(use_hmm=False,
                                             outgroup_count=2), device="cpu")
    assert res.selected_outgroups == [pool[0].taxon]
    assert res.counts["groups"] == len(res.hg_sets) >= 20
    assert res.counts["sw_pairs"] > res.counts["hits"] > 0
    assert set(res.timings) >= {"profiles", "cosine_candidates",
                                "seed_candidates", "sw", "hit_ranking",
                                "homology_search", "mcl",
                                "outgroup_selection"}
    rec, elig = smoke.family_recovery(res.hg_sets, ing)
    assert 20 <= elig <= 30
    assert rec >= smoke.RECOVERY_FLOOR * elig
    # a pool member joined most groups
    joined = sum(any(taxon_from_title(t) == pool[0].taxon for t in s.titles)
                 for s in res.hg_sets)
    assert joined >= len(res.hg_sets) // 2


def test_stage1_native_checks_rehearsal(genomes, smoke, monkeypatch):
    """The stage1 phase's native checks: native_inputs records the
    universe's profiles and the hit graph's components while run_stage1
    runs (and puts the functions back), native_checks holds them against
    the plain versions; a profile two ulps off and a wrong root fail."""
    from pepr_tpu_torch.models import homology
    from pepr_tpu_torch.ops import mcl
    ing, pool, _ = genomes
    before = (homology.kmer_profiles, mcl.connected_components)
    with smoke.native_inputs() as seen:
        run_stage1(ing, pool, Stage1Config(use_hmm=False, outgroup_count=2),
                   device="cpu")
    assert (homology.kmer_profiles, mcl.connected_components) == before
    out = smoke.native_checks(seen)
    n = sum(len(g) for g in ing)  # the universe: the ingroup genomes
    assert [p["rows"] for p in out["kmer_profiles"]] == [n]
    assert out["kmer_profiles"][0]["max_ulps"] <= 1.0
    assert out["connected_components"][0]["identical"]
    assert out["connected_components"][0]["nodes"] == n
    a, kw, got = seen["kmer_profiles"][0]
    bad = got.copy()
    i = np.flatnonzero(bad)[0]
    bad.flat[i] = np.nextafter(np.nextafter(bad.flat[i], 2.0,
                                            dtype=np.float32), 2.0,
                               dtype=np.float32)
    monkeypatch.setattr(smoke, "fail", lambda msg: (_ for _ in ()).throw(
        AssertionError(msg)))
    with pytest.raises(AssertionError, match="more than one ulp"):
        smoke.native_checks(dict(seen, kmer_profiles=[(a, kw, bad)]))
    a, kw, got = seen["connected_components"][0]
    wrong = got.copy()
    wrong[0] = len(wrong)
    with pytest.raises(AssertionError, match="components differ"):
        smoke.native_checks(dict(seen, connected_components=[(a, kw,
                                                              wrong)]))


def test_family_recovery_counts_only_clean_groups(genomes, smoke):
    ing, _, _ = genomes
    fams = {}
    for g in ing:
        for title in g.titles:
            fams.setdefault(smoke.family_key(title), []).append(title)
    eligible = sorted(f for f, m in fams.items()
                      if f.startswith("fam") and len(m) >= 2)

    class Group:
        def __init__(self, titles):
            self.titles = titles

    f0, f1 = eligible[:2]
    mixed = Group(fams[f0] + fams[f1][:1])
    clean = Group(fams[f1])
    assert smoke.family_recovery([mixed, clean], ing) == (1, len(eligible))
    # one member of a family in >= 2 genomes is under 90% of it
    assert smoke.family_recovery([Group(fams[f0][:1])], ing)[0] == 0
