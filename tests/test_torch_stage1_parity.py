"""Stage-1 parity with the JAX package beyond one SW bucket, on the CPU
(ROADMAP Queue 3, C1 and C2).

C1: proteins of 100-700 residues, so that the SW pair list spans the
128, 256, 512 and 1,024 length buckets with pairs in both orientations
(the longer sequence first, swapped to the DP target), through both
packages' `search_all_vs_all`: the same hit table in every field.

C2: the nucleotide path (blastn +1/-3, 5/2): both packages'
`search_all_vs_all(alphabet="nt")`, and `score_outgroups(...,
alphabet="nt")` on the same homolog groups and pool: the same hits, the
same selected pool genomes and the same best (genome, group) bit
scores; and `run_stage1` with `alphabet="nt"`: the same groups and
outgroups.  Every value is compared exactly.  The JAX package's SW
batches are cut to 8 pairs (its `batch_size`; in `score_outgroups`, by
wrapping its `_bucketed_sw`), which changes no result and keeps its CPU
scan small."""

import functools

import numpy as np
import pytest
import torch

from pepr_tpu.io.fasta import SequenceSet as JSet
from pepr_tpu.models import homology as j_homology
from pepr_tpu.pipeline import stage1 as j_stage1

from pepr_tpu_torch.io.fasta import SequenceSet
from pepr_tpu_torch.models.homology import (candidate_union,
                                            cluster_homolog_groups,
                                            groups_to_sequence_sets,
                                            search_all_vs_all, sw_buckets)
from pepr_tpu_torch.pipeline.stage1 import (Stage1Config, run_stage1,
                                            score_outgroups)
from pepr_tpu_torch.utils.simulate import simulate_genomes

torch.set_num_threads(2)

HIT_FIELDS = ("query", "target", "raw", "bits", "evalue", "identity",
              "length")
J_BATCH = 8


def _jax_sets(sets):
    return [JSet(s.name, list(s.titles), list(s.seqs)) for s in sets]


@pytest.fixture
def small_jax_batches(monkeypatch):
    monkeypatch.setattr(j_stage1, "_bucketed_sw", functools.partial(
        j_homology._bucketed_sw, batch_size=J_BATCH))


def _same_hits(got, want):
    for f in HIT_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


# -- C1: proteins across four SW buckets -------------------------------------

@pytest.fixture(scope="module")
def protein_searches():
    ing, _, _ = simulate_genomes(
        np.random.default_rng(21), n_ingroup=3, n_families=9, n_random=2,
        median_len=300.0, sigma=0.6, min_len=100, max_len=700, n_long=0)
    got = search_all_vs_all(ing, device="cpu")
    want = j_homology.search_all_vs_all(_jax_sets(ing), batch_size=J_BATCH)
    return got, want


def test_protein_pair_list_spans_buckets_and_orientations(protein_searches):
    (universe, _), _ = protein_searches
    lens = universe.lengths
    assert 100 <= lens.min() and lens.max() <= 700
    qs, ts = candidate_union(universe, device="cpu")
    eff_q, eff_t, buckets = sw_buckets(lens, qs, ts)
    sides = {b for key in buckets for b in key}
    assert {128, 256, 512, 1024} <= sides
    assert (eff_q != qs).any() and (eff_q == qs).any()


def test_protein_search_identical_across_buckets(protein_searches):
    (_, hits), (_, jhits) = protein_searches
    assert len(hits.query) > 40
    _same_hits(hits, jhits)


# -- C2: the nucleotide path -------------------------------------------------

def nt_genomes(rng, n_genomes, n_families=10, n_random=2, lo=70, hi=250,
               tag="Nucleica"):
    """Genomes of ACGT codes: each family a random sequence of lo..hi
    bases, copied with 4% substitutions into each genome with
    probability 0.9, plus random sequences."""
    fams = [rng.integers(0, 4, size=int(rng.integers(lo, hi)))
            for _ in range(n_families)]
    out = []
    for g in range(n_genomes):
        taxon = f"{tag} spec{g:02d} strain X"
        titles, seqs = [], []
        for f, base in enumerate(fams):
            if rng.random() < 0.9:
                s = base.copy()
                mut = rng.random(len(s)) < 0.04
                s[mut] = rng.integers(0, 4, size=int(mut.sum()))
                titles.append(f"fam{f:03d}_{g} [{taxon}]")
                seqs.append(s.astype(np.int8))
        for r in range(n_random):
            titles.append(f"rnd{r:03d}_{g} [{taxon}]")
            seqs.append(rng.integers(0, 4, size=int(rng.integers(lo, hi)))
                        .astype(np.int8))
        out.append(SequenceSet(taxon.replace(" ", "_"), titles, seqs))
    return out


@pytest.fixture(scope="module")
def nt_input():
    rng = np.random.default_rng(22)
    ing = nt_genomes(rng, 3)
    # two pool genomes: one shares the ingroup's families, one is random
    pool = [nt_genomes(np.random.default_rng(22), 4)[3],
            nt_genomes(rng, 1, tag="Randomia")[0]]
    return ing, pool


@pytest.fixture(scope="module")
def nt_searches(nt_input):
    ing, _ = nt_input
    got = search_all_vs_all(ing, alphabet="nt", device="cpu")
    want = j_homology.search_all_vs_all(_jax_sets(ing), alphabet="nt",
                                        batch_size=J_BATCH)
    return got, want


def test_nt_search_identical(nt_searches):
    (universe, hits), (_, jhits) = nt_searches
    assert len(hits.query) > 30
    _same_hits(hits, jhits)
    sides = {b for k in sw_buckets(universe.lengths, hits.query,
                                   hits.target)[2] for b in k}
    assert {128, 256} <= sides


def test_nt_score_outgroups_identical(nt_input, nt_searches,
                                      small_jax_batches):
    _, pool = nt_input
    (universe, hits), (juni, _) = nt_searches
    groups = cluster_homolog_groups(universe, hits, device="cpu")
    hg = groups_to_sequence_sets(universe, groups)
    jhg = j_homology.groups_to_sequence_sets(juni, groups)
    cfg = Stage1Config(use_hmm=False, alphabet="nt")
    got = score_outgroups(hg, pool, cfg, alphabet="nt", device="cpu")
    want = j_stage1.score_outgroups(jhg, _jax_sets(pool),
                                    j_stage1.Stage1Config(use_hmm=False,
                                                          alphabet="nt"),
                                    alphabet="nt")
    assert got[0] == want[0] == [0]
    assert got[1] == want[1]
    assert len(got[1]) >= 5


def test_nt_run_stage1_identical(nt_input, small_jax_batches, monkeypatch):
    ing, pool = nt_input
    monkeypatch.setattr(j_stage1, "search_all_vs_all", functools.partial(
        j_homology.search_all_vs_all, batch_size=J_BATCH))
    got = run_stage1(ing, pool, Stage1Config(use_hmm=False, alphabet="nt"),
                     device="cpu")
    want = j_stage1.run_stage1(_jax_sets(ing), _jax_sets(pool),
                               j_stage1.Stage1Config(use_hmm=False,
                                                     alphabet="nt"))
    assert [s.titles for s in got.hg_sets] == \
        [s.titles for s in want.hg_sets]
    assert got.selected_outgroups == want.selected_outgroups == \
        [pool[0].taxon]
    assert len(got.hg_sets) >= 5
