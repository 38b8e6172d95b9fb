"""The port's stage 1 (pepr_tpu_torch: ops/kmer_filter, ops/mcl,
models/homology, io/hits, pipeline/stage1 with and without the HMM
enhancer) against the JAX package on the CPU.  Tolerances: k-mer
profiles and cosine similarities within abs 1e-6 (float32 sums in
another order); every index, pair list, cluster, hit table, group and
outgroup identical."""

import numpy as np
import pytest
import torch

from pepr_tpu.data import blosum62 as j_blosum62
from pepr_tpu.data import nt_scores as j_nt_scores
from pepr_tpu.io.fasta import SequenceSet as JSet
from pepr_tpu.io.fasta import pack_padded as j_pack_padded
from pepr_tpu.io.fasta import read_fasta as j_read_fasta
from pepr_tpu.io.fasta import taxon_from_title as j_taxon_from_title
from pepr_tpu.io.hits import write_blast8 as j_write_blast8
from pepr_tpu.models.homology import \
    cluster_homolog_groups as j_cluster_homolog_groups
from pepr_tpu.models.homology import search_all_vs_all as j_search
from pepr_tpu.ops import kmer_filter as jk
from pepr_tpu.ops import mcl as jm
from pepr_tpu.pipeline.stage1 import Stage1Config as JConfig
from pepr_tpu.pipeline.stage1 import run_stage1 as j_run_stage1

from pepr_tpu_torch.data import blosum62, nt_scores
from pepr_tpu_torch.io.fasta import (SequenceSet, pack_padded, read_fasta,
                                     taxon_from_title, write_fasta)
from pepr_tpu_torch.io.hits import read_blast8, write_blast8
from pepr_tpu_torch.models.homology import (_pow2_len, cluster_homolog_groups,
                                            search_all_vs_all, sw_buckets)
from pepr_tpu_torch.ops import kmer_filter as tk
from pepr_tpu_torch.ops import mcl as tm
from pepr_tpu_torch.pipeline.stage1 import Stage1Config, run_stage1
from pepr_tpu_torch.utils.simulate import simulate_genomes

torch.set_num_threads(2)

HIT_FIELDS = ("query", "target", "raw", "bits", "evalue", "identity",
              "length")


def _jax_sets(sets):
    return [JSet(s.name, list(s.titles), list(s.seqs)) for s in sets]


@pytest.fixture(scope="module")
def genomes():
    """4 ingroup genomes and a pool genome of ~24 proteins each, all
    shorter than 128 residues: the JAX package pads every SW batch to
    4,096 pairs per length bucket, and one bucket keeps its side fast."""
    ing, pool, _ = simulate_genomes(
        np.random.default_rng(1), n_ingroup=4, n_families=25, n_random=4,
        median_len=90.0, max_len=127, n_long=0)
    return ing, pool


@pytest.fixture(scope="module")
def seqs():
    rng = np.random.default_rng(3)
    base = [rng.integers(0, 20, size=int(n)).astype(np.int8)
            for n in rng.integers(30, 150, size=12)]
    out = []
    for s in base * 3:  # three mutated copies of each, some ambiguity
        c = s.copy()
        m = rng.random(len(c)) < 0.15
        c[m] = rng.integers(0, 23, size=int(m.sum()))
        out.append(c)
    return out


# -- matrices, constants and titles --------------------------------------

def test_scoring_data_identical():
    np.testing.assert_array_equal(blosum62.BLOSUM62, j_blosum62.BLOSUM62)
    np.testing.assert_array_equal(blosum62.blosum62_matrix(gap_score=-4,
                                                           pad_score=-9),
                                  j_blosum62.blosum62_matrix(gap_score=-4,
                                                             pad_score=-9))
    np.testing.assert_array_equal(nt_scores.nt_kernel_matrix(),
                                  j_nt_scores.nt_kernel_matrix())
    np.testing.assert_array_equal(nt_scores.nt_core(),
                                  j_nt_scores.nt_core())
    for mod, jmod, names in (
            (blosum62, j_blosum62, ("LAMBDA_GAPPED", "K_GAPPED",
                                    "LAMBDA_UNGAPPED", "K_UNGAPPED",
                                    "GAP_OPEN", "GAP_EXTEND")),
            (nt_scores, j_nt_scores, ("NT_MATCH", "NT_MISMATCH",
                                      "NT_GAP_OPEN", "NT_GAP_EXTEND",
                                      "LAMBDA_NT_GAPPED", "K_NT_GAPPED",
                                      "LAMBDA_NT_UNGAPPED",
                                      "K_NT_UNGAPPED"))):
        for n in names:
            assert getattr(mod, n) == getattr(jmod, n), n
    raw = np.array([0.0, 15.0, 57.0, 311.0])
    np.testing.assert_array_equal(blosum62.raw_to_bit_score(raw),
                                  j_blosum62.raw_to_bit_score(raw))
    np.testing.assert_array_equal(nt_scores.nt_raw_to_bit_score(raw),
                                  j_nt_scores.nt_raw_to_bit_score(raw))
    np.testing.assert_array_equal(
        blosum62.bit_score_to_evalue(raw, raw + 100, 1e6),
        j_blosum62.bit_score_to_evalue(raw, raw + 100, 1e6))


def test_titles_and_taxa(genomes):
    ing, pool = genomes
    for g in ing + pool:
        for t in g.titles[:5]:
            assert taxon_from_title(t) == j_taxon_from_title(t)
        assert g.taxon == g.name
    for t in ("a|b [Foo bar (x)] [Baz qux|7]", "plain title", "[x [y] z]"):
        assert taxon_from_title(t) == j_taxon_from_title(t)
    assert len({"_".join(g.taxon.split("_")[:2]) for g in ing}) == len(ing)


def test_fasta_round_trip_matches_jax(genomes, tmp_path):
    ing, _ = genomes
    path = tmp_path / "g0.faa"
    write_fasta(str(path), ing[0], width=50)
    got, want = read_fasta(str(path)), j_read_fasta(str(path))
    assert got.name == want.name == "g0"
    assert got.titles == want.titles == ing[0].titles
    for a, b, c in zip(got.seqs, want.seqs, ing[0].seqs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    nt = tmp_path / "n.fna"
    nt.write_text(">x1 [T a]\nACGTNacgu-\n>x2 [T a]\nGG\nTT\n")
    for a, b in zip(read_fasta(str(nt), alphabet="nt").seqs,
                    j_read_fasta(str(nt), alphabet="nt").seqs):
        np.testing.assert_array_equal(a, b)
    for x, y in zip(pack_padded(got.seqs), j_pack_padded(got.seqs)):
        np.testing.assert_array_equal(x, y)


# -- prefilters ------------------------------------------------------------

@pytest.mark.parametrize("k", [4, 12])
def test_kmer_profiles(seqs, k):
    got = tk.kmer_profiles(seqs, k=k)
    want = jk.kmer_profiles(seqs, k=k)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_exact_kmer_pairs_and_seed_candidates(seqs):
    for a, b in zip(tk.exact_kmer_pairs(seqs, k=3),
                    jk.exact_kmer_pairs(seqs, k=3)):
        np.testing.assert_array_equal(a, b)
    offsets = np.array([0, 12, 24, 36])
    np.testing.assert_array_equal(
        tk.seed_candidates(seqs, seqs, offsets, k=3, max_df=20),
        jk.seed_candidates(seqs, seqs, offsets, k=3, max_df=20))
    # queries apart from targets
    np.testing.assert_array_equal(
        tk.seed_candidates(seqs[:10], seqs, offsets, k=4, top_per_genome=2),
        jk.seed_candidates(seqs[:10], seqs, offsets, k=4, top_per_genome=2))


@pytest.mark.parametrize("top", [1, 3])
def test_candidate_pairs(seqs, top):
    prof = tk.kmer_profiles(seqs)
    offsets = np.array([0, 7, 12, 30, 36])  # ragged genome blocks
    idx, sim = tk.candidate_pairs(prof, prof, offsets, top_per_genome=top,
                                  min_sim=0.05, q_tile=16, device="cpu")
    jidx, jsim = jk.candidate_pairs(prof, prof, offsets, top_per_genome=top,
                                    min_sim=0.05)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(sim, jsim, rtol=0, atol=1e-6)
    assert (idx >= 0).sum() > len(seqs)


# -- MCL -----------------------------------------------------------------

@pytest.fixture(scope="module")
def graph():
    """Components of 1, 2, 5, 14, 20, 40 and 70 nodes (buckets 16, 32,
    64 and 128), each a few dense cliques joined by weak edges."""
    rng = np.random.default_rng(9)
    ei, ej, w = [], [], []
    n = 0
    for size in (1, 2, 5, 14, 20, 40, 70):
        nodes = np.arange(n, n + size)
        n += size
        cuts = np.sort(rng.choice(np.arange(1, size), size=min(
            size - 1, size // 7), replace=False)) if size > 2 else []
        for part in np.split(nodes, cuts):
            for a in range(len(part)):
                for b in range(a + 1, len(part)):
                    ei.append(part[a])
                    ej.append(part[b])
                    w.append(rng.uniform(50, 300))
        for _ in range(max(size // 5, 1 if size > 1 else 0)):
            a, b = rng.choice(nodes, 2, replace=False)
            ei.append(a)
            ej.append(b)
            w.append(rng.uniform(1, 20))
    return n, np.array(ei), np.array(ej), np.array(w)


def test_connected_components(graph):
    n, ei, ej, _ = graph
    np.testing.assert_array_equal(tm.connected_components(n, ei, ej),
                                  jm.connected_components(n, ei, ej))


@pytest.mark.parametrize("inflation", [1.5, 2.5])
def test_mcl_clusters_identical(graph, inflation):
    n, ei, ej, w = graph
    got = tm.mcl_cluster(n, ei, ej, w, inflation=inflation, device="cpu")
    want = jm.mcl_cluster(n, ei, ej, w, inflation=inflation)
    assert got == want
    assert len(got) > 7  # some components split


# -- homology search and stage 1 ------------------------------------------

def test_pow2_buckets():
    for x in (1, 100, 128, 129, 300, 2049, 4096, 9000):
        assert _pow2_len(x) == max(128, min(4096, 2 ** int(np.ceil(
            np.log2(max(x, 1))))))
    lens = np.array([50, 300, 129, 5000])
    eff_q, eff_t, buckets = sw_buckets(lens, np.array([0, 1, 3, 2]),
                                       np.array([1, 0, 2, 3]))
    np.testing.assert_array_equal(eff_q, [0, 0, 2, 2])
    np.testing.assert_array_equal(eff_t, [1, 1, 3, 3])
    assert list(buckets) == [(128, 512), (256, 4096)]


@pytest.fixture(scope="module")
def searches(genomes):
    ing, _ = genomes
    timings, counts = {}, {}
    got = search_all_vs_all(ing, device="cpu", timings=timings,
                            counts=counts)
    want = j_search(_jax_sets(ing))
    return got, want, timings, counts


def test_search_all_vs_all_identical(searches):
    (_, hits), (_, jhits), timings, counts = searches
    assert len(hits.query) > 50
    for f in HIT_FIELDS:
        a, b = getattr(hits, f), getattr(jhits, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert set(timings) == {"profiles", "cosine_candidates",
                            "seed_candidates", "sw", "hit_ranking"}
    assert counts["sw_pairs"] >= len(hits.query)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_cluster_homolog_groups_identical(searches, bidirectional):
    (universe, hits), (juni, jhits), _, _ = searches
    got = cluster_homolog_groups(universe, hits, bidirectional=bidirectional,
                                 device="cpu")
    assert got == j_cluster_homolog_groups(juni, jhits,
                                           bidirectional=bidirectional)
    assert len(got) >= 10


def test_blast8_round_trip(searches, tmp_path):
    (universe, hits), (juni, jhits), _, _ = searches
    path, jpath = tmp_path / "port.b8", tmp_path / "jax.b8"
    write_blast8(str(path), universe, hits)
    j_write_blast8(str(jpath), juni, jhits)
    assert path.read_text() == jpath.read_text()
    back = read_blast8(str(path), universe)
    for f in ("query", "target"):
        np.testing.assert_array_equal(getattr(back, f), getattr(hits, f))
    np.testing.assert_allclose(back.bits, hits.bits, atol=0.05)
    np.testing.assert_allclose(back.identity, hits.identity, atol=0.005)
    np.testing.assert_array_equal(back.length, hits.length)
    np.testing.assert_allclose(back.evalue, hits.evalue, rtol=0.05)


@pytest.fixture(scope="module")
def stage1(genomes):
    ing, pool = genomes
    got = run_stage1(ing, pool, Stage1Config(use_hmm=False), device="cpu")
    want = j_run_stage1(_jax_sets(ing), _jax_sets(pool),
                        JConfig(use_hmm=False))
    return got, want


def test_run_stage1_identical_groups_and_outgroups(stage1, genomes):
    got, want = stage1
    _, pool = genomes
    assert [s.titles for s in got.hg_sets] == \
        [s.titles for s in want.hg_sets]
    assert got.selected_outgroups == want.selected_outgroups == \
        [pool[0].taxon]
    assert len(got.hg_sets) >= 10
    assert got.counts["groups"] == len(got.hg_sets)
    assert {"homology_search", "mcl", "outgroup_selection"} <= \
        set(got.timings)


def test_run_stage1_with_hmm_identical_groups_and_outgroups(genomes,
                                                            monkeypatch):
    """use_hmm=True, the reference default: the HMM enhancer rebuilds
    the groups and selects the outgroup.  These proteins are under 128
    residues, below the 144-bit cutoff the pipeline uses for ~3k-protein
    genomes, so both run at 40 bits; the JAX scorer at a batch of 64
    pairs instead of 4,096 (a pair's score does not depend on its
    chunk)."""
    import functools

    import pepr_tpu.models.hmm_enhancer as jenh
    monkeypatch.setattr(jenh, "profile_score_pairs", functools.partial(
        jenh.profile_score_pairs, batch_size=64))
    ing, pool = genomes
    got = run_stage1(ing, pool, Stage1Config(hmm_min_bits=40.0),
                     device="cpu")
    want = j_run_stage1(_jax_sets(ing), _jax_sets(pool),
                        JConfig(hmm_min_bits=40.0))
    assert [s.name for s in got.hg_sets] == [s.name for s in want.hg_sets]
    assert [s.titles for s in got.hg_sets] == \
        [s.titles for s in want.hg_sets]
    assert got.selected_outgroups == want.selected_outgroups == \
        [pool[0].taxon]
    # the enhancer added pool members to groups
    assert any(pool[0].taxon in s.taxa for s in got.hg_sets)
    assert {"hmm_enhancement", "hmm_align", "hmm_prefilter",
            "hmm_scoring"} <= set(got.timings)
    assert got.counts["hmm_prefilter_pairs"] > 0
    assert got.counts["hmm_real_cells"] <= got.counts["hmm_padded_cells"]


def test_homology_file_reads_blast8(searches, genomes, tmp_path):
    (universe, hits), _, _, _ = searches
    ing, _ = genomes
    path = tmp_path / "hits.b8"
    write_blast8(str(path), universe, hits)
    res = run_stage1(ing, [], Stage1Config(use_hmm=False,
                                           homology_file=str(path)),
                     device="cpu")
    want = cluster_homolog_groups(universe, read_blast8(str(path), universe),
                                  device="cpu")
    assert [len(s) for s in res.hg_sets] == [len(c) for c in want]
    assert isinstance(res.hg_sets[0], SequenceSet)
