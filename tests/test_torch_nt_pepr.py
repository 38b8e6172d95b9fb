"""The nucleotide pipeline (`pepr -alphabet nt`) with refinement, through
the port and the JAX package on the CPU, and a rehearsal of
chip_smoke.py's nt_small and nt_pepr phases.

One module-scoped fixture runs both packages' pipeline CLI `main` with
`-alphabet nt -hmm false` on the same FASTA files (chip_smoke's
nucleotide genome generator, 6 ingroup genomes and the pool, a planted
clade that the default track refines once; genes of 60-125 nt, so that
the JAX package's SW, which pads every launch to 4,096 pairs, runs one
bucket on the CPU), recording every stage-1 result and the run's
`PeprResult`.  Held against each other: the homolog groups of every
stage-1 run (titles) and their selected outgroups, the refinement
rounds, the final tree's topology (RF 0), the LL within 1e-4 relative
(the tolerance of test_nt_pipeline_recovers_the_species_tree_as_jax),
the output file names and the written trees' topologies.  The
alignments agree but for F3 (ROADMAP Queue 3: the JAX package rounds
MSA profiles to bfloat16): the same shapes, at most 1% of the cells
apart.  Also: `gtr_nt` with unequal exchangeabilities against the JAX
one (P matrices within 1e-6 of their largest entry, one LL within 1e-6
relative, the dead states' transition probabilities at most 1e-9), F11
(the CLI's `-alphabet nt` keeps the HMM enhancer on in both packages)
and F12 (outgroup scoring's candidates at gene lengths, the same in
both packages)."""

import contextlib
import dataclasses
import importlib.util
import io
import os

import numpy as np
import pytest
import torch

from pepr_tpu.ops import likelihood as jlik
from pepr_tpu.pipeline import cli as jcli
from pepr_tpu.pipeline import pepr as jpepr
from pepr_tpu.tree import to_newick as j_newick

from pepr_tpu_torch.ops import likelihood as tlik
from pepr_tpu_torch.ops import pruning
from pepr_tpu_torch.pipeline import cli as tcli
from pepr_tpu_torch.pipeline import pepr as tpepr
from pepr_tpu_torch.tree import parse_newick, rf_distance, to_newick
from pepr_tpu_torch.utils.simulate import random_tree

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 4  # jackknife replicates, and the refinement cutoff (counts)
# the fixture's genes: nt_small_genomes' law at a median of 110 nt
# clipped to 60-125 nt, 12 families a genome
CLI_MEDIAN, CLI_CLIP, CLI_FAMILIES = 110.0, (60, 125), 12
LL_RTOL = 1e-4
F3_CELL_SHARE = 0.01  # alignment cells F3 may move
RATES = (1.0, 4.0, 0.7, 1.3, 5.0, 1.0)  # AC, AG, AT, CG, CT, GT
FREQS = (0.3, 0.2, 0.15, 0.35)
P_TOL = 1e-6  # P matrices: max |diff| over their largest entry
GTR_LL_RTOL = 1e-6
DEAD_TOL = 1e-9


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _argv(smoke, files, pool, root, name, device_args):
    return smoke.nt_pepr_argv(
        files, pool, os.path.join(root, name),
        os.path.join(root, name + "_ck"), reps=REPS) + [
        "-tree_method", "fasttree", *device_args]


@pytest.fixture(scope="module")
def cli_runs(smoke, tmp_path_factory):
    """Both packages' pipeline CLI on the nucleotide FASTA files of
    `nt_small_genomes(0, n_ingroup=6)` at the CLI_* sizes, without the
    pool's long gene (the JAX package's SW at 4,096 costs minutes on the
    CPU): the port's with `-device cpu`.  Returns ({port, jax}: {result,
    stage1, stdout, out}, the ingroup, the pool)."""
    root = str(tmp_path_factory.mktemp("nt_cli"))
    sizes = dict(NT_SMALL_MEDIAN=CLI_MEDIAN, NT_SMALL_CLIP=CLI_CLIP,
                 NT_SMALL_FAMILIES=CLI_FAMILIES)
    saved = {k: getattr(smoke, k) for k in sizes}
    for k, v in sizes.items():
        setattr(smoke, k, v)
    try:
        ing, pool, _ = smoke.nt_small_genomes(0, n_ingroup=6)
    finally:
        for k, v in saved.items():
            setattr(smoke, k, v)
    pool = [pool[0].subset([i for i, t in enumerate(pool[0].titles)
                            if not t.startswith("long")])]
    files, pool_files = smoke.nt_pepr_files(ing, pool, root)
    runs = {}
    for name, cli, pipe, dev in (("port", tcli, tpepr, ["-device", "cpu"]),
                                 ("jax", jcli, jpepr, [])):
        argv = _argv(smoke, files, pool_files, root, name, dev)
        buf = io.StringIO()
        with smoke.Returns(cli, "run_pepr") as res, \
                smoke.Returns(pipe, "run_stage1") as s1, \
                contextlib.redirect_stdout(buf):
            assert cli.main(argv) == 0
        runs[name] = dict(result=res.results[0], stage1=s1.results,
                          stdout=buf.getvalue(), out=os.path.join(root, name))
    return runs, ing, pool


def test_nt_run_pepr_with_refinement_matches_jax(cli_runs):
    """(a) The same groups in every stage-1 run (the run's and the
    refinement sub-run's), the same outgroups, one refinement round on
    both sides, the same final topology and the LL within LL_RTOL; the
    alignments as the module docstring says (F3)."""
    runs, ing, pool = cli_runs
    got, want = runs["port"], runs["jax"]

    def groups(stage1):
        return [[s.titles for s in r.hg_sets] for r in stage1]

    assert len(got["stage1"]) == len(want["stage1"]) == 2
    assert groups(got["stage1"]) == groups(want["stage1"])
    assert [r.selected_outgroups for r in got["stage1"]] == \
        [r.selected_outgroups for r in want["stage1"]]
    g, w = got["result"], want["result"]
    assert g.selected_outgroups == w.selected_outgroups == [pool[0].taxon]
    assert g.refine_rounds == len(want["stage1"]) - 1 == 1
    assert rf_distance(g.tree, parse_newick(j_newick(w.tree))) == 0
    assert g.stage2.model_name == w.stage2.model_name == "GTR"
    assert g.stage2.log_likelihood == pytest.approx(
        w.stage2.log_likelihood, rel=LL_RTOL)
    # F3: the same families and shapes, a few cells apart
    ga, wa = g.stage2.alignments, w.stage2.alignments
    assert [a.name for a in ga] == [a.name for a in wa]
    assert [a.mat.shape for a in ga] == [np.asarray(a.mat).shape for a in wa]
    differ = sum(int((a.mat != np.asarray(b.mat)).sum())
                 for a, b in zip(ga, wa))
    assert differ <= F3_CELL_SHARE * sum(a.mat.size for a in ga)


def test_nt_cli_writes_the_same_files_and_topology(cli_runs):
    """(b) The same output file names, and the written trees (and the
    tree each CLI prints) of the same topology."""
    runs, _, _ = cli_runs
    got, want = runs["port"], runs["jax"]
    names = sorted(os.listdir(got["out"]))
    assert names == sorted(os.listdir(want["out"])) == sorted(
        f"smoke_nt{s}" for s in (".nwk", "_final_rooted.nwk",
                                 "_final_rooted.json", ".sup", ".hs",
                                 ".clp", ".report.xml"))
    for sfx in (".nwk", "_final_rooted.nwk"):
        trees = []
        for run in (got, want):
            with open(os.path.join(run["out"], f"smoke_nt{sfx}")) as fh:
                trees.append(parse_newick(fh.read()))
        assert rf_distance(*trees) == 0, sfx
    printed = [parse_newick(r["stdout"].strip().splitlines()[-1])
               for r in (got, want)]
    assert rf_distance(*printed) == 0
    with open(os.path.join(got["out"], "smoke_nt.sup")) as fh:
        assert len(fh.read().split()) == REPS


@pytest.mark.parametrize("hmm_flag, use_hmm", [([], True),
                                              (["-hmm", "false"], False)])
def test_f11_cli_alphabet_nt_keeps_the_hmm_default(hmm_flag, use_hmm):
    """F11: both packages' `-alphabet nt` leaves `stage1.use_hmm` at its
    default of True (so a bare `pepr -alphabet nt` runs the protein HMM
    enhancer over nucleotide codes, which the reference's blastn path
    does not); `-hmm false` turns it off in both."""
    argv = ["-genome_file", "g.fna", "-alphabet", "nt", *hmm_flag]
    t, j = tcli.config_from_args(argv), jcli.config_from_args(argv)
    assert t.alphabet == j.alphabet == "nt"
    assert t.stage1.alphabet == j.stage1.alphabet == "nt"
    assert t.stage1.use_hmm == j.stage1.use_hmm == use_hmm


def test_gtr_unequal_rates_matches_jax(smoke):
    """(c) `gtr_nt(freqs, rates)` with six unequal exchangeabilities: the
    transition matrices of a tree's branches and its LL against the JAX
    package's; the port's matrices keep the dead states dead
    (chip_smoke.dead_state_leak), and the plain pruning's per-site LLs
    sum to the same LL."""
    import jax.numpy as jnp
    rng = np.random.default_rng(71)
    taxa = [f"T{i}" for i in range(8)]
    tree = random_tree(taxa, rng, scale=0.08)
    rows = smoke.nt_evolve(tree, 600, rng)
    labels = [tree.labels[v] for v in tree.leaves()]
    codes = rows[[labels.index(t) for t in taxa]]
    codes[rng.random(codes.shape) < 0.02] = 23  # gaps
    tm = tlik.WagModel.gtr_nt(freqs=FREQS, rates=RATES, alpha=0.6)
    jm = jlik.WagModel.gtr_nt(freqs=FREQS, rates=RATES, alpha=0.6)
    arr = tlik.tree_to_arrays(tree, taxa)
    pm_t = tlik.transition_matrices(tm, torch.as_tensor(arr.blen))
    pm_j = np.array(jlik.transition_matrices(jm, jnp.asarray(arr.blen)))
    assert pm_t.shape == pm_j.shape
    assert float((pm_t.double() - torch.as_tensor(pm_j).double()).abs()
                 .max()) <= P_TOL * float(np.abs(pm_j).max())
    want = float(jlik.loglik(codes, arr.children, arr.blen, jm))
    got = tlik.loglik(codes, arr.children, arr.blen, tm, device="cpu")
    assert got == pytest.approx(want, rel=GTR_LL_RTOL)
    pi = torch.as_tensor(tm.pi)
    leak = smoke.dead_state_leak(pm_t, pi)
    assert leak is not None and leak <= DEAD_TOL
    site = pruning.site_ll_reference(
        torch.as_tensor(codes), torch.as_tensor(arr.children)[None],
        pm_t.contiguous()[None], pi)
    assert float(site.double().sum()) == pytest.approx(want,
                                                       rel=GTR_LL_RTOL)


def test_nt_genome_generator(smoke, monkeypatch):
    """(d) chip_smoke's nucleotide genomes: ACGT codes only, the length
    law (median near NT_GENE_MEDIAN, within the clip less the
    deletions), the long families past 4,096 nt, the pool on its basal
    branch, pepr_tree's planted clade at a third of its branch lengths,
    titles that give each genome's taxon; and nt_small's input with its
    long pool gene."""
    monkeypatch.setattr(smoke, "NT_PEPR_FAMILIES", 60)
    monkeypatch.setattr(smoke, "NT_PEPR_RANDOM", 4)
    ing, pool, tree = smoke.nt_pepr_genomes(0)
    assert len(ing) == smoke.S1_INGROUP and len(pool) == 1
    genes = [s for g in ing + pool for s in g.seqs]
    assert all(s.dtype == np.int8 and s.min() >= 0 and s.max() <= 3
               for s in genes)
    lens = np.array([len(s) for s in genes])
    lo, hi = smoke.NT_GENE_CLIP
    normal = lens[lens <= hi]
    assert normal.min() >= lo - 8 * smoke.DELETIONS[1]
    assert 0.8 * smoke.NT_GENE_MEDIAN <= np.median(normal) \
        <= 1.2 * smoke.NT_GENE_MEDIAN
    long = lens[lens > hi]
    assert len(long) >= smoke.NT_N_LONG and long.max() <= smoke.NT_LONG[1]
    assert long.min() >= smoke.NT_LONG[0] - 8 * smoke.DELETIONS[1] > 4096
    for g in ing + pool:
        assert {t for t in g.taxa} == {g.taxon}
    assert sorted(tree.leaf_labels()) == sorted(g.taxon for g in ing + pool)
    pool_leaf = tree.labels.index(pool[0].taxon)
    assert tree.blen[pool_leaf] == smoke.NT_POOL_BRANCH
    clade = {g.taxon for g in ing[:4]}
    short = [v for v in range(tree.n_nodes)
             if tree.blen[v] == smoke.PEPR_CLADE_BRANCH]
    assert len(short) == 2
    parent = int(tree.parent[short[0]])
    assert parent == int(tree.parent[short[1]])
    assert {tree.labels[v] for v in tree.descendant_leaves(parent)} == clade
    # the same draws as the protein tree, a third as long
    a = smoke.pepr_tree(np.random.default_rng(5))
    b = smoke.pepr_tree(np.random.default_rng(5), smoke.NT_BRANCH_SCALE)
    assert to_newick(a, lengths=False) == to_newick(b, lengths=False)
    keep = a.blen != smoke.PEPR_CLADE_BRANCH
    assert np.allclose(b.blen[keep], a.blen[keep] / 3, atol=1e-4,
                       equal_nan=True)
    s_in, s_pool, _ = smoke.nt_small_genomes(0)
    assert len(s_in) == 4 and max(len(x) for x in s_pool[0].seqs) == \
        smoke.NT_SMALL_LONG > 4096
    assert max(len(x) for g in s_in for x in g.seqs) <= \
        smoke.NT_SMALL_CLIP[1]


def test_nt_fasta_files_read_back(smoke, tmp_path):
    """nt_pepr's FASTA files read back to the same codes and titles
    through the port's nucleotide reader."""
    from pepr_tpu_torch.io.fasta import read_fasta
    ing, pool, _ = smoke.nt_small_genomes(3)
    files, pool_files = smoke.nt_pepr_files(ing, pool, str(tmp_path))
    for g, path in zip(ing + pool, files + pool_files):
        back = read_fasta(path, alphabet="nt")
        assert back.titles == g.titles and back.taxon == g.taxon
        assert all(np.array_equal(a, b) for a, b in zip(back.seqs, g.seqs))


def test_nt_small_rehearsal(smoke, tmp_path):
    """(d) The nt_small phase on the CPU: its run (the pool's long gene
    cut at packing, one refinement round, GTR, the pool genome selected)
    passes nt_small_checks against itself, and a run that differs in its
    groups, rounds or LL fails them."""
    runs, pool, _ = smoke.nt_small_runs(0, ["cpu"], str(tmp_path))
    run = runs[0]
    out = smoke.nt_small_checks(run, run, pool)
    assert out["refine_rounds"] == [1, 1] and out["rf"] == 0
    assert out["stage1_runs"] == [2, 2]
    res = run["res"]
    fewer = dict(run, stage1=run["stage1"][:1])
    with pytest.raises(SystemExit):
        smoke.nt_small_checks(run, fewer, pool)
    other = dict(run, res=dataclasses.replace(res, refine_rounds=2))
    with pytest.raises(SystemExit):
        smoke.nt_small_checks(run, other, pool)
    moved = dataclasses.replace(res, stage2=dataclasses.replace(
        res.stage2, log_likelihood=res.stage2.log_likelihood * (1 + 1e-4)))
    with pytest.raises(SystemExit):
        smoke.nt_small_checks(run, dict(run, res=moved), pool)


def _ortholog_recall(candidates, smoke):
    """(share of the pool's family genes whose candidate pairs hold a
    member of their own family, median length of the picked targets over
    the median target length) for nt_pepr_genomes' pool against the
    ingroup's family members as score_outgroups sets them up;
    `candidates(pool seqs, target seqs, offsets)` gives (pool indices,
    target indices)."""
    ing, pool, _ = smoke.nt_pepr_genomes(0)
    targets = [(t, s) for g in ing for t, s in zip(g.titles, g.seqs)
               if t.startswith("fam")]
    fam = [t.split("_")[0] for t, _ in targets]
    lens = np.array([len(s) for _, s in targets])
    query = [(t.split("_")[0], s) for t, s in zip(pool[0].titles,
                                                  pool[0].seqs)
             if t.startswith("fam")]
    n = len(targets)
    offsets = np.unique(np.append(np.arange(0, n, 4096), n))
    qs, ts = candidates([s for _, s in query], [s for _, s in targets],
                        offsets)
    hit = {int(a) for a, b in zip(qs, ts) if query[a][0] == fam[b]}
    return len(hit) / len(query), float(np.median(lens[ts])
                                        / np.median(lens))


def _cosine_top3(kmer_filter, **kw):
    """The JAX package's score_outgroups candidates: each pool protein's
    top 3 targets by the cosine of hashed 12-mer profiles."""
    def run(q, t, offsets):
        flat = np.asarray(kmer_filter.candidate_pairs(
            kmer_filter.kmer_profiles(q, k=12),
            kmer_filter.kmer_profiles(t, k=12), offsets, top_per_genome=3,
            **kw)[0]).reshape(len(q), -1)
        qs, col = np.nonzero(flat >= 0)
        return qs, flat[qs, col]
    return run


def test_f12_outgroup_candidates_at_gene_lengths(smoke, monkeypatch):
    """F12 (ROADMAP Queue 3), left as it is in both packages:
    score_outgroups scores by SW only each pool gene's top 3 targets by
    the cosine of hashed 12-mer profiles (1,024 dimensions).  A gene of
    ~900 nt fills most dimensions, so the cosine ranks the longest
    targets first: on nt_pepr_genomes (here 30 families) the top 3 hold
    the ortholog for few pool genes, and the picked targets are several
    times the median length.  The port's candidates are the JAX
    package's."""
    from pepr_tpu.ops import kmer_filter as jkf
    from pepr_tpu_torch.ops import kmer_filter as tkf
    monkeypatch.setattr(smoke, "NT_PEPR_FAMILIES", 30)
    monkeypatch.setattr(smoke, "NT_PEPR_RANDOM", 2)
    jax = _ortholog_recall(_cosine_top3(jkf), smoke)
    port = _ortholog_recall(_cosine_top3(tkf, device="cpu"), smoke)
    assert port == jax
    assert jax[0] < 0.2 and jax[1] > 3.0
