"""The port's top level (pepr_tpu_torch.pipeline: refine, reports, pepr,
cli; utils/cli) against the JAX package on the CPU, and a rehearsal of
chip_smoke.py's pepr input.

Tolerances: refinement candidates, grafts and refined trees identical
(Newick strings); output files byte for byte, but for the report's
elapsed seconds; parsed CLI configurations equal field by field.
run_pepr end to end: the same rooted topology, supports, selected
outgroups, refinement round and file set, branch lengths within 1e-5
(the ML fits are float32 sums in another order), and within 1e-4 + 1e-3
relative in the support trees (60 Adam steps a replicate)."""

import dataclasses
import functools
import importlib.util
import math
import os
import re

import numpy as np
import pytest
import torch

import pepr_tpu.models.hmm_enhancer as jenh
from pepr_tpu.io.fasta import SequenceSet as JSet
from pepr_tpu.pipeline import cli as jcli
from pepr_tpu.pipeline import refine as jref
from pepr_tpu.pipeline import reports as jrep
from pepr_tpu.pipeline.pepr import PeprConfig as JPeprConfig
from pepr_tpu.pipeline.pepr import run_pepr as j_run_pepr
from pepr_tpu.tree import parse_newick as j_parse
from pepr_tpu.tree import to_newick as j_newick

from pepr_tpu_torch.io.fasta import write_fasta
from pepr_tpu_torch.pipeline import cli as tcli
from pepr_tpu_torch.pipeline import refine as tref
from pepr_tpu_torch.pipeline import reports as trep
from pepr_tpu_torch.pipeline.checkpoint import Incomplete
from pepr_tpu_torch.pipeline.pepr import PeprConfig, run_pepr
from pepr_tpu_torch.tree import parse_newick, rf_distance, to_newick
from pepr_tpu_torch.utils.cli import RunProperties
from pepr_tpu_torch.utils.simulate import random_tree, simulate_genomes

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_sets(sets):
    return [JSet(s.name, list(s.titles), list(s.seqs)) for s in sets]


def _supported_newick(rng, n: int, low: float = 0.3) -> str:
    """A random tree over n taxa with supports: 100 on most internal
    edges, a random lower value on a fraction `low` of them."""
    t = random_tree([f"T{i}" for i in range(n)], rng)
    for v in range(t.n_nodes):
        if not t.is_leaf(v):
            t.support[v] = float(rng.integers(10, 100)) \
                if rng.random() < low else 100.0
    return to_newick(t)


# -- refinement ----------------------------------------------------------

@pytest.mark.parametrize("seed", [31, 32, 33, 34, 35])
def test_next_refine_candidate_matches_jax(seed):
    rng = np.random.default_rng(seed)
    nwk = _supported_newick(rng, int(rng.integers(6, 16)))
    t, j = parse_newick(nwk), j_parse(nwk)
    got_sets, want_sets = set(), set()
    for _ in range(8):  # every candidate in turn, as the loop probes
        a = tref.next_refine_candidate(t, 100.0, got_sets)
        b = jref.next_refine_candidate(j, 100.0, want_sets)
        assert (a is None) == (b is None)
        if a is None:
            break
        assert (a.node, a.ingroup, a.outgroup) == \
            (b.node, b.ingroup, b.outgroup)
        assert got_sets == want_sets


def _subtree_runner(parse, newick):
    """A stub sub-run: a seeded random tree over the candidate's
    ingroup and up to two of its outgroup taxa, all supports 100."""
    calls = []

    def run(ingroup, outgroup, round_idx):
        calls.append((list(ingroup), list(outgroup), round_idx))
        rng = np.random.default_rng(100 + round_idx)
        t = random_tree(sorted(ingroup) + sorted(outgroup)[:2], rng)
        for v in range(t.n_nodes):
            if not t.is_leaf(v):
                t.support[v] = 100.0
        return parse(to_newick(t))
    return run, calls


@pytest.mark.parametrize("seed", [41, 42, 43, 44])
def test_refine_tree_and_graft_match_jax(seed):
    rng = np.random.default_rng(seed)
    nwk = _supported_newick(rng, int(rng.integers(8, 14)), low=0.5)
    outgroup = ["T0"]
    run_t, calls_t = _subtree_runner(parse_newick, nwk)
    run_j, calls_j = _subtree_runner(j_parse, nwk)
    got = tref.refine_tree(parse_newick(nwk), outgroup, run_t, cutoff=100.0,
                           max_rounds=4)
    want = jref.refine_tree(j_parse(nwk), outgroup, run_j, cutoff=100.0,
                            max_rounds=4)
    assert calls_t == calls_j
    assert to_newick(got) == j_newick(want)
    # one graft on its own
    cand = tref.next_refine_candidate(parse_newick(nwk), 100.0, set())
    if cand is not None:
        sub = run_t(cand.ingroup, cand.outgroup, 9)
        g = tref.graft_refined_subtree(parse_newick(nwk), sub, cand.outgroup)
        w = jref.graft_refined_subtree(j_parse(nwk), j_parse(to_newick(sub)),
                                       cand.outgroup)
        assert to_newick(g) == j_newick(w)


def test_refine_loop_grafts_once():
    """tests/test_refine_loop.py's case on the port."""
    start = parse_newick(
        "(((A:1,B:1)40:1,C:1)100:1,((D:1,E:1)100:1,F:1)100:1,G:1);")

    def run_subtree(ingroup, outgroup, round_idx):
        return parse_newick(f"((B:1,C:1)100:1,A:1,{outgroup[0]}:1);")

    out = tref.refine_tree(start, ["G"], run_subtree, cutoff=100,
                           max_rounds=5)
    assert sorted(out.leaf_labels()) == list("ABCDEFG")
    assert rf_distance(out, parse_newick(
        "(((B:1,C:1):1,A:1):1,((D:1,E:1):1,F:1):1,G:1);")) == 0


# -- reports -------------------------------------------------------------

def _elapsed_free(text: str) -> str:
    return re.sub(r'elapsed_seconds="[0-9.]+"', 'elapsed_seconds=""', text)


def test_write_outputs_byte_for_byte(tmp_path):
    rng = np.random.default_rng(51)
    nwk = _supported_newick(rng, 9)
    sup = [to_newick(random_tree([f"T{i}" for i in range(9)], rng))
           for _ in range(3)]
    paths = {}
    for name, mod, parse in (("port", trep, parse_newick),
                             ("jax", jrep, j_parse)):
        tracker = mod.RunTracker("run<&>")
        rec = tracker.new_round("round_1")
        rec.update(taxa=["T0", "T1 & T2"], genes=12, aligned_positions=3456,
                   trimmed_positions=3000, tree_method="ml",
                   support_method="fast_ml", tree=nwk,
                   wall_seconds={"homology_search": 1.5, "mcl": 0.25},
                   outgroups=["T0"], gamma_alpha=0.4321987,
                   substitution_model="WAG")
        sub = tracker.new_round("refine_1")
        sub.update(taxa=["T3"], tree=sup[0])
        paths[name] = mod.write_outputs(
            str(tmp_path / name), "run", tracker, parse(nwk),
            support_trees=[parse(x) for x in sup], hs_text="a\tb\n",
            clp_args=["-run_name", "run", "-refine", "true"])
    assert set(paths["port"]) == set(paths["jax"]) == {
        "_final_rooted.nwk", "_final_rooted.json", ".nwk", ".sup", ".hs",
        ".clp", ".report.xml"}
    for sfx in paths["port"]:
        with open(paths["port"][sfx]) as a, open(paths["jax"][sfx]) as b:
            got, want = a.read(), b.read()
        if sfx == ".report.xml":
            got, want = _elapsed_free(got), _elapsed_free(want)
        assert got == want, sfx


def test_tree_to_json_matches_jax():
    rng = np.random.default_rng(52)
    for n in (3, 7, 12):
        nwk = _supported_newick(rng, n)
        assert trep.tree_to_json(parse_newick(nwk)) == \
            jrep.tree_to_json(j_parse(nwk))


# -- the command line ----------------------------------------------------

ARGVS = [
    ["-run_name", "x", "-genome_file", "a.faa", "b.faa", "-outgroup",
     "o.faa", "-outgroup_count", "1"],
    ["-genome_file", "a.faa", "-track", "fast", "-support_reps", "50",
     "-refine", "false", "-mcl_inflation", "2.0", "-min_taxa", "4"],
    ["-genome_file", "a.faa", "-track", "blat_raxml", "-tree_method",
     "fasttree", "-hmm", "false", "-unique_species", "false",
     "-min_taxa_multiplier", "0.5", "-target_ntax", "30", "-out_dir", "o"],
    ["-genome_file", "a.faa", "-track", "custom", "-matrix_eval",
     "WAG,LG", "-congruence_filter", "-refine_cutoff", "90",
     "-max_taxa", "20", "-homology_search_method", "hits.b8"],
    ["-genome_file", "a.faa", "-nt", "-matrix_eval", "-checkpoint", "ck",
     "-time_budget", "60", "-bidirectional", "false"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_cli_parses_like_the_reference(argv):
    got = dataclasses.asdict(tcli.config_from_args(argv))
    want = dataclasses.asdict(jcli.config_from_args(argv))
    assert got == want
    # and the nested stage configs keep their alphabet (repr=False fields)
    assert tcli.config_from_args(argv).stage2.alphabet == \
        jcli.config_from_args(argv).stage2.alphabet


def test_cli_conf_file_and_run_properties(tmp_path):
    conf = tmp_path / "run.conf"
    RunProperties(["-support_reps", "7", "-refine", "false"]).save(str(conf))
    argv = ["-conf", str(conf), "-genome_file", "a.faa", "-refine", "true"]
    got = tcli.config_from_args(argv)
    assert dataclasses.asdict(got) == \
        dataclasses.asdict(jcli.config_from_args(argv))
    assert got.stage2.support_reps == 7 and got.refine is True


def test_cli_main_passes_the_device(monkeypatch, capsys):
    seen = {}

    class Result:
        newick = "(a,b);"
        output_paths = {".nwk": "x.nwk"}

    def fake_run(cfg, device=None):
        seen.update(cfg=cfg, device=device)
        return Result()

    monkeypatch.setattr(tcli, "run_pepr", fake_run)
    assert tcli.main(["-genome_file", "g.faa", "-device", "cpu",
                      "-run_name", "r"]) == 0
    assert seen["device"] == "cpu" and seen["cfg"].run_name == "r"
    assert capsys.readouterr().out.strip() == "(a,b);"
    assert tcli.main(["-run_name", "r"]) == 2  # no genomes
    assert tcli.main(["-h"]) == 0
    assert "pepr_tpu_torch.pipeline.cli" in capsys.readouterr().out


def test_cli_runs_the_pipeline_on_the_cpu(tmp_path, capsys):
    """`main` on FASTA files, end to end on the CPU (no refinement, the
    default cutoff of 144 bits)."""
    ing, pool, _ = simulate_genomes(
        np.random.default_rng(61), n_ingroup=4, n_families=16, n_random=2,
        median_len=80.0, max_len=120, n_long=0)
    files = []
    for g in ing + pool:
        files.append(str(tmp_path / f"{g.taxon}.faa"))
        write_fasta(files[-1], g)
    out = tmp_path / "out"
    rc = tcli.main(["-run_name", "cli", "-genome_file", *files[:-1],
                    "-outgroup", files[-1], "-outgroup_count", "1",
                    "-track", "fast", "-support_reps", "3", "-refine",
                    "false", "-out_dir", str(out), "-device", "cpu"])
    assert rc == 0
    tree = parse_newick(capsys.readouterr().out.strip().splitlines()[-1])
    leaves = set(tree.leaf_labels())
    assert {g.taxon for g in ing} <= leaves <= {g.taxon for g in ing + pool}
    assert sorted(os.listdir(out)) == sorted(
        f"cli{s}" for s in ("_final_rooted.nwk", "_final_rooted.json",
                            ".nwk", ".sup", ".hs", ".clp", ".report.xml"))


def test_cli_stops_and_resumes_with_checkpoint_and_time_budget(tmp_path,
                                                              capsys):
    """`-checkpoint DIR -time_budget 0` stops at the first poll with
    Incomplete (it propagates, as from the JAX CLI); the same command
    without the budget resumes and prints the tree a run without a
    checkpoint prints."""
    ing, pool, _ = simulate_genomes(
        np.random.default_rng(62), n_ingroup=4, n_families=12, n_random=2,
        median_len=80.0, max_len=120, n_long=0)
    files = []
    for g in ing + pool:
        files.append(str(tmp_path / f"{g.taxon}.faa"))
        write_fasta(files[-1], g)
    argv = ["-run_name", "cli", "-genome_file", *files[:-1], "-outgroup",
            files[-1], "-outgroup_count", "1", "-track", "fast",
            "-support_reps", "3", "-refine", "false", "-device", "cpu"]
    ck = ["-checkpoint", str(tmp_path / "ck")]
    with pytest.raises(Incomplete):
        tcli.main(argv + ck + ["-time_budget", "0", "-out_dir",
                               str(tmp_path / "a")])
    capsys.readouterr()
    newick = []
    for extra in (ck, []):
        assert tcli.main(argv + extra + ["-out_dir", str(tmp_path / "b")]) \
            == 0
        newick.append(capsys.readouterr().out.strip().splitlines()[-1])
    assert newick[0] == newick[1]
    assert "stage1.pkl" in os.listdir(tmp_path / "ck")


# -- run_pepr end to end against the JAX package --------------------------

REPS = 4


def _config(cls, out_dir):
    """The default track at a small depth: fast_ml, REPS replicates, the
    refinement cutoff at REPS (supports are replicate counts), and 40
    bits for these short proteins."""
    cfg = cls.default_track(run_name="small", out_dir=out_dir)
    cfg.stage1.hmm_min_bits = 40.0
    cfg.stage2.full_tree_method = "fast_ml"
    cfg.stage2.support_reps = REPS
    cfg.refine_cutoff = float(REPS)
    return cfg


def _small_input():
    """5 ingroup genomes of ~34 proteins under 128 residues and a pool
    genome; the generating tree's clade (0, 1, 2) has an internal branch
    of 1e-5, which leaves its support below REPS and forces one
    refinement round."""
    g = [f"Synthica_spec{i:02d}_strain_X" for i in range(5)]
    tree = parse_newick(f"((({g[0]}:0.05,{g[1]}:0.05):0.00001,{g[2]}:0.05)"
                        f":0.08,({g[3]}:0.06,{g[4]}:0.07):0.08);")
    ing, pool, _ = simulate_genomes(
        np.random.default_rng(5), n_ingroup=5, n_pool=1, n_families=30,
        n_random=4, median_len=90.0, max_len=127, n_long=0,
        ingroup_tree=tree)
    return ing, pool


@pytest.fixture(scope="module")
def small_runs(tmp_path_factory):
    """The port's and the JAX package's runs on `_small_input`."""
    ing, pool = _small_input()
    d_t = str(tmp_path_factory.mktemp("port"))
    d_j = str(tmp_path_factory.mktemp("jax"))
    got = run_pepr(_config(PeprConfig, d_t), genomes=ing,
                   outgroup_pool=pool, device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(jenh, "profile_score_pairs", functools.partial(
        jenh.profile_score_pairs, batch_size=64))
    try:
        want = j_run_pepr(_config(JPeprConfig, d_j), genomes=_jax_sets(ing),
                          outgroup_pool=_jax_sets(pool))
    finally:
        mp.undo()
    return got, want, d_t, d_j


def _same_tree(a, b, atol=1e-5, rtol=1e-5):
    """The same rooted topology and supports (Newick without lengths),
    branch lengths within atol + rtol in preorder."""
    assert to_newick(a, lengths=False) == j_newick(b, lengths=False)
    ba = [x for x in np.asarray(a.blen)[a.preorder()] if not math.isnan(x)]
    bb = [x for x in np.asarray(b.blen)[b.preorder()] if not math.isnan(x)]
    np.testing.assert_allclose(ba, bb, atol=atol, rtol=rtol)


def test_run_pepr_matches_jax(small_runs):
    got, want, _, _ = small_runs
    assert got.refine_rounds == 1
    _same_tree(got.tree, want.tree)
    assert got.selected_outgroups == want.selected_outgroups == \
        ["Outgroupia_outg0_strain_Y"]
    assert got.stage2.concat.taxa == want.stage2.concat.taxa
    assert got.stage2.concat.n_genes == want.stage2.concat.n_genes
    assert set(got.timings) == {"stage1", "stage2", "refine", "write"}
    assert got.stage1_counts["hmm_prefilter_pairs"] > 0


def test_run_pepr_files_match_jax(small_runs):
    got, want, d_t, d_j = small_runs
    assert sorted(os.listdir(d_t)) == sorted(os.listdir(d_j)) == sorted(
        f"small{s}" for s in ("_final_rooted.nwk", "_final_rooted.json",
                              ".nwk", ".sup", ".hs", ".clp", ".report.xml"))

    def read(d, sfx):
        with open(os.path.join(d, f"small{sfx}")) as fh:
            return fh.read()

    for sfx in (".hs", ".clp"):
        assert read(d_t, sfx) == read(d_j, sfx), sfx
    _same_tree(parse_newick(read(d_t, ".nwk")), j_parse(read(d_j, ".nwk")))
    sup_t = read(d_t, ".sup").split()
    sup_j = read(d_j, ".sup").split()
    assert len(sup_t) == len(sup_j) == REPS
    for a, b in zip(sup_t, sup_j):
        # replicate fits take 60 float32 Adam steps (support_bl_steps):
        # their branch lengths drift further apart than the full tree's
        _same_tree(parse_newick(a), j_parse(b), atol=1e-4, rtol=1e-3)

    def skeleton(xml):
        # the report without wall seconds and Newick strings
        keep = [ln for ln in _elapsed_free(xml).splitlines()
                if "<timing " not in ln and "<tree>" not in ln
                and "<final_tree>" not in ln]
        return "\n".join(keep)

    assert skeleton(read(d_t, ".report.xml")) == \
        skeleton(read(d_j, ".report.xml"))
    assert "refine_1" in read(d_t, ".report.xml")


def test_run_pepr_accepts_checkpoint_and_time_budget(small_runs, tmp_path):
    """run_pepr with `checkpoint_dir` and `time_budget=0.0` stops at its
    first poll (tests/test_checkpoint.py's case); the same configuration
    without the budget resumes the store to the uninterrupted port run's
    tree, LL and files byte for byte (but the report's seconds), and so
    to the JAX package's run under `_same_tree`."""
    got, want, d_t, _ = small_runs
    ing, pool = _small_input()
    ck, out = str(tmp_path / "ck"), str(tmp_path / "out")
    cfg = _config(PeprConfig, out)
    cfg.checkpoint_dir, cfg.time_budget = ck, 0.0
    with pytest.raises(Incomplete) as stop:
        run_pepr(cfg, genomes=ing, outgroup_pool=pool, device="cpu")
    assert stop.value.stage == "homology SW"
    cfg.time_budget = None
    res = run_pepr(cfg, genomes=ing, outgroup_pool=pool, device="cpu")
    assert res.newick == got.newick
    assert res.stage2.log_likelihood == got.stage2.log_likelihood
    assert res.refine_rounds == 1 and res.stage1_counts == got.stage1_counts
    assert os.path.isdir(os.path.join(ck, "sub1"))
    for sfx in (".nwk", "_final_rooted.nwk", "_final_rooted.json", ".sup",
                ".hs", ".clp", ".report.xml"):
        with open(os.path.join(out, f"small{sfx}")) as a, \
                open(os.path.join(d_t, f"small{sfx}")) as b:
            x, y = a.read(), b.read()
        if sfx == ".report.xml":
            # wall seconds; a resumed stage's sub-phases are its load
            x, y = ("\n".join(ln for ln in _elapsed_free(z).splitlines()
                              if "<timing " not in ln) for z in (x, y))
        assert x == y, sfx
    _same_tree(res.tree, want.tree)


# -- chip_smoke.py's pepr input ------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pepr_genomes_plant_one_refinable_clade(smoke, monkeypatch):
    """The generating tree of the pepr phase, with the supports the
    planted branches should get (the clade's two internal edges below
    100, every other edge 100): the refinement loop takes exactly one
    round, on the four clade genomes, with their sibling pair as the
    sub-run's outgroup pool."""
    monkeypatch.setattr(smoke, "S1_FAMILIES", 20)
    monkeypatch.setattr(smoke, "S1_RANDOM", 2)
    ing, pool, tree = smoke.pepr_genomes(0)
    assert len(ing) == smoke.S1_INGROUP and len(pool) == smoke.S1_POOL
    assert sorted(tree.leaf_labels()) == sorted(g.taxon for g in ing + pool)
    clade = {g.taxon for g in ing[:4]}
    from pepr_tpu_torch.tree import root_by_outgroup, unroot
    t = root_by_outgroup(unroot(tree), [pool[0].taxon])
    for v in range(t.n_nodes):
        if t.is_leaf(v):
            continue
        short = t.blen[v] == smoke.PEPR_CLADE_BRANCH
        t.support[v] = 50.0 if short else 100.0
    calls = []

    def run(ingroup, outgroup, round_idx):
        calls.append((sorted(ingroup), sorted(outgroup)))
        sub = parse_newick(to_newick(random_tree(
            sorted(ingroup) + sorted(outgroup), np.random.default_rng(0))))
        for v in range(sub.n_nodes):
            if not sub.is_leaf(v):
                sub.support[v] = 100.0
        return sub

    tref.refine_tree(t, [pool[0].taxon], run, cutoff=100.0)
    assert calls == [(sorted(clade), sorted(g.taxon for g in ing[4:6]))]
