"""Stage 2's options through the port against the JAX package on the CPU,
beyond the seven cases of test_torch_trim_stage2.py: `run_stage2` with
a list of models for matrix evaluation, nj support trees, the `ml` full
tree, and the nucleotide alphabet with the congruence filter and the
`ml` full tree, each with the same families kept, model, topology (RF
0), LL (rel 1e-4, or None on both sides) and decorated Newick;
`run_pepr(alphabet="nt")` as tests/test_nt_pipeline.py drives it (the
species tree at the JAX package's RF, GTR); the CLI with `-tree_method
nj`, the congruence filter and matrix evaluation; and a rehearsal of
chip_smoke.py's stage2_options phase (option_runs) at a small size."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from pepr_tpu.io.fasta import SequenceSet as JSet
from pepr_tpu.pipeline.pepr import PeprConfig as JPeprConfig
from pepr_tpu.pipeline.pepr import run_pepr as j_run_pepr
from pepr_tpu.pipeline.stage2 import Stage2Config as JConfig
from pepr_tpu.pipeline.stage2 import run_stage2 as jrun
from pepr_tpu.tree import parse_newick as jparse
from pepr_tpu.tree import rf_distance as jrf

from pepr_tpu_torch.io.fasta import SequenceSet, write_fasta
from pepr_tpu_torch.models.msa import Alignment
from pepr_tpu_torch.pipeline import cli as tcli
from pepr_tpu_torch.pipeline.pepr import PeprConfig, run_pepr
from pepr_tpu_torch.pipeline.stage2 import Stage2Config, run_stage2
from pepr_tpu_torch.tree import parse_newick, rf_distance
from pepr_tpu_torch.utils.simulate import (random_tree, simulate_families,
                                           simulate_genomes)
from test_torch_trim_stage2 import same_stage2_result

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kw", [
    dict(matrix_evaluation=["BLOSUM62F", "WAG"]),
    dict(support_method="nj", support_reps=4),
    dict(full_tree_method="ml"),
    dict(alphabet="nt", congruence_filter=True, full_tree_method="ml"),
])
def test_run_stage2_option_matches_jax(smoke, kw):
    alphabet = kw.get("alphabet", "aa")
    sets = smoke.three_sequence_sets(
        np.random.default_rng(25 if alphabet == "aa" else 26),
        alphabet=alphabet)
    cfg = dict(smoke.SMALL_S2, **kw)
    want = jrun([JSet(s.name, s.titles, s.seqs) for s in sets],
                JConfig(**cfg))
    got = run_stage2(sets, Stage2Config(**cfg), device="cpu")
    same_stage2_result(got, want)
    if alphabet == "nt":
        assert got.model_name == "GTR"
        assert len(got.alignments) == 12 - int(12 * 0.1)


# -- run_pepr with the nucleotide alphabet (tests/test_nt_pipeline.py) -----

SPECIES_NWK = ("(((N1:0.04,N2:0.04):0.05,(N3:0.04,N4:0.05):0.04):0.08,"
               "(N5:0.06,N6:0.05):0.07,OGN:0.25);")


def _evolve(seq, t, rng):
    """Jukes-Cantor-ish: each site substitutes with prob 1-exp(-t)."""
    out = seq.copy()
    m = rng.random(len(seq)) < (1.0 - np.exp(-t))
    out[m] = rng.integers(0, 4, m.sum())
    return out


def _simulate_nt(tree, L, rng):
    states = {}
    root = int(np.nonzero(tree.parent < 0)[0][0])
    states[root] = rng.integers(0, 4, L).astype(np.int8)
    stack = [root]
    leaves = {}
    while stack:
        v = stack.pop()
        for k in tree.children[v]:
            b = tree.blen[k]
            b = 0.05 if not np.isfinite(b) else float(b)
            states[k] = _evolve(states[v], b, rng)
            if tree.children[k]:
                stack.append(k)
            else:
                leaves[tree.labels[k]] = states[k]
    return leaves


def _nt_config(cls, out_dir):
    cfg = cls(run_name="ntsim", out_dir=out_dir, refine=False,
              outgroup_count=1, alphabet="nt")
    cfg.min_taxa_multiplier = 0.8
    cfg.stage1.use_hmm = False
    cfg.stage2.support_reps = 4
    cfg.stage2.full_tree_method = "ml"
    cfg.stage2.nni_rounds = 4
    cfg.stage2.bl_steps = 40
    return cfg


@pytest.fixture(scope="module")
def nt_runs(tmp_path_factory):
    """tests/test_nt_pipeline.py's genomes (8 genes of 192 nt evolved
    down SPECIES_NWK, one outgroup-pool genome) through both packages."""
    rng = np.random.default_rng(99)
    species = parse_newick(SPECIES_NWK)
    taxa = sorted(species.leaf_labels())
    per_taxon = {t: [] for t in taxa}
    titles = {t: [] for t in taxa}
    for g in range(8):
        leaves = _simulate_nt(species, 192, rng)
        for t in taxa:
            per_taxon[t].append(leaves[t])
            titles[t].append(f"gene{g}_{t} family {g} [{t}]")
    ing = ("N1", "N2", "N3", "N4", "N5", "N6")
    got = run_pepr(
        _nt_config(PeprConfig, str(tmp_path_factory.mktemp("port"))),
        genomes=[SequenceSet(t, titles[t], per_taxon[t]) for t in ing],
        outgroup_pool=[SequenceSet("OGN", titles["OGN"],
                                   per_taxon["OGN"])], device="cpu")
    want = j_run_pepr(
        _nt_config(JPeprConfig, str(tmp_path_factory.mktemp("jax"))),
        genomes=[JSet(t, titles[t], per_taxon[t]) for t in ing],
        outgroup_pool=[JSet("OGN", titles["OGN"], per_taxon["OGN"])])
    return species, got, want


def test_nt_pipeline_recovers_the_species_tree_as_jax(nt_runs):
    species, got, want = nt_runs
    assert rf_distance(got.tree, species) == \
        jrf(want.tree, jparse(SPECIES_NWK)) == 0
    assert got.stage2.model_name == want.stage2.model_name == "GTR"
    assert got.selected_outgroups == want.selected_outgroups == ["OGN"]
    assert got.stage2.log_likelihood == pytest.approx(
        want.stage2.log_likelihood, rel=1e-4)


# -- the CLI ------------------------------------------------------------------

def test_cli_nj_with_congruence_filter_and_matrix_eval(tmp_path, capsys):
    """`main` on FASTA files with `-tree_method nj`, `-congruence_filter`
    and `-matrix_eval`, end to end on the CPU."""
    ing, pool, _ = simulate_genomes(
        np.random.default_rng(62), n_ingroup=4, n_families=16, n_random=2,
        median_len=80.0, max_len=120, n_long=0)
    files = []
    for g in ing + pool:
        files.append(str(tmp_path / f"{g.taxon}.faa"))
        write_fasta(files[-1], g)
    out = tmp_path / "out"
    argv = ["-run_name", "cli", "-genome_file", *files[:-1],
            "-outgroup", files[-1], "-outgroup_count", "1",
            "-tree_method", "nj", "-congruence_filter", "true",
            "-matrix_eval", "WAG,BLOSUM62", "-support_reps", "3",
            "-refine", "false", "-out_dir", str(out), "-device", "cpu"]
    cfg = tcli.config_from_args(argv)
    assert cfg.stage2.full_tree_method == "nj"
    assert cfg.stage2.congruence_filter
    assert cfg.stage2.matrix_evaluation == ["WAG", "BLOSUM62"]
    assert tcli.main(argv) == 0
    tree = parse_newick(capsys.readouterr().out.strip().splitlines()[-1])
    leaves = set(tree.leaf_labels())
    assert {g.taxon for g in ing} <= leaves <= {g.taxon for g in ing + pool}
    assert sorted(os.listdir(out)) == sorted(
        f"cli{s}" for s in ("_final_rooted.nwk", "_final_rooted.json",
                            ".nwk", ".sup", ".hs", ".clp", ".report.xml"))


# -- chip_smoke.py's stage2_options phase, rehearsed ------------------------

def test_stage2_options_rehearsal(smoke):
    """option_runs on the CPU at 10 taxa: 10 protein families for A and
    B, 6 nucleotide families for C, 2 replicates, an NNI cap of 5 and
    constraint clades of 2-4 leaves; the phase's own checks fail a broken
    path.  Also the nucleotide generator and the constraint helpers."""
    rng = np.random.default_rng(71)
    taxa = [f"taxon{i:02d}" for i in range(10)]
    truth = random_tree(taxa, rng)
    fams = simulate_families(truth, rng.integers(40, 70, size=10), rng,
                             alpha=0.5, absent=0.1)
    nt = smoke.nt_families(truth, rng.integers(100, 150, size=6), rng)
    for _, t, c in nt:
        assert c.dtype == np.int8 and c.max() <= 3 and len(t) >= 4
    nt_sets, _ = smoke.unaligned_families(nt, rng)
    out = smoke.option_runs([Alignment(n, t, c) for n, t, c in fams],
                            nt_sets, truth, torch.device("cpu"), 2, 2, 5,
                            clade_sizes=(2, 4))
    assert out["a"]["families_kept"] == 9
    assert out["a"]["model_name"] == out["res_a"].model_name
    assert out["a"]["fitch"]["batches"] > 0
    assert out["b"]["constrained_ml"]["incompatible"] == 0
    assert out["b"]["constrained_ml"]["truncation"]
    assert out["c"]["model_name"] == "GTR"
    assert float(out["model_c"].pi[4:].max()) < 1e-9
    # B's bootstrap block as the card phase gives it to the kernels:
    # compacted codes, every replicate's integer column counts (summing
    # to the concatenation's length) carried through
    cat = out["res_a"].concat
    codes_b, w_b, ch_b, pm_b = smoke.bootstrap_block(
        cat, out["boot"], out["boot_seed"], out["model_a"],
        torch.device("cpu"))
    assert codes_b.dim() == 3
    assert codes_b.shape[0] == w_b.shape[0] == ch_b.shape[0] \
        == pm_b.shape[0] == len(out["boot"])
    assert float(w_b.max()) >= 2 and torch.equal(w_b, w_b.round())
    assert w_b.sum(dim=1).tolist() == [float(cat.length)] * len(out["boot"])
    clades = smoke.constraint_clades(truth, 4, (2, 4))
    cons = smoke.constraint_tree(sorted(taxa), clades)
    assert sorted(cons.leaf_labels()) == sorted(taxa)
    assert len(clades) == 4 and all(2 <= len(c) <= 4 for c in clades)
    assert len({x for c in clades for x in c}) == sum(map(len, clades))
