"""The reference's real example runs (conformance/aqu_ckpt and
conformance/ery_ckpt, exported JAX-free to realdata/ by
tests/torch_realdata_export.py) through the port's stage 2 on the CPU.

- The export equals the pickles bit for bit, and chip_smoke.load_realdata
  reads it back into the JAX run's families.
- The first AQU_FAMILIES Aquificales families through the port's
  run_stage2_aligned and the JAX package's run_stage2 (resumed from a
  store whose "alignments" key holds them, the same tail as
  tests/test_torch_stage2.py), fast_ml with AQU_REPS replicates: the
  same Gamma shape (1e-3), LL (rel 1e-4), full-tree topology and
  replicate topologies (RF 0) and supports (identical); and
  chip_smoke.real_data_compare on that pair.  48 families took 24 s in
  the port and 134 s in JAX on a CPU, so the test takes 16 (about 3,000
  columns; ~90 s for the file alone).
- (slow) The whole of both runs at full width under the JAX run's
  stage-2 configuration, cut for the CPU (`fast_ml`, SLOW_REPS
  replicates), held by
  chip_smoke.real_data_compare against the JAX run's results (its
  tolerances: the Gamma shape within REAL_ALPHA_ATOL; every JAX split of
  at least REAL_SPLIT_MIN kept, or the port's tree at least as likely
  under the port's likelihood; the replicates the JAX run's topologies
  with its supports; not the LL, the JAX run's full tree being `ml`);
  the comparisons are printed.
"""

import json
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

from pepr_tpu.io.fasta import SequenceSet as JSet
from pepr_tpu.models.msa import Alignment as JAlignment
from pepr_tpu.pipeline.checkpoint import CheckpointStore
from pepr_tpu.pipeline.stage2 import Stage2Config as JConfig
from pepr_tpu.pipeline.stage2 import run_stage2 as j_run_stage2
from pepr_tpu.tree import to_newick as j_to_newick

from pepr_tpu_torch.pipeline.stage2 import run_stage2_aligned
from pepr_tpu_torch.tree import parse_newick, rf_distance, to_newick

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
try:
    import chip_smoke
    import torch_realdata_export as export
finally:
    sys.path.remove(ROOT)
    sys.path.remove(os.path.join(ROOT, "tests"))

AQU_FAMILIES = 16
AQU_REPS = 2
SLOW_REPS = 2
SLOW_REFIT = 30

torch.set_num_threads(2)


def _pickles_present(run):
    return os.path.exists(os.path.join(ROOT, "conformance", f"{run}_ckpt",
                                       "alignments.pkl"))


@pytest.mark.parametrize("run", export.RUNS)
def test_export_equals_the_pickles(run):
    """A re-export in memory against the committed files: every array
    bit for bit (dtype and values), the .json object equal."""
    if not _pickles_present(run):
        pytest.skip(f"conformance/{run}_ckpt is not present")
    arrays, meta = export.export(run)
    with np.load(os.path.join(ROOT, "realdata", f"{run}.npz")) as d:
        assert sorted(d.files) == sorted(arrays)
        for k, v in arrays.items():
            assert d[k].dtype == v.dtype and np.array_equal(d[k], v), k
    with open(os.path.join(ROOT, "realdata", f"{run}.json")) as fh:
        assert json.load(fh) == json.loads(json.dumps(meta))
    assert meta["families"] == {"aqu": 673, "ery": 528}[run]
    assert meta["columns"] == {"aqu": 185239, "ery": 154086}[run]
    assert meta["taxa"] == 12 and len(meta["support_trees"]) == 100


@pytest.mark.parametrize("run", export.RUNS)
def test_load_realdata_gives_the_jax_runs_families(run):
    if not _pickles_present(run):
        pytest.skip(f"conformance/{run}_ckpt is not present")
    import pickle
    with open(os.path.join(ROOT, "conformance", f"{run}_ckpt",
                           "alignments.pkl"), "rb") as fh:
        want = pickle.load(fh)
    got, meta = chip_smoke.load_realdata(run)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.name == b.name and a.taxa == b.taxa
        assert a.titles == b.titles
        assert a.mat.dtype == np.int8 and np.array_equal(a.mat, b.mat)
    cfg = chip_smoke.real_config(meta, 7)
    assert (cfg.full_tree_method, cfg.support_method, cfg.support_reps,
            cfg.seed, cfg.bl_steps) == ("ml", "fast_ml", 7, 12345, 200)


@pytest.fixture(scope="module")
def first_families():
    alns, meta = chip_smoke.load_realdata("aqu")
    alns = alns[:AQU_FAMILIES]
    kw = dict(reps=AQU_REPS, full_tree_method="fast_ml")
    got = run_stage2_aligned(alns, chip_smoke.real_config(meta, **kw),
                             device="cpu")
    jal = [JAlignment(a.name, a.taxa, a.mat, titles=a.titles) for a in alns]
    with tempfile.TemporaryDirectory() as tmp:
        store = CheckpointStore(tmp)
        store.save("alignments", jal)
        sets = [JSet(a.name, [f"p{i} [{x}]" for i, x in enumerate(a.taxa)],
                     list(a.mat)) for a in jal]
        want = j_run_stage2(sets, JConfig(**dict(
            meta["stage2"], support_reps=AQU_REPS,
            full_tree_method="fast_ml")), store=store)
    return alns, meta, got, want


def test_first_families_alpha_and_likelihood(first_families):
    _, _, got, want = first_families
    assert got.concat.length == want.concat.length > 1500
    np.testing.assert_array_equal(got.concat.mat, want.concat.mat)
    assert got.gamma_alpha == pytest.approx(want.gamma_alpha, abs=1e-3)
    assert got.log_likelihood == pytest.approx(want.log_likelihood,
                                               rel=1e-4)


def test_first_families_trees_and_supports(first_families):
    _, _, got, want = first_families
    assert rf_distance(got.full_tree,
                       parse_newick(j_to_newick(want.full_tree))) == 0
    assert len(got.support_trees) == len(want.support_trees) == AQU_REPS
    for a, b in zip(got.support_trees, want.support_trees):
        assert rf_distance(a, parse_newick(j_to_newick(b))) == 0
    assert to_newick(got.tree, lengths=False) == \
        j_to_newick(want.tree, lengths=False)


def test_real_data_compare_rehearsal(first_families):
    """chip_smoke.real_data_compare on the port's run against a record
    of the JAX run of the same families, in the form of realdata/*.json:
    every comparison made, none failing."""
    _, meta, got, want = first_families
    small = dict(meta, full_tree=dict(newick=j_to_newick(want.full_tree),
                                      log_likelihood=want.log_likelihood),
                 gamma_alpha=want.gamma_alpha,
                 support_trees=[j_to_newick(t) for t in want.support_trees])
    out = chip_smoke.real_data_compare(got, small, AQU_REPS, "cpu")
    assert out["full_tree"]["rf"] == out["full_tree"]["rf_long"] == 0
    assert out["full_tree"]["splits"] == 9
    assert abs(out["gamma_alpha"]["diff"]) <= 1e-3
    lls = out["log_likelihood"]
    assert lls["port"] == pytest.approx(lls["jax_tree_jax_lengths"],
                                        rel=1e-5)
    assert lls["jax_tree_refit"] == pytest.approx(lls["port"], rel=1e-5)
    rep = out["replicates"]
    assert rep["identical_topologies"] == AQU_REPS
    assert rep["max_support_diff"] == 0
    assert len(rep["supports_on_jax_splits"]["rows"]) == 9


def test_split_agreement_counts_short_splits_apart():
    """split_agreement on the JAX aqu tree: against itself and FastTree's
    tree (the same splits: the oracle file's RF of 2 is to the pipeline's
    final tree, after refinement); with two taxa of the near-zero
    Hydrogenobaculum splits swapped (RF > 0, none of them 1e-4 long);
    with two taxa of long splits swapped."""
    _, aqu = chip_smoke.load_realdata("aqu")
    nwk = aqu["full_tree"]["newick"]
    jt = parse_newick(nwk)
    same = chip_smoke.split_agreement(jt, jt, 1e-4)
    assert same["rf"] == same["rf_long"] == 0 and same["splits"] == 9
    assert same["long_splits"] == 9 - len(same["short_lengths"]) < 9
    ft = parse_newick(aqu["oracle"]["fasttree_newick"])
    vs_ft = chip_smoke.split_agreement(ft, jt, 1e-4)
    assert vs_ft["rf"] == vs_ft["rf_long"] == 0

    def swapped(a, b):
        return parse_newick(nwk.replace(a, "@").replace(b, a)
                            .replace("@", b))

    short = chip_smoke.split_agreement(
        swapped("Hydrogenobaculum_sp._SN", "Hydrogenobaculum_sp._HO"), jt,
        1e-4)
    assert short["rf"] > 0 and short["rf_long"] == 0
    long = chip_smoke.split_agreement(
        swapped("Aquifex_aeolicus_VF5", "Persephonella_marina_EX-H1"), jt,
        1e-4)
    assert long["rf"] > 0 and long["rf_long"] > 0


@pytest.mark.slow
@pytest.mark.parametrize("run", export.RUNS)
def test_whole_run_against_the_jax_run(run, capsys):
    """The whole of a reference run through the port's stage 2 on the
    CPU, full width, against the JAX run's results; real_data_compare
    fails on its own tolerances.  Cut for the CPU, where one Adam step
    at 185,239 columns takes ~3 s: the `fast_ml` full tree (the card
    runs the JAX run's `ml`), SLOW_REPS replicates, the JAX tree refitted
    for SLOW_REFIT steps from its own lengths."""
    torch.set_num_threads(max(2, (os.cpu_count() or 2) // 2))
    alns, meta = chip_smoke.load_realdata(run)
    res = run_stage2_aligned(alns, chip_smoke.real_config(
        meta, SLOW_REPS, full_tree_method="fast_ml"), device="cpu")
    # the LL is not held to the JAX run's: its full tree was `ml`
    out = chip_smoke.real_data_compare(res, meta, SLOW_REPS, "cpu",
                                       refit_steps=SLOW_REFIT, ll_rtol=None)
    with capsys.disabled():
        print(f"\n{run}: " + json.dumps(dict(out, timings=res.timings)))
    assert out["columns"] == meta["columns"]
    assert out["full_tree"]["rf_long"] == 0 or \
        out["log_likelihood"]["port_minus_jax_refit"] >= 0
    assert abs(out["gamma_alpha"]["diff"]) <= chip_smoke.REAL_ALPHA_ATOL
