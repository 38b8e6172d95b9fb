"""The port's trimming (ops/trim.py) and stage 2 from homolog groups
(pipeline/stage2.run_stage2) against the JAX package's, on the CPU.

Trimming: every function identical on seeded random alignments with
gaps and on simulated alignments with seeded gap runs.  Stage 2: the
fixture of chip_smoke.py's small_align phase (`three_sequence_sets`:
3-sequence families over 6 taxa, seeded deletions; `SMALL_S2`:
min_taxa 3, fast_ml, 3 replicates, 2 NNI rounds) through both
packages' `run_stage2`: identical trimmed alignments, the same topology
(RF 0), LL within 1e-4 relative and identical supports.  Families of 3
sequences keep every profile value at 0, 1/2 or 1, which the
reference's bfloat16 profiles hold exactly.
"""

import importlib.util
import os
import pickle

import numpy as np
import pytest
import torch

from pepr_tpu.io.fasta import SequenceSet as JSet
from pepr_tpu.models import msa as jmsa
from pepr_tpu.ops import trim as jtrim
from pepr_tpu.pipeline.stage2 import Stage2Config as JConfig
from pepr_tpu.pipeline.stage2 import filter_sets as jfilter
from pepr_tpu.pipeline.stage2 import run_stage2 as jrun
from pepr_tpu.tree import to_newick as jto_newick

from pepr_tpu_torch.alphabet import GAP, PAD
from pepr_tpu_torch.io.fasta import SequenceSet
from pepr_tpu_torch.models import msa as tmsa
from pepr_tpu_torch.ops import trim as ttrim
from pepr_tpu_torch.pipeline.stage2 import (Stage2Config, filter_sets,
                                            run_stage2, run_stage2_aligned)
from pepr_tpu_torch.tree import parse_newick, rf_distance, to_newick
from pepr_tpu_torch.utils.simulate import random_tree, simulate_alignment

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def alignments():
    """Seeded alignments with gaps: random codes (PAD and '?' among
    them), and simulated families with gap runs and sparse columns."""
    rng = np.random.default_rng(21)
    out = [rng.integers(0, 25, size=(n, L)).astype(np.int8)
           for n, L in ((5, 40), (12, 90), (30, 17))]
    for n, L in ((8, 150), (20, 220), (41, 180)):
        tree = random_tree([f"t{i}" for i in range(n)], rng, scale=0.05)
        m, _ = simulate_alignment(tree, L, rng, alpha=0.5)
        for r in range(n):
            for _ in range(int(rng.integers(0, 4))):
                s, d = int(rng.integers(0, L - 10)), int(rng.integers(1, 10))
                m[r, s:s + d] = GAP
        m[:, rng.random(L) < 0.05] = GAP  # mostly-gap columns
        m[rng.random(m.shape) < 0.01] = PAD
        out.append(m)
    return out


@pytest.mark.parametrize("fn", ["gblocks_mask", "trim_gblocks",
                                "min_steps_per_column", "uniform_trim_mask",
                                "informative_mask"])
def test_trim_functions_identical(fn):
    for mat in alignments():
        np.testing.assert_array_equal(getattr(ttrim, fn)(mat),
                                      getattr(jtrim, fn)(mat))
    mat = alignments()[4]
    for kw in (dict(b5="a"), dict(b5="n"), dict(b3=2, b4=3), dict(b1=3)):
        np.testing.assert_array_equal(ttrim.gblocks_mask(mat, **kw),
                                      jtrim.gblocks_mask(mat, **kw))
    assert ttrim.gblocks_mask(np.zeros((3, 0), np.int8)).shape == (0,)


def test_filter_sets_identical():
    rng = np.random.default_rng(22)
    raw = []
    for g in range(30):
        n = int(rng.integers(1, 9))
        taxa = rng.integers(0, 7, size=n)
        raw.append((f"g{g}", [f"p{g}_{i} [T{t}]" for i, t in enumerate(taxa)],
                    [rng.integers(0, 20, size=int(rng.integers(5, 30)))
                     .astype(np.int8) for _ in range(n)]))
    for kw in (dict(), dict(min_taxa=3, max_taxa=5),
               dict(min_taxa=2, representative_only=True),
               dict(min_taxa=2, target_sets=7)):
        got = filter_sets([SequenceSet(*r) for r in raw], Stage2Config(**kw))
        want = jfilter([JSet(*r) for r in raw], JConfig(**kw))
        assert [(s.name, s.titles) for s in got] == \
            [(s.name, s.titles) for s in want]
        for a, b in zip(got, want):
            for x, y in zip(a.seqs, b.seqs):
                np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def runs(smoke):
    sets = smoke.three_sequence_sets(np.random.default_rng(23))
    want = jrun([JSet(s.name, s.titles, s.seqs) for s in sets],
                JConfig(**smoke.SMALL_S2))
    got = run_stage2(sets, Stage2Config(**smoke.SMALL_S2), device="cpu")
    return want, got


def test_run_stage2_trimmed_alignments_identical(runs):
    want, got = runs
    assert len(got.alignments) == len(want.alignments) > 0
    for a, b in zip(got.alignments, want.alignments):
        assert (a.name, a.taxa, a.titles) == (b.name, b.taxa, b.titles)
        np.testing.assert_array_equal(a.mat, b.mat)
    np.testing.assert_array_equal(got.concat.mat, want.concat.mat)
    assert set(got.timings) >= {"align", "concat", "alpha_estimate",
                                "full_tree", "support_trees"}


def test_run_stage2_tree_likelihood_and_supports(runs):
    want, got = runs
    assert rf_distance(got.full_tree,
                       parse_newick(jto_newick(want.full_tree))) == 0
    assert got.log_likelihood == pytest.approx(want.log_likelihood,
                                               rel=1e-4)
    assert len(got.support_trees) == len(want.support_trees) == 3
    assert to_newick(got.tree, lengths=False) == \
        jto_newick(want.tree, lengths=False)


@pytest.mark.parametrize("kw,item", [
    (dict(congruence_filter=True), "item 8"),
    (dict(matrix_evaluation=True), "item 8"),
    (dict(matrix_evaluation=["WAG", "LG"]), "item 8"),
    (dict(alphabet="nt"), "item 8"),
    (dict(full_tree_method="nj"), "item 8"),
    (dict(full_tree_method="parsimony"), "item 8"),
    (dict(full_tree_method="parsimony_bl"), "item 8"),
])
def test_unported_options_raise(kw, item):
    sets = [SequenceSet("g", [f"p{i} [T{i}]" for i in range(4)],
                        [np.arange(10, dtype=np.int8)] * 4)]
    with pytest.raises(NotImplementedError, match=item):
        run_stage2(sets, Stage2Config(**kw), device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        run_stage2_aligned([], Stage2Config(**kw), device="cpu")


def test_run_stage2_refuses_empty_input():
    with pytest.raises(ValueError, match="no homolog groups"):
        run_stage2([], Stage2Config(), device="cpu")


@pytest.mark.slow
def test_real_groups_msa_agreement():
    """The port's MSA of 120 Aquificales homolog groups of >= 4 members
    (every 8th group of `conformance/aqu_ckpt/stage1.pkl` that has them)
    against the JAX package's align_families on the same groups.
    The reference rounds profiles to bfloat16, the port keeps float32,
    so near-ties can resolve differently.  Measured when written (CPU,
    ~100 s): 109 of 120 alignments identical; of the 11 others, 6 differ
    in SP score, at most 0.63% relative (the port's higher on 2, lower
    on 4).  Asserted: at least 85% identical and every SP within 2%."""
    path = os.path.join(ROOT, "conformance", "aqu_ckpt", "stage1.pkl")
    if not os.path.exists(path):
        pytest.skip("conformance/aqu_ckpt/stage1.pkl is not present")
    with open(path, "rb") as f:
        hg_sets = pickle.load(f)[0]
    groups = [s.seqs for s in hg_sets[::8] if len(s) >= 4][:120]
    want = jmsa.align_families(groups)
    got = tmsa.align_families(groups, device="cpu")
    same = sum(np.array_equal(g, w) for g, w in zip(got, want))
    rel = [abs(tmsa.sp_score(g) - jmsa.sp_score(w)) / abs(jmsa.sp_score(w))
           for g, w in zip(got, want)]
    assert same >= 0.85 * len(groups), same
    assert max(rel) <= 0.02, max(rel)
