"""The port's stage 2 from aligned families (run_stage2_aligned) against
the JAX package's run_stage2 resumed from a checkpoint store whose
"alignments" key is preset — the same tail, from concatenation to the
decorated tree — on one small fixture, on the CPU: the same alpha
(1e-3), full-tree topology (RF = 0), LL (rel 1e-4) and supports
(identical)."""

import numpy as np
import pytest
import torch

from pepr_tpu.io.fasta import SequenceSet
from pepr_tpu.models.msa import Alignment as JAlignment
from pepr_tpu.pipeline.checkpoint import CheckpointStore
from pepr_tpu.pipeline.stage2 import Stage2Config as JConfig
from pepr_tpu.pipeline.stage2 import run_stage2
from pepr_tpu.tree import to_newick as jto_newick

from pepr_tpu_torch.models.msa import Alignment as TAlignment
from pepr_tpu_torch.pipeline.stage2 import Stage2Config, run_stage2_aligned
from pepr_tpu_torch.tree import parse_newick, rf_distance, to_newick
from pepr_tpu_torch.utils.simulate import random_tree, simulate_families

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(5)
    tree = random_tree([f"T{i}" for i in range(8)], rng)
    fams = simulate_families(tree, rng.integers(50, 90, size=8), rng,
                             alpha=0.6)
    store = CheckpointStore(str(tmp_path_factory.mktemp("s2")))
    store.save("alignments", [JAlignment(n, t, c) for n, t, c in fams])
    # run_stage2 only needs sets that pass its taxa filter; the aligned
    # families come from the store
    sets = [SequenceSet(n, [f"p{i} [{x}]" for i, x in enumerate(t)],
                        [row for row in c]) for n, t, c in fams]
    kw = dict(full_tree_method="fast_ml", support_reps=3, seed=7,
              nni_rounds=2)
    want = run_stage2(sets, JConfig(**kw), store=store)
    got = run_stage2_aligned([TAlignment(n, t, c) for n, t, c in fams],
                             Stage2Config(**kw), device="cpu")
    return tree, want, got


def test_stage2_alpha_and_likelihood(runs):
    _, want, got = runs
    assert got.gamma_alpha == pytest.approx(want.gamma_alpha, abs=1e-3)
    assert got.log_likelihood == pytest.approx(want.log_likelihood,
                                               rel=1e-4)
    np.testing.assert_array_equal(got.concat.mat, want.concat.mat)


def test_stage2_full_tree_topology(runs):
    tree, want, got = runs
    assert rf_distance(got.full_tree,
                       parse_newick(jto_newick(want.full_tree))) == 0
    assert rf_distance(got.full_tree, tree) == rf_distance(
        parse_newick(jto_newick(want.full_tree)), tree)


def test_stage2_supports_identical(runs):
    _, want, got = runs
    assert len(got.support_trees) == len(want.support_trees) == 3
    for a, b in zip(got.support_trees, want.support_trees):
        assert rf_distance(a, parse_newick(jto_newick(b))) == 0
    assert to_newick(got.tree, lengths=False) == \
        jto_newick(want.tree, lengths=False)
