"""A rehearsal of chip_smoke.py's stage-2 front-end phases on the CPU, at
a small size: the seeded deletions and the unaligned homolog groups
the stage2 phase builds, the dyadic profiles and last merge wave of
small_align, run_stage2 from unaligned families with the stage2 phase's
checks, and genomes_to_tree on a small simulate_genomes output through
run_stage1 with the pipeline's derived config.  Port only: the JAX
package is held against the port in test_torch_msa.py and
test_torch_trim_stage2.py."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from pepr_tpu_torch.alphabet import GAP
from pepr_tpu_torch.models.msa import ALIGN, reset_align_counts
from pepr_tpu_torch.ops.profile_align import nw_profile_batch
from pepr_tpu_torch.pipeline import stage2
from pepr_tpu_torch.pipeline.stage1 import Stage1Config, run_stage1
from pepr_tpu_torch.pipeline.stage2 import Stage2Config, run_stage2
from pepr_tpu_torch.tree import rf_distance
from pepr_tpu_torch.utils.simulate import (random_tree, simulate_families,
                                           simulate_genomes)

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
def families():
    rng = np.random.default_rng(31)
    taxa = [f"taxon{i:02d}" for i in range(8)]
    tree = random_tree(taxa, rng)
    return taxa, tree, simulate_families(tree, rng.integers(60, 120, size=8),
                                         rng, alpha=0.5, absent=0.1)


def test_unaligned_families(smoke, families):
    _, _, fams = families
    sets, true = smoke.unaligned_families(fams, np.random.default_rng(1))
    assert [s.name for s in sets] == [a.name for a in true] == \
        [n for n, _, _ in fams]
    for s, a, (_, taxa, codes) in zip(sets, true, fams):
        assert s.taxa == list(taxa) == a.taxa
        assert a.mat.shape == codes.shape
        for seq, row, orig in zip(s.seqs, a.mat, codes):
            np.testing.assert_array_equal(row[row != GAP], seq)
            lost = len(orig) - len(seq)
            assert 0 <= lost <= 3 * 8
            np.testing.assert_array_equal(row[row != GAP],
                                          orig[row != GAP])
    keep = [smoke.deletion_keep(100, np.random.default_rng(s))
            for s in range(50)]
    runs = [int(np.diff(np.r_[1, k.astype(int), 1]).clip(max=0).sum() * -1)
            for k in keep]
    assert max(runs) <= 3 and min(runs) == 0 and max(runs) >= 1


def test_small_align_inputs(smoke, families):
    rng = np.random.default_rng(2)
    p, lens = smoke.dyadic_profiles(rng, 4, 128)
    assert p.shape == (4, 128, 20)
    assert (lens >= 64).all() and (lens < 128).all()
    assert np.array_equal(p * 4, np.round(p * 4)) and (p.sum(-1) <= 1).all()
    assert (p[np.arange(128)[None, :] >= lens[:, None]] == 0).all()
    _, _, fams = families
    _, true = smoke.unaligned_families(fams, np.random.default_rng(1))
    wave = smoke.last_merge_wave(true)
    assert sum(len(v[1]) for v in wave.values()) == len(true)
    for (L1, L2), (p1, l1, p2, l2) in wave.items():
        assert p1.shape[1:] == (L1, 20) and p2.shape[1:] == (L2, 20)
        assert (l1 <= L1).all() and (l2 <= L2).all()
        score, ptr = nw_profile_batch(*(torch.as_tensor(x)
                                        for x in (p1, p2, l1, l2)))
        assert torch.isfinite(score).all()
        assert ptr.shape == (len(l1), L1 + L2 + 1, L1 + 1)


def test_run_stage2_from_unaligned_families(smoke, families, monkeypatch):
    taxa, tree, fams = families
    sets, _ = smoke.unaligned_families(fams, np.random.default_rng(1))
    reset_align_counts()
    released = []  # the DP calls made when run_stage2 releases its plans
    monkeypatch.setattr(stage2, "release_plans",
                        lambda: released.append(ALIGN["calls"]))
    res = run_stage2(sets, Stage2Config(full_tree_method="fast_ml",
                                        support_reps=2), device="cpu")
    assert ALIGN["calls"] > 0 and ALIGN["dp_steps"] > 0
    assert ALIGN["ptr_bytes"] > 0
    assert released == [ALIGN["calls"]]  # once, after the last DP call
    # chip_smoke.path_checks lays the replicates out over the
    # concatenation's taxa
    for t in res.support_trees:
        assert sorted(t.leaf_labels()) == sorted(res.concat.taxa)
    assert res.timings["align"] > 0
    assert sorted(res.full_tree.leaf_labels()) == sorted(taxa)
    assert 0 < res.concat.length < sum(c.shape[1] for _, _, c in fams)
    assert np.isfinite(res.log_likelihood)
    assert rf_distance(res.full_tree, tree) <= len(taxa) - 3
    sup = [v for v in res.tree.support if v == v]
    assert sup and min(sup) >= 0 and max(sup) <= 2


def test_genomes_to_tree_config(smoke):
    cfg = smoke.genomes_to_tree_config(11, 1, smoke.G2T_REPS)
    assert (cfg.min_taxa, cfg.max_taxa) == (8, 12)
    assert cfg.full_tree_method == "fast_ml" and cfg.support_reps == 8
    assert cfg.target_sets is None and cfg.msa_refine_iters == 1
    assert smoke.genomes_to_tree_config(3, 2, 1).min_taxa == 3


def test_genomes_to_tree_rehearsal(smoke):
    ing, pool, truth = simulate_genomes(
        np.random.default_rng(32), n_ingroup=4, n_families=30, n_random=3,
        median_len=120.0, max_len=250, n_long=0)
    s1res = run_stage1(ing, pool, Stage1Config(use_hmm=False,
                                                outgroup_count=2),
                       device="cpu")
    s1 = dict(hg_sets=s1res.hg_sets, selected=s1res.selected_outgroups,
              ingroup=ing, truth=truth)
    assert s1["selected"] == [pool[0].taxon]
    res, want, rf = smoke.genomes_to_tree(s1, "cpu", reps=2)
    assert sorted(res.tree.leaf_labels()) == want
    assert len(want) == 5 and 0 <= rf <= 2
    assert np.isfinite(res.log_likelihood)
