"""The port's jackknife supports and replicate fan-out against the JAX
package on the same inputs, on the CPU: concatenation and masks
(identical), bootstrap weights (identical), replicate branch lengths
(rel 1e-3) and LLs (rel 1e-5), decorated supports (identical) and the
batched support trees (identical topologies); bootstrap column counts
carried through compaction unchanged; `method="nj"` (serial, jackknife
or bootstrap) and `resample="bootstrap_sites"` under fast_ml (batched)
with each replicate's topology equal to JAX's."""

import numpy as np
import pytest
import torch

from pepr_tpu.models import support as jsup
from pepr_tpu.models.concat import concatenate as jconcat
from pepr_tpu.models.msa import Alignment as JAlignment
from pepr_tpu.models.treebuild import nj_start_tree as jnj
from pepr_tpu.ops import likelihood as jlik
from pepr_tpu.parallel.mesh import default_mesh, sharded_replicate_blopt
from pepr_tpu.tree import parse_newick as jparse
from pepr_tpu.tree import to_newick as jto_newick

from pepr_tpu_torch.models import support as tsup
from pepr_tpu_torch.models.concat import concatenate as tconcat
from pepr_tpu_torch.models.msa import Alignment as TAlignment
from pepr_tpu_torch.ops import likelihood as tlik
from pepr_tpu_torch.parallel.replicates import compact_codes, replicate_blopt
from pepr_tpu_torch.tree import parse_newick, rf_distance, to_newick
from pepr_tpu_torch.utils.simulate import random_tree, simulate_families

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def families():
    rng = np.random.default_rng(21)
    taxa = [f"T{i}" for i in range(8)]
    tree = random_tree(taxa, rng)
    fams = simulate_families(tree, rng.integers(40, 90, size=10), rng,
                             alpha=0.7)
    j = jconcat([JAlignment(n, t, c) for n, t, c in fams])
    t = tconcat([TAlignment(n, t, c) for n, t, c in fams])
    return tree, j, t


def _tmodel(jm):
    return tlik.from_jax_arrays(jm.eig, jm.u, jm.u_inv, jm.pi, jm.rates)


def test_concatenation_identical(families):
    _, j, t = families
    assert j.taxa == t.taxa and j.gene_names == t.gene_names
    np.testing.assert_array_equal(j.mat, t.mat)
    np.testing.assert_array_equal(j.spans, t.spans)
    np.testing.assert_array_equal(j.presence, t.presence)
    assert j.hs_matrix_text() == t.hs_matrix_text()


def test_jackknife_masks_and_bootstrap_identical(families):
    _, j, t = families
    np.testing.assert_array_equal(jsup.jackknife_gene_masks(j, 6, 99),
                                  tsup.jackknife_gene_masks(t, 6, 99))
    np.testing.assert_array_equal(jsup.jackknife_mask(j, 3, 5, 0.3),
                                  tsup.jackknife_mask(t, 3, 5, 0.3))
    np.testing.assert_array_equal(jsup.bootstrap_weights(j.length, 2, 7),
                                  tsup.bootstrap_weights(t.length, 2, 7))


def test_compaction_keeps_live_columns(families):
    _, _, t = families
    masks = tsup.jackknife_gene_masks(t, 3, 1)
    codes_sel, w_sel = compact_codes(t.mat, masks)
    for r in range(3):
        live = np.nonzero(masks[r])[0]
        np.testing.assert_array_equal(codes_sel[r, :, :len(live)],
                                      t.mat[:, live])
        assert w_sel[r].sum() == masks[r].sum()
    assert compact_codes(t.mat, np.ones((2, t.length), np.float32)) is None


def test_replicate_blopt_matches_sharded(families):
    _, j, t = families
    masks = jsup.jackknife_gene_masks(j, 3, 4)
    arrs = [jlik.tree_to_arrays(jnj(j.mat, j.taxa, masks[r]), j.taxa)
            for r in range(3)]
    ch = np.stack([a.children for a in arrs])
    bl = np.stack([a.blen for a in arrs])
    jm = jlik.WagModel.create(alpha=0.8)
    want_b, want_ll = sharded_replicate_blopt(default_mesh(), j.mat, masks,
                                              ch, bl, jm, steps=20)
    got_b, got_ll = replicate_blopt(t.mat, masks, ch, bl, _tmodel(jm),
                                    steps=20, device="cpu")
    np.testing.assert_allclose(got_b, want_b, rtol=1e-3)
    np.testing.assert_allclose(got_ll, want_ll, rtol=1e-5)


def test_decorated_supports_identical(families):
    tree, j, t = families
    rng = np.random.default_rng(2)
    full = to_newick(tree)
    reps = [to_newick(random_tree(t.taxa, rng)) for _ in range(4)] + [full]
    want = jsup.decorated_tree(jparse(full), [jparse(x) for x in reps])
    got = tsup.decorated_tree(parse_newick(full),
                              [parse_newick(x) for x in reps])
    np.testing.assert_array_equal(got.support, want.support)
    assert to_newick(got) == jto_newick(want)


def test_support_trees_batched_match_jax(families):
    _, j, t = families
    jm = jlik.WagModel.create(alpha=0.8)
    want = jsup.support_trees(j, 3, 11, model=jm, bl_steps=30)
    got = tsup.support_trees(t, 3, 11, model=_tmodel(jm), bl_steps=30,
                             device="cpu")
    for a, b in zip(got, want):
        assert rf_distance(a, parse_newick(jto_newick(b))) == 0


def _strip_lengths(nwk):
    import re
    return re.sub(r":[-+0-9.eE]+", "", nwk)


@pytest.mark.parametrize("seed", [19, 20, 21])
def test_single_replicate_matches_jax_serial_path(seed, monkeypatch):
    """`support_trees(reps=1)` takes the serial `support_tree_single` in
    both packages (NNI only, refits of max(bl_steps // 2, 20) steps),
    never the batched fan-out: the same rooted Newick topology and
    branch lengths within 1e-5."""
    def batched(*args, **kwargs):
        raise AssertionError("reps == 1 took the batched path")
    monkeypatch.setattr(tsup, "support_trees_batched", batched)
    rng = np.random.default_rng(seed)
    taxa = [f"T{i}" for i in range(10)]
    tree = random_tree(taxa, rng)
    fams = simulate_families(tree, rng.integers(40, 90, size=10), rng,
                             alpha=0.7)
    j = jconcat([JAlignment(n, t, c) for n, t, c in fams])
    t = tconcat([TAlignment(n, t, c) for n, t, c in fams])
    jm = jlik.WagModel.create(alpha=0.8)
    (want,) = jsup.support_trees(j, 1, 3, model=jm, bl_steps=30)
    (got,) = tsup.support_trees(t, 1, 3, model=_tmodel(jm), bl_steps=30,
                                device="cpu")
    w_nwk, g_nwk = jto_newick(want), to_newick(got)
    assert _strip_lengths(g_nwk) == _strip_lengths(w_nwk)
    w_arr = jlik.tree_to_arrays(want, list(t.taxa))
    g_arr = tlik.tree_to_arrays(got, list(t.taxa))
    np.testing.assert_array_equal(g_arr.children, w_arr.children)
    np.testing.assert_allclose(g_arr.blen, w_arr.blen, rtol=0, atol=1e-5)


def test_compaction_keeps_bootstrap_counts(families):
    """Bootstrap weights are integer column counts up to ~6 with ~63% of
    the columns live: they are compacted, and every live column keeps
    its count."""
    _, _, t = families
    w = np.stack([tsup.replicate_weights(t, r, 9, resample="bootstrap_sites")
                  for r in range(4)])
    assert (w == np.round(w)).all() and w.max() >= 3
    assert ((w > 0).mean(axis=1) < 0.75).all()
    codes_sel, w_sel = compact_codes(t.mat, w)
    for r in range(4):
        live = np.nonzero(w[r])[0]
        np.testing.assert_array_equal(w_sel[r, :len(live)], w[r, live])
        np.testing.assert_array_equal(codes_sel[r, :, :len(live)],
                                      t.mat[:, live])
        assert (w_sel[r, len(live):] == 0).all()


@pytest.mark.parametrize("method,resample,reps", [
    ("nj", "jackknife_genes", 4), ("nj", "bootstrap_sites", 4),
    ("fast_ml", "bootstrap_sites", 3)])
def test_support_methods_and_resampling_match_jax(families, method,
                                                  resample, reps):
    _, j, t = families
    jm = jlik.WagModel.create(alpha=0.8)
    want = jsup.support_trees(j, reps, 13, model=jm, method=method,
                              resample=resample, bl_steps=30)
    got = tsup.support_trees(t, reps, 13, model=_tmodel(jm), method=method,
                             resample=resample, bl_steps=30, device="cpu")
    assert len(got) == len(want) == reps
    for a, b in zip(got, want):
        assert rf_distance(a, parse_newick(jto_newick(b))) == 0
        if method == "nj":
            assert to_newick(a, lengths=False) == \
                jto_newick(b, lengths=False)
