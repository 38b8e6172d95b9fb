"""The port's tree building (pepr_tpu_torch.models.treebuild) against the
JAX package on the same inputs, on the CPU: Kimura distances (rel
1e-6), NJ start topology (identical), Adam branch-length fitting after
20 steps (blen rel 1e-3, LL rel 1e-5), the alpha estimate (1e-3), the
numpy move generators (identical) and ml_tree (RF = 0, LL rel 1e-4);
the constraint tree (the FastTree constraint matrix byte for byte,
the bipartition checks identical, a constrained ml_tree at RF 0 to
JAX's with no bipartition incompatible with the constraint) and
`max_candidates` (the same truncation and tree)."""

import numpy as np
import pytest
import torch

from pepr_tpu.models import treebuild as jtb
from pepr_tpu.ops import likelihood as jlik
from pepr_tpu.tree import parse_newick as jparse
from pepr_tpu.tree import rf_distance as jrf
from pepr_tpu.tree import to_newick as jto_newick
from pepr_tpu.utils.simulate import simulate_alignment as jsimulate

from pepr_tpu_torch.models import treebuild as ttb
from pepr_tpu_torch.ops import likelihood as tlik
from pepr_tpu_torch.tree import parse_newick, rf_distance, to_newick
from pepr_tpu_torch.utils.simulate import random_tree
from pepr_tpu_torch.tree.bipartition import (bipartitions, compatible,
                                             taxon_index)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def eight_taxa():
    """The tests/test_treesearch.py fixture."""
    rng = np.random.default_rng(7)
    true = jparse("(((A:0.12,B:0.1):0.08,(C:0.1,D:0.12):0.09):0.05,"
                  "((E:0.1,F:0.12):0.1,(G:0.12,H:0.1):0.08):0.05);")
    codes, taxa = jsimulate(true, 600, rng)
    codes[rng.random(codes.shape) < 0.05] = 23
    return true, codes, taxa


def _tmodel(jm):
    return tlik.from_jax_arrays(jm.eig, jm.u, jm.u_inv, jm.pi, jm.rates)


def _port_tree(jtree):
    return parse_newick(jto_newick(jtree))


def test_protein_distances_match_jax(eight_taxa):
    _, codes, _ = eight_taxa
    w = np.random.default_rng(1).integers(0, 3, codes.shape[1])
    for sw in (None, w.astype(np.float32)):
        want = jtb.protein_distances(codes, sw)
        got = ttb.protein_distances(codes, sw, device="cpu")
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def test_nj_topology_identical(eight_taxa):
    _, codes, taxa = eight_taxa
    want = jtb.nj_start_tree(codes, taxa)
    got = ttb.nj_start_tree(codes, taxa, device="cpu")
    assert to_newick(got, lengths=False) == jto_newick(want, lengths=False)
    assert rf_distance(got, _port_tree(want)) == 0


def test_optimize_branch_lengths_20_steps(eight_taxa):
    _, codes, taxa = eight_taxa
    start = jtb.nj_start_tree(codes, taxa)
    jm = jlik.WagModel.create(alpha=0.7)
    w = (np.random.default_rng(3).random(codes.shape[1]) < 0.7) \
        .astype(np.float32)
    jarr = jlik.tree_to_arrays(start, taxa)
    want_b, want_ll = jtb.optimize_branch_lengths(codes, jarr, jm,
                                                  site_weights=w, steps=20)
    tarr = tlik.tree_to_arrays(_port_tree(start), taxa)
    got_b, got_ll = ttb.optimize_branch_lengths(codes, tarr, _tmodel(jm),
                                                site_weights=w, steps=20,
                                                device="cpu")
    np.testing.assert_allclose(got_b, want_b, rtol=1e-3)
    assert got_ll == pytest.approx(want_ll, rel=1e-5)


def test_adam_update_is_optax_adam():
    """torch.optim.Adam as configured = optax.adam(0.03) defaults, on a
    fixed gradient sequence.  rtol 5e-5: optax evaluates the bias
    corrections 1 - b^t in float32, where 0.999 is inexact (1 - b2 off
    by ~1.3e-5 relative); torch evaluates them in double."""
    import jax.numpy as jnp
    import optax
    rng = np.random.default_rng(0)
    grads = rng.normal(size=(6, 5)).astype(np.float32)
    theta_t = torch.zeros(5, requires_grad=True)
    opt_t = torch.optim.Adam([theta_t], lr=ttb.ADAM_LR,
                             betas=ttb.ADAM_BETAS, eps=ttb.ADAM_EPS)
    opt_j = optax.adam(0.03)
    theta_j = jnp.zeros(5)
    state = opt_j.init(theta_j)
    for g in grads:
        theta_t.grad = torch.as_tensor(g)
        opt_t.step()
        upd, state = opt_j.update(jnp.asarray(g), state, theta_j)
        theta_j = optax.apply_updates(theta_j, upd)
    np.testing.assert_allclose(theta_t.detach().numpy(), np.asarray(theta_j),
                               rtol=5e-5, atol=1e-8)


def test_estimate_gamma_alpha_matches_jax(eight_taxa):
    true, codes, taxa = eight_taxa
    want = jtb.estimate_gamma_alpha(codes, taxa, true)
    got = ttb.estimate_gamma_alpha(codes, taxa, _port_tree(true),
                                   device="cpu")
    assert got == pytest.approx(want, abs=1e-3)


def test_move_generators_identical(eight_taxa):
    _, codes, taxa = eight_taxa
    arr = jlik.tree_to_arrays(jtb.nj_start_tree(codes, taxa), taxa)
    ch, n = arr.children, len(taxa)
    assert ttb._nni_moves(ch, n) == jtb._nni_moves(ch, n)
    for a, b in zip(ttb._nni_candidates(ch, n), jtb._nni_candidates(ch, n)):
        np.testing.assert_array_equal(a, b)
    spr_t, spr_j = ttb._spr_candidates(ch, n), jtb._spr_candidates(ch, n)
    assert len(spr_t) == len(spr_j) > 0
    for a, b in zip(spr_t, spr_j):
        np.testing.assert_array_equal(a, b)
        fa, pa = ttb._postorder_perm(a, n)
        fb, pb = jtb._postorder_perm(b, n)
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(
            ttb._remap_blen(ch, fa, arr.blen, n),
            jtb._remap_blen(ch, fb, arr.blen, n))
    moves = jtb._nni_moves(ch, n)
    disjoint = [m for m in moves[1:] if not {m[0], m[1]} & set(moves[0][:2])]
    for m in [[x] for x in moves] + [[moves[0], disjoint[0]]]:
        for a, b in zip(ttb._nni_candidate(ch, arr.blen, n, m),
                        jtb._nni_candidate(ch, arr.blen, n, m)):
            np.testing.assert_array_equal(a, b)


def test_ml_tree_matches_jax(eight_taxa):
    """From a wrong start (two leaves swapped across the root), both
    searches reach the same tree: RF = 0, LL rel 1e-4."""
    true, codes, taxa = eight_taxa
    start = "(((A:0.1,E:0.1):0.1,(C:0.1,D:0.1):0.1):0.1," \
            "((B:0.1,F:0.1):0.1,(G:0.1,H:0.1):0.1):0.1);"
    kw = dict(nni_rounds=4, bl_steps=60, bl_refine_steps=30, spr_rounds=1)
    jm = jlik.WagModel.create(alpha=1.0)
    want, want_ll = jtb.ml_tree(codes, taxa, jm, start=jparse(start), **kw)
    got, got_ll = ttb.ml_tree(codes, taxa, _tmodel(jm),
                              start=parse_newick(start), device="cpu", **kw)
    assert rf_distance(got, _port_tree(want)) == 0
    assert rf_distance(got, _port_tree(true)) == jrf(want, true)
    assert got_ll == pytest.approx(want_ll, rel=1e-4)


def test_constraint_matrix_and_checks_identical(eight_taxa):
    true, codes, taxa = eight_taxa
    rng = np.random.default_rng(5)
    for nwk in [jto_newick(true), "((A,B),(C,D),(E,F,G,H));",
                to_newick(random_tree(taxa, rng))]:
        assert ttb.fasttree_constraint_matrix(parse_newick(nwk), taxa) == \
            jtb.fasttree_constraint_matrix(jparse(nwk), taxa)
    n, full = len(taxa), (1 << len(taxa)) - 1
    cons = set(bipartitions(parse_newick("((A,C),(B,D),(E,F,G,H));"),
                            taxon_index(taxa)))
    arrs = [jlik.tree_to_arrays(jtb.nj_start_tree(codes, taxa), taxa)] + [
        jlik.tree_to_arrays(jparse(to_newick(random_tree(taxa, rng))), taxa)
        for _ in range(6)] + [
        jlik.tree_to_arrays(jparse("(((A,C),(B,D)),((E,F),(G,H)));"), taxa)]
    seen = set()
    for a in arrs:
        got = ttb._children_bipartitions(a.children, n, full)
        assert got == jtb._children_bipartitions(a.children, n, full)
        v = ttb._violates_constraint(a.children, n, cons, full)
        assert v == jtb._violates_constraint(a.children, n, cons, full)
        seen.add(v)
    assert seen == {True, False}


def test_ml_tree_with_constraint_matches_jax():
    """tests/test_nt_and_constraints.py's set-up: a constraint that
    conflicts with the data's signal keeps both searches inside its
    bipartitions, and they reach the same tree."""
    rng = np.random.default_rng(17)
    true = jparse("(((A:0.15,B:0.12):0.1,(C:0.1,D:0.14):0.12):0.06,"
                  "(E:0.12,F:0.1):0.06);")
    codes, taxa = jsimulate(true, 400, rng)
    cons = "((A,C),(B,D),(E,F));"
    kw = dict(nni_rounds=6, spr_rounds=1)
    jm = jlik.WagModel.create()
    want, want_ll = jtb.ml_tree(codes, taxa, jm, start=jparse(cons),
                                constraint=jparse(cons), **kw)
    got, got_ll = ttb.ml_tree(codes, taxa, _tmodel(jm),
                              start=parse_newick(cons),
                              constraint=parse_newick(cons), device="cpu",
                              **kw)
    assert rf_distance(got, _port_tree(want)) == 0
    assert got_ll == pytest.approx(want_ll, rel=1e-4)
    idx = taxon_index(taxa)
    full = (1 << len(taxa)) - 1
    for b in bipartitions(got, idx):
        for c in bipartitions(parse_newick(cons), idx):
            assert compatible(b, c, full)
    # unconstrained, the search leaves the constraint
    free, _ = ttb.ml_tree(codes, taxa, _tmodel(jm), start=parse_newick(cons),
                          device="cpu", **kw)
    assert rf_distance(free, _port_tree(true)) < rf_distance(got,
                                                              _port_tree(true))


def test_ml_tree_max_candidates_matches_jax(eight_taxa, caplog):
    true, codes, taxa = eight_taxa
    start = "(((A:0.1,E:0.1):0.1,(C:0.1,D:0.1):0.1):0.1," \
            "((B:0.1,F:0.1):0.1,(G:0.1,H:0.1):0.1):0.1);"
    kw = dict(nni_rounds=3, bl_steps=40, bl_refine_steps=20, spr_rounds=0,
              max_candidates=7)
    jm = jlik.WagModel.create(alpha=1.0)
    with caplog.at_level("INFO"):
        want, want_ll = jtb.ml_tree(codes, taxa, jm, start=jparse(start),
                                    **kw)
        n_jax = len([r for r in caplog.records
                     if "truncating NNI neighborhood" in r.getMessage()])
        got, got_ll = ttb.ml_tree(codes, taxa, _tmodel(jm),
                                  start=parse_newick(start), device="cpu",
                                  **kw)
    msgs = [r.getMessage() for r in caplog.records
            if "truncating NNI neighborhood" in r.getMessage()]
    assert n_jax >= 1 and len(msgs) == 2 * n_jax
    assert msgs[:n_jax] == msgs[n_jax:]
    assert msgs[0].endswith("-> 7 (max_candidates)")
    assert rf_distance(got, _port_tree(want)) == 0
    assert got_ll == pytest.approx(want_ll, rel=1e-4)
