"""The port's pruning likelihood (pepr_tpu_torch.ops) against the JAX
package on the same inputs, on the CPU: per-site LL against the XLA
scan and the Pallas forward kernel (interpret mode), the plain gradient
against the Pallas backward kernel (interpret mode) and branch-length
gradients against jax.grad.

Tolerances: per-site LL rel 1e-5 (+1e-5 absolute, for all-gap columns
whose LL is ~0); gradients max |diff| <= 1e-4 * max |ref| (float32
sums in another order).  The Pallas kernels run with mode="highest"
(full float32 dots), their own exact option."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pepr_tpu.ops import likelihood as jlik
from pepr_tpu.ops.pallas_pruning import (A_PAD, block_diag_pmats,
                                         pruning_site_ll_pallas)
from pepr_tpu.ops.pallas_pruning_grad import pruning_grad_pmats_pallas
from pepr_tpu.tree import parse_newick as jparse
from pepr_tpu.utils.simulate import simulate_alignment as jsimulate

from pepr_tpu_torch.ops import likelihood as tlik
from pepr_tpu_torch.ops import pruning
from pepr_tpu_torch.tree import parse_newick

torch.set_num_threads(2)
LL_RTOL = 1e-5
GRAD_RTOL = 1e-4
# 3-child root, 8 taxa
NWK = ("(((A:0.1,B:0.2):0.1,(C:0.15,D:0.1):0.2):0.05,"
       "(E:0.1,F:0.3):0.1,(G:0.2,H:0.1):0.15);")
# rooted binary tree (2-child root)
NWK_ROOTED = "(((A:0.12,B:0.3):0.15,(C:0.1,D:0.25):0.2):0.1,(E:0.4,F:0.08):0.18);"


def _problem(nwk, L, seed, alpha=0.8):
    rng = np.random.default_rng(seed)
    tree = jparse(nwk)
    codes, taxa = jsimulate(tree, L, rng, alpha=alpha)
    codes[rng.random(codes.shape) < 0.08] = 23  # gaps
    codes[0, 5] = 22  # X
    codes[2, 40:60] = 20  # B
    codes[:, 7] = 23  # an all-gap column
    jarr = jlik.tree_to_arrays(tree, taxa)
    return codes, taxa, jarr


@pytest.fixture(scope="module", params=[NWK, NWK_ROOTED],
                ids=["root3", "root2"])
def problem(request):
    return _problem(request.param, 512, 3)


def _jmodel(alpha=0.8):
    return jlik.WagModel.create(alpha=alpha)


def _tmodel(jm):
    return tlik.from_jax_arrays(jm.eig, jm.u, jm.u_inv, jm.pi, jm.rates)


def _margs_j(m):
    return tuple(jnp.asarray(x) for x in (m.eig, m.u, m.u_inv, m.pi,
                                          m.rates))


def _close(got, want, rtol, atol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= rtol * np.abs(want) + atol), \
        float(np.max(np.abs(got - want)))


def _close_norm(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.max(np.abs(got - want)) <= rtol * np.max(np.abs(want)), \
        (float(np.max(np.abs(got - want))), float(np.max(np.abs(want))))


def test_model_from_jax_arrays_and_create_agree():
    jm = _jmodel(0.5)
    a, b = _tmodel(jm), tlik.WagModel.create(alpha=0.5)
    for f in ("eig", "u", "u_inv", "pi", "rates"):
        np.testing.assert_array_equal(getattr(a, f), getattr(jm, f))
        np.testing.assert_array_equal(getattr(b, f), getattr(jm, f))


def test_tree_arrays_roundtrip_matches_jax():
    tree_j, tree_t = jparse(NWK), parse_newick(NWK)
    taxa = list("HGFEDCBA")
    ja, ta = jlik.tree_to_arrays(tree_j, taxa), tlik.tree_to_arrays(tree_t,
                                                                    taxa)
    np.testing.assert_array_equal(ja.children, ta.children)
    np.testing.assert_array_equal(ja.blen, ta.blen)
    np.testing.assert_array_equal(ja.node_of_tree_node, ta.node_of_tree_node)
    back_j, back_t = jlik.arrays_to_tree(ja), tlik.arrays_to_tree(ta)
    np.testing.assert_array_equal(back_j.parent, back_t.parent)
    np.testing.assert_array_equal(back_j.blen, back_t.blen)


def test_transition_matrices_match_jax(problem):
    _, _, jarr = problem
    jm = _jmodel()
    want = np.asarray(jlik.transition_matrices(jm, jnp.asarray(jarr.blen)))
    got = tlik.transition_matrices(_tmodel(jm), torch.as_tensor(jarr.blen))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


def test_site_ll_matches_jax_scan(problem):
    codes, _, jarr = problem
    jm = _jmodel()
    want = jlik.loglik_sites(jnp.asarray(codes), jnp.asarray(jarr.children),
                             jnp.asarray(jarr.blen), *_margs_j(jm))
    got = tlik.loglik_sites(torch.as_tensor(codes),
                            torch.as_tensor(jarr.children),
                            torch.as_tensor(jarr.blen),
                            *tlik.model_tensors(_tmodel(jm), "cpu"))
    _close(got.numpy(), want, LL_RTOL, 1e-5)


def test_site_ll_matches_pallas_interpret(problem):
    codes, _, jarr = problem
    jm = _jmodel()
    pm = jlik.transition_matrices(jm, jnp.asarray(jarr.blen))
    pip = np.zeros((1, A_PAD), np.float32)
    pip[0, :20] = jm.pi
    want = pruning_site_ll_pallas(
        jnp.asarray(codes), jnp.asarray(jarr.children, jnp.int32),
        block_diag_pmats(pm), jnp.asarray(pip), interpret=True,
        mode="highest")
    got = pruning.site_ll_reference(
        torch.as_tensor(codes), torch.as_tensor(jarr.children[None]),
        torch.as_tensor(np.array(pm))[None], torch.as_tensor(jm.pi))
    _close(got[0].numpy(), want, LL_RTOL, 1e-5)


def test_grad_pmats_matches_pallas_interpret(problem):
    codes, _, jarr = problem
    jm = _jmodel()
    rng = np.random.default_rng(4)
    ct = rng.random(codes.shape[1]).astype(np.float32)
    pm = jlik.transition_matrices(jm, jnp.asarray(jarr.blen))
    pip = np.zeros((1, A_PAD), np.float32)
    pip[0, :20] = jm.pi
    gbd = np.asarray(pruning_grad_pmats_pallas(
        jnp.asarray(codes), jnp.asarray(jarr.children, jnp.int32),
        block_diag_pmats(pm), jnp.asarray(pip), jnp.asarray(ct),
        interpret=True, mode="highest"))  # (V, 96, 96)
    want = np.stack([gbd[:, c * A_PAD:c * A_PAD + 20,
                         c * A_PAD:c * A_PAD + 20] for c in range(4)])
    got = pruning.site_ll_grad_reference(
        torch.as_tensor(codes), torch.as_tensor(jarr.children[None]),
        torch.as_tensor(np.array(pm))[None], torch.as_tensor(jm.pi),
        torch.as_tensor(ct)[None])
    assert got.shape == (1, 4, len(jarr.blen), 20, 20)
    _close_norm(got[0].numpy(), want, GRAD_RTOL)


def test_blen_grads_match_jax_grad(problem):
    codes, _, jarr = problem
    jm = _jmodel(0.6)
    rng = np.random.default_rng(5)
    w = rng.random(codes.shape[1]).astype(np.float32)
    margs = _margs_j(jm)

    def f(blen):
        return jlik.loglik_weighted(jnp.asarray(codes),
                                    jnp.asarray(jarr.children), blen,
                                    *margs, jnp.asarray(w), chunk=512,
                                    remat=False)

    v_want, g_want = jax.value_and_grad(f)(jnp.asarray(jarr.blen))
    blen = torch.as_tensor(jarr.blen).requires_grad_(True)
    v_got = tlik.loglik_weighted(
        torch.as_tensor(codes), torch.as_tensor(jarr.children), blen,
        *tlik.model_tensors(_tmodel(jm), "cpu"), torch.as_tensor(w))
    v_got.backward()
    assert v_got.item() == pytest.approx(float(v_want), rel=LL_RTOL)
    _close_norm(blen.grad.numpy(), np.asarray(g_want), GRAD_RTOL)


def test_batched_site_ll_matches_per_tree_jax():
    """Trees of one batch (different topologies and lengths, shared
    codes) each agree with the JAX scan."""
    codes, taxa, jarr = _problem(NWK, 300, 8)
    other = jlik.tree_to_arrays(jparse(
        "((A:0.3,(B:0.1,C:0.2):0.1):0.1,(D:0.1,E:0.2):0.3,"
        "((F:0.1,G:0.1):0.2,H:0.05):0.1);"), taxa)
    jm = _jmodel(1.3)
    ch = np.stack([jarr.children, other.children])
    bl = np.stack([jarr.blen, other.blen * 1.5])
    got = tlik.loglik_sites(torch.as_tensor(codes), torch.as_tensor(ch),
                            torch.as_tensor(bl),
                            *tlik.model_tensors(_tmodel(jm), "cpu"))
    for b in range(2):
        want = jlik.loglik_sites(jnp.asarray(codes), jnp.asarray(ch[b]),
                                 jnp.asarray(bl[b]), *_margs_j(jm))
        _close(got[b].numpy(), want, LL_RTOL, 1e-5)


def test_loglik_total_matches_jax():
    codes, _, jarr = _problem(NWK, 400, 9)
    jm = _jmodel(0.7)
    w = np.random.default_rng(2).integers(0, 3, 400).astype(np.float32)
    want = float(jlik.loglik(jnp.asarray(codes), jnp.asarray(jarr.children),
                             jnp.asarray(jarr.blen), jm, site_weights=w))
    got = tlik.loglik(codes, jarr.children, jarr.blen, _tmodel(jm),
                      site_weights=w, device="cpu")
    assert got == pytest.approx(want, rel=LL_RTOL)
