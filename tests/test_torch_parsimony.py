"""The port's Fitch parsimony (ops/parsimony.py) and the parsimony and
NJ tree methods (models/treebuild.py) against the JAX package on the
same inputs, on the CPU.  Identical: per-site steps and scores
(ambiguity codes, invariant columns and integer weights included; a
float32 sum of integers below 2^24 is exact), the numpy oracle,
`parsimony_tree`'s topology and score with and without a candidate cap,
and `nj_tree`.  `parsimony_bl`'s branch lengths give an LL within rel
1e-4 of the JAX package's."""

import numpy as np
import pytest
import torch

from pepr_tpu.models import treebuild as jtb
from pepr_tpu.ops import likelihood as jlik
from pepr_tpu.ops import parsimony as jpars
from pepr_tpu.tree import to_newick as jto_newick
from pepr_tpu.utils.simulate import simulate_alignment as jsimulate

from pepr_tpu_torch.models import treebuild as ttb
from pepr_tpu_torch.ops import likelihood as tlik
from pepr_tpu_torch.ops import parsimony as tpars
from pepr_tpu_torch.tree import parse_newick, rf_distance, to_newick
from pepr_tpu_torch.utils.simulate import random_tree

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def data():
    """10 taxa, 300 simulated columns with 5% X and 3% gaps, and 20
    invariant columns."""
    rng = np.random.default_rng(41)
    taxa = [f"T{i}" for i in range(10)]
    true = random_tree(taxa, rng, scale=0.08)
    codes, taxa = jsimulate(parse_newick(to_newick(true)), 300, rng,
                            alpha=0.7)
    codes[rng.random(codes.shape) < 0.05] = 22
    codes[rng.random(codes.shape) < 0.03] = 23
    inv = np.repeat(rng.integers(0, 20, size=(1, 20)), len(taxa), axis=0)
    codes = np.concatenate([codes, inv.astype(np.int8)], axis=1)
    return true, codes, taxa


def _children(codes, taxa, rng, n=5):
    """Children arrays: NJ's (a root trifurcation) alone, and a batch of
    n random trees' (a binary root)."""
    nj = jlik.tree_to_arrays(jtb.nj_start_tree(codes, taxa), taxa).children
    rand = np.stack([tlik.tree_to_arrays(random_tree(taxa, rng),
                                         taxa).children for _ in range(n)])
    return [nj[None], rand]


def test_fitch_sites_identical(data):
    _, codes, taxa = data
    for ch in _children(codes, taxa, np.random.default_rng(1)):
        got = tpars.fitch_sites_batch(torch.as_tensor(codes),
                                      torch.as_tensor(ch))
        for k in range(len(ch)):
            want = np.asarray(jpars.fitch_sites(codes, ch[k]))
            np.testing.assert_array_equal(got[k].numpy(), want)
            np.testing.assert_array_equal(
                tpars.fitch_sites(torch.as_tensor(codes),
                                  torch.as_tensor(ch[k])).numpy(), want)
            assert int(got[k].sum()) == tpars.fitch_numpy(codes, ch[k]) \
                == jpars.fitch_numpy(codes, ch[k])
            assert (got[k][-20:] == 0).all()  # invariant columns


def test_fitch_scores_identical(data):
    _, codes, taxa = data
    rng = np.random.default_rng(2)
    L = codes.shape[1]
    for ch in _children(codes, taxa, rng):
        for w in (np.ones(L, np.float32),
                  rng.multinomial(L, np.full(L, 1.0 / L))
                  .astype(np.float32)):
            got = tpars.fitch_score_topologies(torch.as_tensor(codes),
                                               torch.as_tensor(ch),
                                               torch.as_tensor(w)).numpy()
            want = np.asarray(jpars.fitch_score_topologies(codes, ch, w))
            np.testing.assert_array_equal(got, want)
            for k in range(len(ch)):
                assert tpars.fitch_score(codes, ch[k], w, device="cpu") \
                    == jpars.fitch_score(codes, ch[k], w)
        assert tpars.fitch_score(codes, ch[0], device="cpu") == \
            jpars.fitch_score(codes, ch[0])


def test_leaf_sets_full_set_for_ambiguity():
    codes = torch.tensor([[0, 19, 20, 22, 23, 24]], dtype=torch.int8)
    got = tpars.leaf_sets(codes)[0].tolist()
    assert got == [1, 1 << 19] + [tpars.ALL_STATES] * 4


def test_nj_tree_identical(data):
    _, codes, taxa = data
    w = np.random.default_rng(3).integers(0, 3, codes.shape[1]) \
        .astype(np.float32)
    for sw in (None, w):
        want = jtb.nj_tree(codes, taxa, site_weights=sw)
        got = ttb.nj_tree(codes, taxa, site_weights=sw, device="cpu")
        assert to_newick(got, lengths=False) == \
            jto_newick(want, lengths=False)


@pytest.mark.parametrize("kw", [dict(), dict(max_candidates=5),
                                dict(nni_rounds=1)])
def test_parsimony_tree_identical(data, kw):
    true, codes, taxa = data
    want, want_score = jtb.parsimony_tree(codes, taxa, **kw)
    got, got_score = ttb.parsimony_tree(codes, taxa, device="cpu", **kw)
    assert got_score == want_score
    assert to_newick(got) == jto_newick(want)  # the NJ start's lengths
    assert rf_distance(got, true) <= len(taxa) - 3


def test_parsimony_bl_likelihood(data):
    """parsimony_bl: the same topology, and its fitted branch lengths
    give an LL within rel 1e-4 of the JAX package's."""
    _, codes, taxa = data
    jm = jlik.WagModel.create(alpha=0.7)
    tm = tlik.from_jax_arrays(jm.eig, jm.u, jm.u_inv, jm.pi, jm.rates)
    want, ws = jtb.parsimony_tree(codes, taxa, branch_lengths=True,
                                  model=jm, bl_steps=40)
    got, gs = ttb.parsimony_tree(codes, taxa, branch_lengths=True,
                                 model=tm, bl_steps=40, device="cpu")
    assert gs == ws
    assert to_newick(got, lengths=False) == jto_newick(want, lengths=False)
    wa = jlik.tree_to_arrays(want, taxa)
    ga = tlik.tree_to_arrays(got, taxa)
    want_ll = float(jlik.loglik(codes, wa.children, wa.blen, jm))
    got_ll = tlik.loglik(codes, ga.children, ga.blen, tm, device="cpu")
    assert got_ll == pytest.approx(want_ll, rel=1e-4)
