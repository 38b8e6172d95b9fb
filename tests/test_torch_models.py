"""The port's substitution models against the JAX package on the CPU:
the registry (data/protein_models.py: names, rates and frequencies
identical, `eigensystem` within 1e-12 in float64), `WagModel.named` and
`WagModel.gtr_nt` (arrays within 1e-6), the LL of one tree under
BLOSUM62, WAGF and GTR-nt (rel 1e-5 of JAX's), the empirical
frequencies (identical) and matrix evaluation (the same chosen model,
every model's LL within rel 1e-4)."""

import numpy as np
import pytest
import torch

from pepr_tpu.data import protein_models as jpm
from pepr_tpu.models import treebuild as jtb
from pepr_tpu.ops import likelihood as jlik
from pepr_tpu.utils.simulate import simulate_alignment as jsimulate

from pepr_tpu_torch.data import protein_models as tpm
from pepr_tpu_torch.models import treebuild as ttb
from pepr_tpu_torch.ops import likelihood as tlik
from pepr_tpu_torch.tree import parse_newick, to_newick
from pepr_tpu_torch.utils.simulate import random_tree

torch.set_num_threads(2)

FIELDS = ("eig", "u", "u_inv", "pi", "rates")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(51)
    taxa = [f"T{i}" for i in range(9)]
    true = random_tree(taxa, rng, scale=0.08)
    codes, taxa = jsimulate(parse_newick(to_newick(true)), 400, rng,
                            alpha=0.6)
    codes[rng.random(codes.shape) < 0.04] = 23
    return true, codes, taxa


def test_registry_identical():
    assert tpm.model_names() == jpm.model_names() == \
        ["WAG", "WAGF", "BLOSUM62", "BLOSUM62F"]
    assert tpm.model_names(False) == jpm.model_names(False)
    assert list(tpm._REGISTRY) == list(jpm._REGISTRY)
    for name, (r, f) in jpm._REGISTRY.items():
        np.testing.assert_array_equal(tpm._REGISTRY[name][0], r)
        np.testing.assert_array_equal(tpm._REGISTRY[name][1], f)
    emp = np.random.default_rng(1).dirichlet(np.ones(20))
    for name in jpm.model_names():
        for a, b in zip(tpm.resolve_model(name, emp),
                        jpm.resolve_model(name, emp)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError):
        tpm.resolve_model("LG")
    with pytest.raises(KeyError):
        jpm.resolve_model("LG")
    with pytest.raises(ValueError, match="empirical"):
        tpm.resolve_model("WAGF")


def test_eigensystem_float64():
    emp = np.random.default_rng(2).dirichlet(np.ones(20))
    for name in jpm.model_names():
        rates, pi = jpm.resolve_model(name, emp)
        for a, b in zip(tpm.eigensystem(rates, pi),
                        jpm.eigensystem(rates, pi)):
            assert a.dtype == np.float64
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", ["named", "gtr_nt"])
def test_model_arrays(kind):
    emp = np.random.default_rng(3).dirichlet(np.ones(20))
    if kind == "named":
        pairs = [(tlik.WagModel.named(n, alpha=0.7, empirical_freqs=emp),
                  jlik.WagModel.named(n, alpha=0.7, empirical_freqs=emp))
                 for n in jpm.model_names()]
    else:
        pairs = [(tlik.WagModel.gtr_nt(**kw), jlik.WagModel.gtr_nt(**kw))
                 for kw in (dict(), dict(freqs=[0.3, 0.2, 0.2, 0.3],
                                         rates=[1, 4, 1, 1, 4, 1],
                                         alpha=0.5),
                            dict(rates=np.ones((4, 4)), n_cats=2))]
    for t, j in pairs:
        for f in FIELDS:
            a, b = getattr(t, f), np.asarray(getattr(j, f))
            assert a.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    # WAG by name is the default model, up to the two eigensystems'
    # float32 rounding
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tlik.WagModel.named("WAG"), f),
                                   getattr(tlik.WagModel.create(), f),
                                   rtol=1e-5, atol=1e-6)


def _nt_codes(data):
    """Nucleotide columns over the same tree: the protein codes folded
    onto ACGT, with the ambiguity codes kept."""
    _, codes, taxa = data
    return np.where(codes < 20, codes % 4, codes).astype(np.int8), taxa


@pytest.mark.parametrize("name", ["BLOSUM62", "WAGF", "GTR"])
def test_loglik_under_model(data, name):
    true, codes, taxa = data
    if name == "GTR":
        codes, taxa = _nt_codes(data)
        kw = dict(freqs=[0.3, 0.2, 0.2, 0.3], rates=[1, 4, 1, 1, 4, 1],
                  alpha=0.5)
        jm, tm = jlik.WagModel.gtr_nt(**kw), tlik.WagModel.gtr_nt(**kw)
    else:
        emp = jtb.empirical_aa_freqs(codes)
        jm = jlik.WagModel.named(name, alpha=0.6, empirical_freqs=emp)
        tm = tlik.WagModel.named(name, alpha=0.6, empirical_freqs=emp)
    arr = tlik.tree_to_arrays(true, taxa)
    want = float(jlik.loglik(codes, arr.children, arr.blen, jm))
    got = tlik.loglik(codes, arr.children, arr.blen, tm, device="cpu")
    assert np.isfinite(got)
    assert got == pytest.approx(want, rel=1e-5)


def test_empirical_aa_freqs_identical(data):
    _, codes, _ = data
    np.testing.assert_array_equal(ttb.empirical_aa_freqs(codes),
                                  jtb.empirical_aa_freqs(codes))


@pytest.mark.parametrize("names", [None, ["BLOSUM62", "WAG"]])
def test_evaluate_substitution_models(data, names):
    _, codes, taxa = data
    want, want_s = jtb.evaluate_substitution_models(codes, taxa, names,
                                                    alpha=0.6, bl_steps=40)
    got, got_s = ttb.evaluate_substitution_models(
        codes, taxa, names, alpha=0.6, bl_steps=40, device="cpu")
    assert got == want
    assert list(got_s) == list(want_s) == (names or jpm.model_names())
    for k in want_s:
        assert got_s[k] == pytest.approx(want_s[k], rel=1e-4)
    with pytest.raises(KeyError):
        ttb.evaluate_substitution_models(codes, taxa, ["WAG", "LG"],
                                         bl_steps=2, device="cpu")
