"""The port's congruence filter (models/congruence.py) and the Fitch step
counts and randomization thresholds of models/concat.py against the
JAX package on the CPU: column bipartitions identical, congruence
scores within 1e-12, the families `filter_congruent` keeps identical;
minimum, per-site and beyond-minimum steps identical, and
`threshold_steps_for_gene` identical (the same numpy RNG streams), with
and without a gene mask."""

import numpy as np
import pytest

from pepr_tpu.models import concat as jconcat
from pepr_tpu.models import congruence as jcong
from pepr_tpu.models.msa import Alignment as JAlignment
from pepr_tpu.ops import likelihood as jlik
from pepr_tpu.models.treebuild import nj_start_tree as jnj

from pepr_tpu_torch.models import concat as tconcat
from pepr_tpu_torch.models import congruence as tcong
from pepr_tpu_torch.models.msa import Alignment as TAlignment
from pepr_tpu_torch.utils.simulate import random_tree, simulate_families


@pytest.fixture(scope="module")
def families():
    """12 families over 10 taxa from one tree, 3 of them from another
    (incongruent) tree, ~10% of taxa absent per family, 3% X."""
    rng = np.random.default_rng(61)
    taxa = [f"T{i}" for i in range(10)]
    fams = simulate_families(random_tree(taxa, rng, scale=0.1),
                             rng.integers(40, 90, size=12), rng, alpha=0.6)
    fams += simulate_families(random_tree(taxa, rng, scale=0.1),
                              rng.integers(40, 90, size=3), rng, alpha=0.6)
    out = []
    for g, (n, t, c) in enumerate(fams):
        c = c.copy()
        c[rng.random(c.shape) < 0.03] = 22
        out.append((f"g{g:02d}", t, c))
    return ([JAlignment(n, t, c) for n, t, c in out],
            [TAlignment(n, t, c) for n, t, c in out])


def test_column_bipartitions_identical(families):
    j, t = families
    idx = {f"T{i}": i for i in range(10)}
    for a, b in zip(t, j):
        for side in (1, 2, 3):
            assert tcong.column_bipartitions(a, idx, side) == \
                jcong.column_bipartitions(b, idx, side)


@pytest.mark.parametrize("top", [1, 4])
def test_congruence_scores(families, top):
    j, t = families
    got = tcong.congruence_scores(t, top)
    want = jcong.congruence_scores(j, top)
    assert got.shape == (15,) and (got > 0).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("drop", [0.0, 0.1, 0.2, 0.5])
def test_filter_congruent_keeps_the_same_families(families, drop):
    j, t = families
    got = [a.name for a in tcong.filter_congruent(t, drop)]
    want = [a.name for a in jcong.filter_congruent(j, drop)]
    assert got == want
    assert len(got) == 15 - int(15 * drop)
    assert [a.name for a in tcong.filter_congruent(t[:2], 0.5)] == \
        ["g00", "g01"]


@pytest.fixture(scope="module")
def concat(families):
    j, t = families
    jc, tc = jconcat.concatenate(j), tconcat.concatenate(t)
    ch = jlik.tree_to_arrays(jnj(jc.mat, jc.taxa), jc.taxa).children
    return jc, tc, ch


def test_step_counts_identical(concat):
    jc, tc, ch = concat
    np.testing.assert_array_equal(tconcat.minimum_steps_per_site(tc.mat),
                                  jconcat.minimum_steps_per_site(jc.mat))
    got = tconcat.steps_per_site(tc, ch, device="cpu")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jconcat.steps_per_site(jc, ch))
    beyond = tconcat.steps_beyond_minimum_per_site(tc, ch, device="cpu")
    np.testing.assert_array_equal(
        beyond, jconcat.steps_beyond_minimum_per_site(jc, ch))
    assert (beyond >= 0).all()


def test_threshold_steps_identical(concat):
    jc, tc, ch = concat
    steps = jconcat.steps_beyond_minimum_per_site(jc, ch)
    mask = np.zeros(jc.n_genes, bool)
    mask[[1, 4]] = True
    for g in range(jc.n_genes):
        for kw in (dict(), dict(reps=40, alpha=0.1, seed=3),
                   dict(gene_mask=mask), dict(gene_mask=np.ones(15, bool))):
            assert tconcat.threshold_steps_for_gene(tc, steps, g, **kw) == \
                jconcat.threshold_steps_for_gene(jc, steps, g, **kw)
    assert tconcat.threshold_steps_for_gene(
        tc, steps, 0, gene_mask=np.ones(15, bool)) == -1
