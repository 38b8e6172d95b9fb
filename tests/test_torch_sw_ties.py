"""Tied top cells in Smith-Waterman (ROADMAP Queue 3, F2): two cells of
equal top score whose alignments carry different `matches` and
`length`.  The port's plain SW (the function of csrc/sw.cu) must give
all five outputs of the Pallas kernel in interpret mode, and of the
numpy oracle, exactly.  The JAX package's XLA scan, which it takes on
the CPU, picks the other cell: the size of that disagreement, through
both packages' `search_all_vs_all`, is pinned here (identity and length
of the planted hits decide which of them pass the hit filters)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pepr_tpu.io.fasta import SequenceSet as JSet
from pepr_tpu.models.homology import search_all_vs_all as j_search
from pepr_tpu.ops.pallas_sw import sw_align_batch_pallas
from pepr_tpu.ops.smith_waterman import sw_align_batch as j_scan

from pepr_tpu_torch.io.fasta import SequenceSet
from pepr_tpu_torch.models.homology import search_all_vs_all
from pepr_tpu_torch.ops.smith_waterman import (kernel_matrix, sw_align_batch,
                                               sw_align_numpy)

torch.set_num_threads(2)

KEYS = ("score", "matches", "length", "q_end", "t_end")
W, C, H, A, S, P = 17, 4, 8, 0, 15, 14  # AA_ORDER codes
# motif X scores 105 against itself over 10 identical residues; motif
# Z (27 A) scores 105 against a copy with one A -> S over 27 columns
X = [W] * 8 + [C, H]
ZQ = [A] * 27
ZT = [A] * 13 + [S] + [A] * 13


def _tied_pair():
    """Query X Z, target Z' ... X: the first top-scoring query row (X's
    end) lies on the later anti-diagonal, so the scan's diagonal-major
    order picks Z's cell."""
    return (np.array(X + ZQ, np.int8),
            np.array(ZT + [P] * 20 + X, np.int8))


def _batch():
    q, t = _tied_pair()
    Lq, Lt = 48, 64
    qb = np.full((2, Lq), 24, np.int8)
    tb = np.full((2, Lt), 24, np.int8)
    qb[0, :len(q)], tb[0, :len(t)] = q, t
    # the mirror image: the tie with the roles of X and Z swapped
    qb[1, :len(q)] = np.array(ZQ + X, np.int8)
    tb[1, :len(t)] = np.array(X + [P] * 20 + ZT, np.int8)
    return qb, tb


def test_planted_ties_plain_equals_pallas_and_oracle():
    q, t = _batch()
    sub = kernel_matrix()
    got = sw_align_batch(torch.as_tensor(q), torch.as_tensor(t), sub)
    got = {k: v.numpy() for k, v in got.items()}
    pallas = sw_align_batch_pallas(jnp.asarray(q), jnp.asarray(t),
                                   jnp.asarray(sub), interpret=True)
    for k in KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(pallas[k]),
                                      err_msg=k)
    for b in range(len(q)):
        want = sw_align_numpy(q[b], t[b], sub)
        assert {k: float(got[k][b]) for k in KEYS} == \
            {k: float(want[k]) for k in KEYS}, b
    # the ties are real: both cells score 49, the first query row wins
    np.testing.assert_array_equal(got["score"], [105, 105])
    np.testing.assert_array_equal(got["matches"], [10, 26])
    np.testing.assert_array_equal(got["length"], [10, 27])
    scan = j_scan(jnp.asarray(q), jnp.asarray(t), jnp.asarray(sub))
    np.testing.assert_array_equal(np.asarray(scan["score"]), got["score"])
    np.testing.assert_array_equal(np.asarray(scan["matches"]), [26, 10])
    np.testing.assert_array_equal(np.asarray(scan["length"]), [27, 10])


@pytest.fixture(scope="module")
def searches():
    """Three genomes of random proteins; genome 0 carries the tied
    pair's query inside a longer protein, genomes 1 and 2 its target."""
    rng = np.random.default_rng(7)
    q, t = _tied_pair()
    sets = []
    for g in range(3):
        seqs = [rng.integers(0, 20, size=int(n)).astype(np.int8)
                for n in rng.integers(40, 90, size=6)]
        seqs.append(q if g == 0 else t)
        titles = [f"g{g}_p{i}" for i in range(len(seqs))]
        sets.append((f"g{g}", titles, seqs))
    got = search_all_vs_all([SequenceSet(*s) for s in sets], device="cpu")
    want = j_search([JSet(n, list(ti), list(se)) for n, ti, se in sets])
    return got, want


def test_search_tie_disagreement_with_jax_scan(searches):
    """The tie decides the blat-style min_score filter (matches minus
    mismatches >= 15): the port's cell (10 of 10 matched, 10) drops the
    planted cross-genome hits that the scan's cell (26 of 27, 25)
    keeps.  Every other hit is identical in every field."""
    (uni, hits), (_, jhits) = searches
    fields = ("raw", "bits", "evalue", "identity", "length")
    port = {(int(a), int(b)): k for k, (a, b) in
            enumerate(zip(hits.query, hits.target))}
    jax_ = {(int(a), int(b)): k for k, (a, b) in
            enumerate(zip(jhits.query, jhits.target))}
    assert set(port) <= set(jax_)
    for pair, k in port.items():
        for f in fields:
            assert getattr(hits, f)[k] == getattr(jhits, f)[jax_[pair]], \
                (pair, f)
    tied = [uni.ids.index(f"g{g}_p6") for g in range(3)]
    only_jax = set(jax_) - set(port)
    # the planted query's hits in genomes 1 and 2, and theirs back to it
    assert only_jax == {(tied[0], tied[1]), (tied[0], tied[2]),
                        (tied[1], tied[0]), (tied[2], tied[0])}
    for pair in only_jax:
        k = jax_[pair]
        assert (jhits.raw[k], jhits.length[k]) == (105, 27)
    assert len(jax_) == len(port) + 4
