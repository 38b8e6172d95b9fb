"""The port's plain Smith-Waterman (pepr_tpu_torch.ops.smith_waterman.
sw_align_batch, the function of the CUDA kernel csrc/sw.cu) against the
JAX package on the CPU: equal on all five outputs to the Pallas kernel
in interpret mode and to the numpy oracle (11/1 BLOSUM62, 5/2 blastn,
gap_open == gap_extend), the same choice among tied top cells (smallest
query end, then smallest target end), and scores equal to the JAX
wavefront scan.  All outputs are integers: compared exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pepr_tpu.data.nt_scores import nt_kernel_matrix as j_nt_kernel_matrix
from pepr_tpu.ops.pallas_sw import sw_align_batch_pallas
from pepr_tpu.ops.smith_waterman import kernel_matrix as j_kernel_matrix
from pepr_tpu.ops.smith_waterman import sw_align_batch as j_sw_align_batch
from pepr_tpu.ops.smith_waterman import sw_align_numpy as j_sw_align_numpy

from pepr_tpu_torch.data.nt_scores import nt_kernel_matrix
from pepr_tpu_torch.ops.smith_waterman import (kernel_matrix, sw_align_batch,
                                               sw_align_numpy)

torch.set_num_threads(2)

KEYS = ("score", "matches", "length", "q_end", "t_end")


@pytest.fixture(scope="module")
def batch():
    """The fixture of tests/test_pallas_sw.py: 16 pairs of 64 x 96,
    homologs planted in every other pair, PAD tails on pair 3."""
    rng = np.random.default_rng(2)
    B, Lq, Lt = 16, 64, 96
    q = rng.integers(0, 20, size=(B, Lq)).astype(np.int8)
    t = rng.integers(0, 20, size=(B, Lt)).astype(np.int8)
    for b in range(0, B, 2):
        t[b, 10:10 + 40] = q[b, 5:45]
        mut = rng.random(40) < 0.2
        t[b, 10:10 + 40][mut] = rng.integers(0, 20, mut.sum())
    q[3, 50:] = 24
    t[3, 70:] = 24
    return q, t


def _port(q, t, sub, go=11, ge=1):
    got = sw_align_batch(torch.as_tensor(q), torch.as_tensor(t), sub, go, ge)
    return {k: v.numpy() for k, v in got.items()}


def test_matrices_are_the_jax_packages():
    np.testing.assert_array_equal(kernel_matrix(), j_kernel_matrix())
    np.testing.assert_array_equal(nt_kernel_matrix(), j_nt_kernel_matrix())


def test_plain_equals_pallas_interpret(batch):
    q, t = batch
    got = _port(q, t, kernel_matrix())
    want = sw_align_batch_pallas(jnp.asarray(q), jnp.asarray(t),
                                 jnp.asarray(j_kernel_matrix()),
                                 interpret=True)
    assert got["score"].dtype == np.float32
    for k in KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("params", ["blosum62_11_1", "blastn_5_2",
                                    "equal_gaps_2_2", "zero_gaps"])
def test_plain_equals_numpy_oracle(batch, params):
    q, t = batch
    sub, go, ge = {"blosum62_11_1": (kernel_matrix(), 11, 1),
                   "blastn_5_2": (nt_kernel_matrix(), 5, 2),
                   "equal_gaps_2_2": (kernel_matrix(), 2, 2),
                   "zero_gaps": (kernel_matrix(), 0, 0)}[params]
    if params == "blastn_5_2":  # ACGT codes, PAD kept
        q = np.where(q == 24, q, q % 4).astype(np.int8)
        t = np.where(t == 24, t, t % 4).astype(np.int8)
    got = _port(q, t, sub, go, ge)
    for b in range(len(q)):
        want = j_sw_align_numpy(q[b], t[b], sub, go, ge)
        assert {k: float(got[k][b]) for k in KEYS} == \
            {k: float(want[k]) for k in KEYS}, b


def test_numpy_oracle_is_the_jax_packages(batch):
    q, t = batch
    for b in (0, 3):
        assert sw_align_numpy(q[b], t[b], kernel_matrix()) == \
            j_sw_align_numpy(q[b], t[b], j_kernel_matrix())


@pytest.fixture(scope="module")
def ties():
    """Pairs whose top score is reached at two cells.  Pair 0: one
    query row, two target copies of the motif.  Pair 1: two query
    copies, one target copy.  Pair 2: motifs A and B (B a permutation
    of A, so the same self-score) in the order A B in the query and
    B ... A in the target, so that the first best query row has the
    later anti-diagonal (the scan's diagonal-major order picks the
    other cell)."""
    L = 48
    pad = np.full((3, L), 24, np.int8)
    q, t = pad.copy(), pad.copy()
    motif = np.array([17, 4, 12, 18, 8, 14, 10, 1, 6, 13], np.int8)
    a, bm = motif, motif[::-1].copy()
    q[0, :10] = motif
    t[0, :30] = np.concatenate([motif, [7] * 10, motif])
    q[1, :30] = np.concatenate([motif, [7] * 10, motif])
    t[1, :10] = motif
    q[2, :20] = np.concatenate([a, bm])
    t[2, :32] = np.concatenate([bm, [7] * 12, a])
    return q, t


def test_ties_follow_numpy_and_pallas_order(ties):
    q, t = ties
    sub = kernel_matrix()
    got = _port(q, t, sub)
    pallas = sw_align_batch_pallas(jnp.asarray(q), jnp.asarray(t),
                                   jnp.asarray(sub), interpret=True)
    for b in range(len(q)):
        want = sw_align_numpy(q[b], t[b], sub)
        assert {k: float(got[k][b]) for k in KEYS} == \
            {k: float(want[k]) for k in KEYS}, b
    for k in KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(pallas[k]),
                                      err_msg=k)
    # the ties are real: the chosen cell is the first of two
    assert (got["q_end"][0], got["t_end"][0]) == (9, 9)
    assert (got["q_end"][1], got["t_end"][1]) == (9, 9)
    assert (got["q_end"][2], got["t_end"][2]) == (9, 31)


@pytest.mark.parametrize("which", ["planted", "ties"])
def test_scores_equal_jax_scan(batch, ties, which):
    q, t = batch if which == "planted" else ties
    got = _port(q, t, kernel_matrix())
    want = j_sw_align_batch(jnp.asarray(q), jnp.asarray(t),
                            jnp.asarray(j_kernel_matrix()))
    np.testing.assert_array_equal(got["score"], np.asarray(want["score"]))
