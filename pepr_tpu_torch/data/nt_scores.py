"""Nucleotide alignment scoring — the blastn-equivalent parameters.

The reference's nucleotide homology search shells out to
`blastall -p blastn` (BlastRunner.java:603-706, BlastnRunnable) with
NCBI defaults: match +1 / mismatch -3 reward-penalty, gap open 5,
gap extend 2.  This module provides the same scoring for the SW
kernel plus the Karlin-Altschul statistics used for bit scores and
E-values (the published NCBI gapped values for +1/-3, 5/2:
lambda=1.28, K=0.46; ungapped lambda=1.33, K=0.621).
"""

from __future__ import annotations

import numpy as np

from pepr_tpu_torch.alphabet import GAP, N_CODES, N_NT, PAD

NT_MATCH = 1.0
NT_MISMATCH = -3.0
NT_GAP_OPEN = 5
NT_GAP_EXTEND = 2

LAMBDA_NT_GAPPED = 1.28
K_NT_GAPPED = 0.46
LAMBDA_NT_UNGAPPED = 1.33
K_NT_UNGAPPED = 0.621


def nt_kernel_matrix(dtype=np.float32) -> np.ndarray:
    """(N_CODES, N_CODES) substitution matrix for nucleotide SW:
    +1 on the ACGT diagonal, -3 off-diagonal (ambiguity codes score as
    mismatches), GAP/PAD rows strongly negative so padded regions can
    never join a positive-scoring local alignment (same convention as
    the protein kernel_matrix)."""
    m = np.full((N_CODES, N_CODES), NT_MISMATCH, dtype=dtype)
    for i in range(N_NT):
        m[i, i] = NT_MATCH
    m[GAP, :] = -1e4
    m[:, GAP] = -1e4
    m[PAD, :] = -1e4
    m[:, PAD] = -1e4
    return m


def nt_core(dtype=np.float32) -> np.ndarray:
    """(20, 20) residue-core scores for the profile aligner: the +1/-3
    block in states 0-3; dead protein states (never present in
    nucleotide data) score as mismatches."""
    from pepr_tpu_torch.alphabet import N_AA
    m = np.full((N_AA, N_AA), NT_MISMATCH, dtype=dtype)
    for i in range(N_NT):
        m[i, i] = NT_MATCH
    return m


def nt_raw_to_bit_score(raw: np.ndarray, gapped: bool = True) -> np.ndarray:
    """Raw nucleotide SW score -> bit score (AlignmentUtilities.java:
    414-432 semantics with the blastn parameter set)."""
    lam = LAMBDA_NT_GAPPED if gapped else LAMBDA_NT_UNGAPPED
    k = K_NT_GAPPED if gapped else K_NT_UNGAPPED
    return (lam * np.asarray(raw, dtype=np.float64) - np.log(k)) \
        / np.log(2.0)
