"""BLOSUM62 substitution matrix (standard NCBI values, public data).

Row/column order follows pepr_tpu_torch.alphabet: ARNDCQEGHILKMFPSTWYV B Z X.
Used by the Smith-Waterman homology kernel and pairwise NJ scoring
(reference behavior: AlignmentUtilities.java:371-398 loads the same
matrix from a classpath resource; note the reference's loader has a
column-shift bug for Z/X which we deliberately do not reproduce).

Karlin-Altschul parameters for bit-score / E-value conversion follow the
standard gapped BLOSUM62 (gap open 11 / extend 1) values used by blastp;
conversion formulas mirror AlignmentUtilities.java:414-432.
"""

from __future__ import annotations

import numpy as np

from pepr_tpu_torch.alphabet import N_CODES, GAP, PAD

# 24x24: ARNDCQEGHILKMFPSTWYV B Z X + '*' column folded into X.
_B62 = """
 4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0 -2 -1  0
-1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3 -1  0 -1
-2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3  3  0 -1
-2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3  4  1 -1
 0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1 -3 -3 -2
-1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2  0  3 -1
-1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2  1  4 -1
 0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3 -1 -2 -1
-2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3  0  0 -1
-1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3 -3 -3 -1
-1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1 -4 -3 -1
-1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2  0  1 -1
-1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1 -3 -1 -1
-2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1 -3 -3 -1
-1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2 -2 -1 -2
 1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2  0  0  0
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0 -1 -1  0
-3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3 -4 -3 -2
-2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1 -3 -2 -1
 0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4 -3 -2 -1
-2 -1  3  4 -3  0  1 -1  0 -3 -4  0 -3 -3 -2  0 -1 -4 -3 -3  4  1 -1
-1  0  0  1 -3  3  4 -2  0 -3 -3  1 -1 -3 -1  0 -1 -3 -2 -2  1  4 -1
 0 -1 -1 -1 -2 -1 -1 -1 -1 -1 -1 -1 -1 -1 -2  0  0 -2 -1 -1 -1 -1 -1
"""

BLOSUM62 = np.array([int(t) for t in _B62.split()], dtype=np.int32).reshape(23, 23)

# Gapped BLOSUM62 (open 11, extend 1) Karlin-Altschul parameters.
LAMBDA_GAPPED = 0.267
K_GAPPED = 0.041
# Ungapped BLOSUM62 parameters.
LAMBDA_UNGAPPED = 0.3176
K_UNGAPPED = 0.134

GAP_OPEN = 11  # affine gap open penalty (charged on first gap residue)
GAP_EXTEND = 1


def blosum62_matrix(dtype=np.float32, gap_score: float = 0.0,
                    pad_score: float = 0.0) -> np.ndarray:
    """Full N_CODES x N_CODES score matrix: standard 23x23 extended so
    scoring against GAP/PAD contributes `gap_score`/`pad_score`
    (PAD rows let length-padded batches score zero against anything)."""
    m = np.full((N_CODES, N_CODES), gap_score, dtype=dtype)
    m[:23, :23] = BLOSUM62.astype(dtype)
    m[PAD, :] = pad_score
    m[:, PAD] = pad_score
    m[GAP, :] = gap_score
    m[:, GAP] = gap_score
    m[PAD, :] = pad_score
    m[:, PAD] = pad_score
    return m


def raw_to_bit_score(raw: np.ndarray, gapped: bool = True) -> np.ndarray:
    """Raw alignment score -> bit score (AlignmentUtilities.java:414-432
    semantics with standard gapped parameters)."""
    lam = LAMBDA_GAPPED if gapped else LAMBDA_UNGAPPED
    k = K_GAPPED if gapped else K_UNGAPPED
    return (lam * np.asarray(raw, dtype=np.float64) - np.log(k)) / np.log(2.0)


def bit_score_to_evalue(bits: np.ndarray, m: np.ndarray, n: np.ndarray) -> np.ndarray:
    """E = m*n*2^-bits for search space of query length m, db length n."""
    return np.asarray(m, dtype=np.float64) * np.asarray(n, dtype=np.float64) \
        * np.exp2(-np.asarray(bits, dtype=np.float64))
