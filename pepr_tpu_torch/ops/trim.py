"""Alignment trimming with Gblocks block-selection semantics (numpy copy
of `pepr_tpu/ops/trim.py`).

Replacement for the reference's `Gblocks <f> -o -b1=ceil(0.8N) -b3=8
-b5=h` invocation (MSATrimmer.java:61-126).  Implements the published
Gblocks algorithm (Castresana 2000) as vectorized column classification:

1. classify positions by conservation of the most frequent residue
   (b1 = conserved threshold, b2 = highly-conserved/flank threshold)
   with the b5 gap rule ('h': a position with gaps in > half the
   sequences is nonconserved),
2. reject contiguous nonconserved stretches longer than b3,
3. trim remaining blocks to their flanking highly-conserved positions,
4. remove gap positions and nonconserved positions contiguous to them,
5. drop blocks shorter than b4.

Also the reference's two pure-Java trims: uniform (min-steps-per-site)
and topologically-uninformative column removal
(MSATrimmer.java:205-253, 264-351).
"""

from __future__ import annotations

import numpy as np

from pepr_tpu_torch.alphabet import GAP, N_AA, PAD


def _column_counts(mat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(L,) count of the most frequent residue per column (gaps and
    ambiguity codes excluded) and (L,) gap counts (GAP/PAD/'?')."""
    n, L = mat.shape
    counts = np.zeros((N_AA, L), dtype=np.int32)
    for a in range(N_AA):
        counts[a] = (mat == a).sum(axis=0)
    most = counts.max(axis=0)
    gaps = ((mat == GAP) | (mat == PAD)).sum(axis=0)
    return most, gaps


def gblocks_mask(mat: np.ndarray, b1: int | None = None,
                 b2: int | None = None, b3: int = 8, b4: int = 10,
                 b5: str = "h") -> np.ndarray:
    """Boolean column mask of retained positions.

    Defaults mirror the reference invocation: b1 = ceil(0.8*N)
    (MSATrimmer.java:100-102), b2 = max(b1, ceil(0.85*N)) (Gblocks
    default), b3 = 8, b4 = 10, b5 = 'h'.
    """
    n, L = mat.shape
    if L == 0:
        return np.zeros(0, dtype=bool)
    if b1 is None:
        b1 = int(np.ceil(0.8 * n))
    if b2 is None:
        b2 = max(b1, int(np.ceil(0.85 * n)))
    most, gaps = _column_counts(mat)

    if b5 == "a":  # all gap positions allowed
        gap_bad = np.zeros(L, dtype=bool)
    elif b5 == "h":  # allowed if gaps in <= half
        gap_bad = gaps > (n // 2)
    else:  # 'n': no gaps allowed
        gap_bad = gaps > 0

    conserved = (most >= b1) & ~gap_bad
    high = (most >= b2) & ~gap_bad
    nonconserved = ~conserved

    keep = np.ones(L, dtype=bool)

    # 2. reject nonconserved stretches > b3
    run_start = None
    for i in range(L + 1):
        bad = i < L and nonconserved[i]
        if bad and run_start is None:
            run_start = i
        elif not bad and run_start is not None:
            if i - run_start > b3:
                keep[run_start:i] = False
            run_start = None

    # 3. trim each remaining block to flanking highly conserved positions
    keep = _trim_blocks_to_flanks(keep, high)

    # 4. remove gap positions and nonconserved positions contiguous to
    # them (within retained blocks)
    bad_gap = gap_bad & keep
    if bad_gap.any():
        to_remove = bad_gap.copy()
        for i in np.where(bad_gap)[0]:
            j = i - 1
            while j >= 0 and keep[j] and nonconserved[j]:
                to_remove[j] = True
                j -= 1
            j = i + 1
            while j < L and keep[j] and nonconserved[j]:
                to_remove[j] = True
                j += 1
        keep &= ~to_remove

    # 5. drop small blocks
    keep = _drop_small_blocks(keep, b4)
    return keep


def _blocks(mask: np.ndarray):
    L = len(mask)
    i = 0
    while i < L:
        if mask[i]:
            j = i
            while j < L and mask[j]:
                j += 1
            yield i, j
            i = j
        else:
            i += 1


def _trim_blocks_to_flanks(keep: np.ndarray, high: np.ndarray) -> np.ndarray:
    out = keep.copy()
    for i, j in _blocks(keep):
        hs = np.where(high[i:j])[0]
        if len(hs) == 0:
            out[i:j] = False
        else:
            out[i:i + hs[0]] = False
            out[i + hs[-1] + 1:j] = False
    return out


def _drop_small_blocks(keep: np.ndarray, b4: int) -> np.ndarray:
    out = keep.copy()
    for i, j in _blocks(keep):
        if j - i < b4:
            out[i:j] = False
    return out


def trim_gblocks(mat: np.ndarray, **kw) -> np.ndarray:
    return mat[:, gblocks_mask(mat, **kw)]


# -- reference's pure-Java alternatives -----------------------------------

def min_steps_per_column(mat: np.ndarray) -> np.ndarray:
    """Minimum parsimony steps per column = (#distinct residues) - 1,
    gaps excluded (SequenceAlignment.java:673-682 semantics)."""
    n, L = mat.shape
    steps = np.zeros(L, dtype=np.int32)
    for a in range(N_AA):
        steps += ((mat == a).sum(axis=0) > 0).astype(np.int32)
    return np.maximum(steps - 1, 0)


def uniform_trim_mask(mat: np.ndarray, max_steps: int = 0) -> np.ndarray:
    """Keep only columns with at most `max_steps` minimum parsimony
    steps (MSATrimmer.java:205-253 'uniform' trim keeps invariant
    columns by default)."""
    return min_steps_per_column(mat) <= max_steps


def informative_mask(mat: np.ndarray) -> np.ndarray:
    """Keep topologically informative columns: at least two residue
    states each present in at least two sequences
    (MSATrimmer.java:264-351)."""
    n, L = mat.shape
    multi = np.zeros(L, dtype=np.int32)
    for a in range(N_AA):
        multi += ((mat == a).sum(axis=0) >= 2).astype(np.int32)
    return multi >= 2
