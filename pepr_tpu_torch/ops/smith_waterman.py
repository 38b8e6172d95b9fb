"""Batched affine-gap Smith-Waterman: the plain PyTorch version, the
dispatch to the CUDA kernel, and the numpy oracle.

The compute replacement for the reference's native all-vs-all protein
search (`blat`/`blastall`, BlatRunner.java:424-430 /
BlastRunner.java:574-581): local alignment scores with BLOSUM62 and
affine gaps, for a padded batch of (query, target) pairs, with the
matches and aligned columns of the best path and its end cell.

`sw_align_batch` is an anti-diagonal scan over (B, Lq) int32 state, the
same function as the kernel in `csrc/sw.cu`: exact F, ties broken as
`sw_align_numpy` breaks them (opening before extending; diagonal, then
E, then F), and the best cell chosen as the top score's smallest query
position, then its smallest target position.  `sw_align_batch_fast`
sends CUDA tensors to the kernel and CPU tensors to this version.
"""

from __future__ import annotations

import numpy as np
import torch

from pepr_tpu_torch.alphabet import PAD
from pepr_tpu_torch.data.blosum62 import blosum62_matrix
from pepr_tpu_torch.ops import sw as _sw

NEG = -1e9
NEG_INT = -(1 << 28)  # the kernel's NEG_INF


def kernel_matrix(dtype=np.float32) -> np.ndarray:
    """BLOSUM62 extended so GAP/PAD rows are strongly negative: padded
    regions can never be part of a positive-scoring local alignment."""
    m = blosum62_matrix(dtype=dtype, gap_score=-1e4, pad_score=-1e4)
    return m


def _codes(x: torch.Tensor) -> torch.Tensor:
    """int64 codes, anything outside 0..24 read as PAD (as the kernel
    does)."""
    c = x.long()
    return torch.where((c < 0) | (c > PAD), torch.full_like(c, PAD), c)


def sw_align_batch(q: torch.Tensor, t: torch.Tensor, sub,
                   gap_open: int = 11, gap_extend: int = 1) -> dict:
    """Batched local alignment, plain PyTorch.

    Args:
      q: (B, Lq) int8 query codes (PAD-filled).
      t: (B, Lt) int8 target codes (PAD-filled).
      sub: (25, 25) substitution matrix with integer values
           (`kernel_matrix()`), PAD rows very negative.
      gap_open: penalty charged for the first residue of a gap.
      gap_extend: penalty for each further residue.

    Returns dict of (B,) tensors: score float32, matches, length
    (aligned columns on the optimal path), q_end, t_end (0-based
    inclusive) int32.
    """
    go, ge = _sw.check_gaps(gap_open, gap_extend)
    dev = q.device
    B, Lq = q.shape
    Lt = t.shape[1]
    subf = _sw.integer_sub(sub, dev).reshape(-1)
    qc, tc = _codes(q), _codes(t)
    qoff = qc * _sw.N_CODES
    rows = torch.arange(Lq, device=dev)

    def z():
        return torch.zeros((B, Lq), dtype=torch.int32, device=dev)

    def shift(x, fill):
        """x[:, i] -> x[:, i-1], `fill` above row 0."""
        return torch.nn.functional.pad(x[:, :-1], (1, 0), value=fill)

    hp1, hp2, mlh1, mlh2, mle, mlf = z(), z(), z(), z(), z(), z()
    e, f = z() + NEG_INT, z() + NEG_INT
    bv, bml, bj = z(), z(), z()
    for k in range(Lq + Lt - 1):
        j = k - rows
        valid = ((j >= 0) & (j < Lt))[None, :]
        td = tc[:, j.clamp(0, Lt - 1)]
        # E: gap consuming the target, from (i, j-1)
        eo, ee = hp1 - go, e - ge
        e_open = eo >= ee
        ev = torch.maximum(eo, ee)
        mle_v = torch.where(e_open, mlh1, mle) + 1
        # F: gap consuming the query, from (i-1, j)
        fo, fe = shift(hp1, 0) - go, shift(f, NEG_INT) - ge
        f_open = fo >= fe
        fv = torch.maximum(fo, fe)
        mlf_v = torch.where(f_open, shift(mlh1, 0), shift(mlf, 0)) + 1
        # diagonal, from (i-1, j-1)
        d = shift(hp2, 0) + subf[qoff + td]
        mld = shift(mlh2, 0) + ((qc == td).int() << 16) + 1
        h = torch.maximum(torch.maximum(d, ev), fv.clamp_min(0))
        ml = torch.where(h == d, mld, torch.where(h == ev, mle_v, mlf_v))
        ml = torch.where(h <= 0, 0, ml)
        # each row's best by a strict > along the target
        better = valid & (h > bv)
        bv = torch.where(better, h, bv)
        bml = torch.where(better, ml, bml)
        bj = torch.where(better, j.to(torch.int32)[None, :], bj)
        hp2 = torch.where(valid, hp1, hp2)
        hp1 = torch.where(valid, h, hp1)
        e = torch.where(valid, ev, e)
        f = torch.where(valid, fv, f)
        mlh2 = torch.where(valid, mlh1, mlh2)
        mlh1 = torch.where(valid, ml, mlh1)
        mle = torch.where(valid, mle_v, mle)
        mlf = torch.where(valid, mlf_v, mlf)
    # the first row holding the top score (argmax returns the first)
    row = torch.argmax(bv, dim=1, keepdim=True)
    ml = bml.gather(1, row)[:, 0]
    return {"score": bv.gather(1, row)[:, 0].to(torch.float32),
            "matches": ml >> 16, "length": ml & 0xFFFF,
            "q_end": row[:, 0].to(torch.int32),
            "t_end": bj.gather(1, row)[:, 0]}


def sw_align_batch_fast(q: torch.Tensor, t: torch.Tensor, sub,
                        gap_open: int = 11, gap_extend: int = 1) -> dict:
    """The production dispatch: the CUDA kernel (`ops/sw.py`) for
    tensors on the card, the plain version for tensors on the CPU."""
    if q.is_cuda:
        return _sw.sw_align(q, t, _sw.integer_sub(sub, q.device),
                            gap_open=gap_open, gap_extend=gap_extend)
    return sw_align_batch(q, t, sub, gap_open=gap_open,
                          gap_extend=gap_extend)


def sw_align_numpy(q: np.ndarray, t: np.ndarray, sub: np.ndarray,
                   gap_open: int = 11, gap_extend: int = 1) -> dict:
    """Plain-python reference implementation (test oracle)."""
    Lq, Lt = len(q), len(t)
    H = np.zeros((Lq + 1, Lt + 1))
    E = np.full((Lq + 1, Lt + 1), NEG)
    F = np.full((Lq + 1, Lt + 1), NEG)
    M = np.zeros((Lq + 1, Lt + 1), dtype=int)  # matches on path
    L = np.zeros((Lq + 1, Lt + 1), dtype=int)
    ME = np.zeros((Lq + 1, Lt + 1), dtype=int)
    LE = np.zeros((Lq + 1, Lt + 1), dtype=int)
    MF = np.zeros((Lq + 1, Lt + 1), dtype=int)
    LF = np.zeros((Lq + 1, Lt + 1), dtype=int)
    best, bm, bl, bqe, bte = 0.0, 0, 0, 0, 0
    for i in range(1, Lq + 1):
        for j in range(1, Lt + 1):
            eo, ee = H[i, j - 1] - gap_open, E[i, j - 1] - gap_extend
            E[i, j] = max(eo, ee)
            if eo >= ee:
                ME[i, j], LE[i, j] = M[i, j - 1], L[i, j - 1] + 1
            else:
                ME[i, j], LE[i, j] = ME[i, j - 1], LE[i, j - 1] + 1
            fo, fe = H[i - 1, j] - gap_open, F[i - 1, j] - gap_extend
            F[i, j] = max(fo, fe)
            if fo >= fe:
                MF[i, j], LF[i, j] = M[i - 1, j], L[i - 1, j] + 1
            else:
                MF[i, j], LF[i, j] = MF[i - 1, j], LF[i - 1, j] + 1
            d = H[i - 1, j - 1] + sub[q[i - 1], t[j - 1]]
            h = max(0.0, d, E[i, j], F[i, j])
            H[i, j] = h
            if h <= 0:
                M[i, j] = L[i, j] = 0
            elif h == d:
                M[i, j] = M[i - 1, j - 1] + int(q[i - 1] == t[j - 1])
                L[i, j] = L[i - 1, j - 1] + 1
            elif h == E[i, j]:
                M[i, j], L[i, j] = ME[i, j], LE[i, j]
            else:
                M[i, j], L[i, j] = MF[i, j], LF[i, j]
            if h > best:
                best, bm, bl = h, M[i, j], L[i, j]
                bqe, bte = i - 1, j - 1
    return {"score": best, "matches": bm, "length": bl,
            "q_end": bqe, "t_end": bte}
