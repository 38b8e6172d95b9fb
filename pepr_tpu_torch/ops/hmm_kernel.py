"""The profile-HMM scoring kernel's binding and wrapper.

The CUDA source is `csrc/hmm.cu`, built by `ops/_cuda.py` into
`_build/libpepr_hmm.so` and loaded with `ctypes`.  It is not a port of a
TPU kernel: the JAX package scores with an XLA scan
(`pepr_tpu/ops/hmm.py:206` `viterbi_segment`), whose plain PyTorch
version is `ops/hmm.viterbi_score_batch`.  `hmm_score` launches the
kernel on CUDA tensors and raises on anything else; `ops/hmm.score_chunk`
picks between the two by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from pepr_tpu_torch.ops import _cuda

MAX_MPAD = 4096
N_AA = 20

SOURCE = _cuda.source_path("hmm")

# Launch count, bumped where the wrapper launches the kernel.
LAUNCHES = {"hmm": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
# Argument lists of the C functions (checked against the source by the
# tests).
ARGTYPES = {
    "hmm_launch": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P,
                   _P, _I, _I, _I, _P, _P],
    "hmm_max_mpad": [],
    "hmm_warps_per_block": [],
    "hmm_smem_bytes": [_I],
    "hmm_num_regs": [_I],
    "hmm_error_string": [_I],
}
RESTYPES = {"hmm_launch": _I, "hmm_max_mpad": _I, "hmm_warps_per_block": _I,
            "hmm_smem_bytes": ctypes.c_longlong, "hmm_num_regs": _I,
            "hmm_error_string": ctypes.c_char_p}

_lib = None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = _cuda.load("hmm", ARGTYPES, RESTYPES)
        if lib.hmm_max_mpad() != MAX_MPAD:
            raise RuntimeError("hmm library was built with another MAX_MPAD "
                               "than ops/hmm_kernel.py expects")
        _lib = lib
    return _lib


def hmm_score(codes_all: torch.Tensor, lens_all: torch.Tensor,
              emit_all: torch.Tensor, trans_all, m_lens_all: torch.Tensor,
              seq_idx: torch.Tensor, hmm_idx: torch.Tensor, lpad: int,
              forward: bool) -> torch.Tensor:
    """The kernel: raw Forward (or Viterbi) bits of the pairs
    (seq_idx[b], hmm_idx[b]) from the device-resident packs, codes_all
    (N, Lmax) int8, lens_all (N,) int32, emit_all (H, 20, Mpad) float32,
    trans_all the seven (H, Mpad+1) float32 transitions (tmm, tmi, tmd,
    tim, tii, tdm, tdd), m_lens_all (H,) int32, the index vectors (B,)
    int32, all on one CUDA device; sequences are read to
    min(length, lpad).  Returns (B,) float32."""
    dev = codes_all.device
    trans_all = list(trans_all)
    named = [("codes_all", codes_all, torch.int8), ("lens_all", lens_all,
                                                   torch.int32),
             ("emit_all", emit_all, torch.float32),
             ("m_lens_all", m_lens_all, torch.int32),
             ("seq_idx", seq_idx, torch.int32),
             ("hmm_idx", hmm_idx, torch.int32)] + [
        (f"transition {i}", t, torch.float32)
        for i, t in enumerate(trans_all)]
    for name, x, dtype in named:
        if x.device != dev or x.device.type != "cuda":
            raise ValueError(f"{name} must be on {dev} (a CUDA device), got "
                             f"{x.device}")
        if x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if len(trans_all) != 7:
        raise ValueError("trans_all must hold the seven transitions")
    if codes_all.dim() != 2 or emit_all.dim() != 3 \
            or emit_all.shape[1] != N_AA:
        raise ValueError(f"codes_all must be (N, Lmax) and emit_all "
                         f"(H, 20, Mpad), got {tuple(codes_all.shape)} and "
                         f"{tuple(emit_all.shape)}")
    N, lmax = codes_all.shape
    H, _, mpad = emit_all.shape
    if lens_all.shape != (N,) or m_lens_all.shape != (H,) or any(
            t.shape != (H, mpad + 1) for t in trans_all):
        raise ValueError("lens_all, m_lens_all or a transition does not "
                         "match the packs' shapes")
    B = seq_idx.shape[0]
    if seq_idx.shape != (B,) or hmm_idx.shape != (B,):
        raise ValueError("seq_idx and hmm_idx must be (B,)")
    if not 1 <= mpad <= MAX_MPAD or not 1 <= lpad <= lmax:
        raise ValueError(f"need 1 <= Mpad <= {MAX_MPAD} and 1 <= lpad <= "
                         f"Lmax, got Mpad {mpad}, lpad {lpad}, Lmax {lmax}")
    out = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    LAUNCHES["hmm"] += 1
    with torch.cuda.device(dev):
        rc = lib.hmm_launch(
            codes_all.data_ptr(), lmax, lens_all.data_ptr(),
            emit_all.data_ptr(), *[t.data_ptr() for t in trans_all],
            m_lens_all.data_ptr(), mpad, seq_idx.data_ptr(),
            hmm_idx.data_ptr(), B, int(lpad), int(bool(forward)),
            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"hmm launch failed: CUDA error {rc} "
                           f"({lib.hmm_error_string(rc).decode()})")
    return out
