"""The Smith-Waterman kernel's binding and wrapper.

The CUDA source is `csrc/sw.cu` (replacing the Pallas kernel
`pepr_tpu/ops/pallas_sw.py::_kernel`), built by `ops/_cuda.py` into
`_build/libpepr_sw.so` and loaded with `ctypes`.  `sw_align` launches it
on CUDA tensors and raises on anything else; its plain PyTorch version
is `ops/smith_waterman.sw_align_batch`, and `sw_align_batch_fast` there
picks between the two by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from pepr_tpu_torch.alphabet import N_CODES, PAD
from pepr_tpu_torch.ops import _cuda

MAX_LEN = 4096
WARP = 32
MAX_ROWS = 8  # query rows a lane holds at most (csrc/sw.cu)
# Scores, penalties and substitution values stay far inside int32: the
# DP's "minus infinity" is -2**28.
MAX_ABS = 1 << 20

SOURCE = _cuda.source_path("sw")

# Launch count, bumped where the wrapper launches the kernel.
LAUNCHES = {"sw": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# Argument lists of the C functions (checked against the source by the
# tests).
ARGTYPES = {
    "sw_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                  _L, _P],
    "sw_max_len": [],
    "sw_max_rows": [],
    "sw_scratch_bytes": [_I, _I, _I],
    "sw_blocks_per_sm": [],
    "sw_num_regs": [],
    "sw_error_string": [_I],
}
RESTYPES = {"sw_launch": _I, "sw_max_len": _I, "sw_max_rows": _I,
            "sw_scratch_bytes": _L, "sw_blocks_per_sm": _I,
            "sw_num_regs": _I, "sw_error_string": ctypes.c_char_p}

_lib = None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = _cuda.load("sw", ARGTYPES, RESTYPES)
        if (lib.sw_max_len(), lib.sw_max_rows()) != (MAX_LEN, MAX_ROWS):
            raise RuntimeError("sw library was built with another MAX_LEN "
                               "or MAX_ROWS than ops/sw.py expects")
        _lib = lib
    return _lib


def strip_layout(lq: int) -> tuple[int, int]:
    """(strips, rows a lane) of the kernel's walk over a query of `lq`
    real rows: strips of WARP * rows rows, as few as MAX_ROWS allows."""
    n = max(1, -(-lq // (WARP * MAX_ROWS)))
    return n, max(1, -(-lq // (WARP * n)))


def integer_sub(sub, device=None) -> torch.Tensor:
    """A (25, 25) substitution matrix as contiguous int32 on `device`
    (default: where `sub` is); raises unless every value is an integer
    of magnitude <= 2**20."""
    s = torch.as_tensor(sub, device=device)
    if s.shape != (N_CODES, N_CODES):
        raise ValueError(f"sub must be ({N_CODES}, {N_CODES}), got "
                         f"{tuple(s.shape)}")
    if s.dtype == torch.int32:
        si = s
    else:
        si = s.to(torch.int32)
        if not bool((si.to(s.dtype) == s).all()):
            raise ValueError("sub must hold integer values (the DP runs in "
                             "int32)")
    if int(si.abs().max()) > MAX_ABS:
        raise ValueError(f"sub values must lie within +-{MAX_ABS}")
    return si.contiguous()


def check_pad_scores(sub: torch.Tensor) -> None:
    """Raise unless every score of the PAD row and column is <= 0: the
    kernel walks only the real cells, which is exact only then (the
    argument is in csrc/sw.cu)."""
    if bool(torch.cat([sub[PAD, :], sub[:, PAD]]).gt(0).any()):
        raise ValueError("the SW kernel needs every score of the PAD row "
                         "and column of sub to be <= 0")


def check_gaps(gap_open: int, gap_extend: int) -> tuple[int, int]:
    go, ge = int(gap_open), int(gap_extend)
    if go != gap_open or ge != gap_extend or not 0 <= go <= MAX_ABS \
            or not 0 <= ge <= MAX_ABS:
        raise ValueError(f"gap penalties must be integers in [0, {MAX_ABS}], "
                         f"got {gap_open}, {gap_extend}")
    return go, ge


def sw_align(q: torch.Tensor, t: torch.Tensor, sub: torch.Tensor,
             gap_open: int = 11, gap_extend: int = 1) -> dict:
    """The kernel: q (B, Lq) and t (B, Lt) int8 codes, sub (25, 25)
    int32 (`integer_sub`) with no positive score in its PAD row or
    column, all on one CUDA device.  Returns the dict of (B,) tensors of
    `sw_align_batch`."""
    if sub.dtype != torch.int32 or sub.shape != (N_CODES, N_CODES):
        raise ValueError("sub must be int32 (25, 25); see integer_sub")
    check_pad_scores(sub)
    dev = q.device
    for name, x in (("q", q), ("t", t), ("sub", sub)):
        if x.device != dev or x.device.type != "cuda":
            raise ValueError(f"{name} must be on {dev} (a CUDA device), got "
                             f"{x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype != torch.int8 or t.dtype != torch.int8:
        raise ValueError("q and t must be int8 codes")
    if q.dim() != 2 or t.dim() != 2 or q.shape[0] != t.shape[0]:
        raise ValueError(f"q and t must be (B, Lq) and (B, Lt), got "
                         f"{tuple(q.shape)} and {tuple(t.shape)}")
    B, Lq = q.shape
    Lt = t.shape[1]
    if B < 1 or not 1 <= Lq <= MAX_LEN or not 1 <= Lt <= MAX_LEN \
            or B >= 1 << 31:
        raise ValueError(f"empty or oversized batch (B={B}, Lq={Lq}, "
                         f"Lt={Lt}; lengths <= {MAX_LEN})")
    go, ge = check_gaps(gap_open, gap_extend)
    lib = library()
    with torch.cuda.device(dev):
        n_scratch = lib.sw_scratch_bytes(B, Lq, Lt)
    if n_scratch < 0:
        raise RuntimeError(f"sw scratch size: CUDA error {-n_scratch} "
                           f"({lib.sw_error_string(-n_scratch).decode()})")
    score = torch.empty(B, dtype=torch.float32, device=dev)
    ints = torch.empty((4, B), dtype=torch.int32, device=dev)
    scratch = torch.empty(n_scratch, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    LAUNCHES["sw"] += 1
    rc = lib.sw_launch(q.data_ptr(), t.data_ptr(), sub.data_ptr(), B, Lq, Lt,
                       go, ge, score.data_ptr(), ints[0].data_ptr(),
                       ints[1].data_ptr(), ints[2].data_ptr(),
                       ints[3].data_ptr(), scratch.data_ptr(), n_scratch,
                       stream)
    if rc != 0:
        raise RuntimeError(f"sw launch failed: CUDA error {rc} "
                           f"({lib.sw_error_string(rc).decode()})")
    return {"score": score, "matches": ints[0], "length": ints[1],
            "q_end": ints[2], "t_end": ints[3]}
