"""The profile-HMM scoring kernel's binding, its walk pack and wrapper.

The CUDA source is `csrc/hmm.cu`, built by `ops/_cuda.py` into
`_build/libpepr_hmm.so` and loaded with `ctypes`.  It is not a port of a
TPU kernel: the JAX package scores with an XLA scan
(`pepr_tpu/ops/hmm.py:206` `viterbi_segment`), whose plain PyTorch
version is `ops/hmm.viterbi_score_batch`.

A group of `threads` threads scores a pair (`threads_for`: a warp up to
256 columns, then a block of 128 or 512 threads); thread t holds the
consecutive columns [t ce, t ce + ce), ce = ceil(M / threads).  `walk_pack` lays an
mpad pack out for that walk once, in plain PyTorch on the pack's device:
column k = t ce + j goes to slot j threads + t, so a group's threads read
neighbouring slots.  `hmm_score` launches the kernel on CUDA tensors and
raises on anything else; `ops/hmm.score_chunk` picks between it and the
plain version by the tensors' device.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from pepr_tpu_torch.ops import _cuda

MAX_MPAD = 4096
N_AA = 20
EMIT_ROWS = N_AA + 1  # the residues, then a row of zeros (X, GAP, PAD)
SLOT = 8  # floats a slot: tmm[k-1] tim[k-1] tdm[k-1] tmi[k] | tii[k]
# tmd[k] tdd[k] 0
# threads a pair by pack width: (widest mpad, threads), the first that
# holds the pack
THREADS = ((256, 32), (1024, 128), (MAX_MPAD, 512))

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
    "hmm_launch": [_P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I,
                   _P, _P],
    "hmm_max_mpad": [],
    "hmm_columns": [_I, _I],
    "hmm_num_regs": [_I, _I, _I],
    "hmm_smem_bytes": [_I, _I, _I],
    "hmm_warps_per_sm": [_I, _I, _I],
    "hmm_error_string": [_I],
}
RESTYPES = {"hmm_launch": _I, "hmm_max_mpad": _I, "hmm_columns": _I,
            "hmm_num_regs": _I, "hmm_smem_bytes": _I, "hmm_warps_per_sm": _I,
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


def threads_for(mpad: int) -> int:
    """Threads a pair for a pack of width mpad."""
    for widest, threads in THREADS:
        if mpad <= widest:
            return threads
    raise ValueError(f"need 1 <= Mpad <= {MAX_MPAD}, got {mpad}")


@dataclass
class WalkPack:
    """An mpad pack laid out for the kernel's walk with `threads` threads
    a pair: rec (H, slots, 8) and emit (H, 21, slots) float32, m_lens
    (H,) int32, slots = threads * ceil(mpad / threads)."""
    rec: torch.Tensor
    emit: torch.Tensor
    m_lens: torch.Tensor
    mpad: int
    threads: int

    @property
    def slots(self) -> int:
        return self.rec.shape[1]


def walk_columns(m_lens: torch.Tensor, mpad: int, threads: int):
    """(k, valid): the column (H, slots) int64 of every slot of every
    profile (0 where none), and whether it holds one.  Slot j threads + t
    holds column t ce + j, ce = ceil(min(m_len, mpad) / threads)."""
    slots = threads * (-(-mpad // threads))
    m = m_lens.to(torch.int64).clamp(0, mpad)[:, None]
    ce = (m + threads - 1) // threads
    slot = torch.arange(slots, device=m_lens.device)
    j, t = slot // threads, slot % threads
    k = t * ce + j
    valid = (j < ce) & (k < m)
    return torch.where(valid, k, 0), valid


def walk_pack(emit: torch.Tensor, trans, m_lens: torch.Tensor,
              threads: int | None = None) -> WalkPack:
    """The walk pack of an mpad pack (`ops/hmm.device_pack`: emit
    (H, 20, Mpad), the seven transitions (H, Mpad+1) in TRANSITIONS order,
    lengths (H,)), on the pack's device."""
    H, _, mpad = emit.shape
    threads = threads or threads_for(mpad)
    tmm, tmi, tmd, tim, tii, tdm, tdd = trans
    k, valid = walk_columns(m_lens, mpad, threads)
    here = valid
    prev = valid & (k > 0)  # the shifted terms are 0 at k = 0

    def at(x, idx, mask):
        return torch.where(mask, x.gather(1, idx), 0.0)

    km1 = (k - 1).clamp(min=0)
    rec = torch.stack([at(tmm, km1, prev), at(tim, km1, prev),
                       at(tdm, km1, prev), at(tmi, k, here),
                       at(tii, k, here), at(tmd, k, here), at(tdd, k, here),
                       torch.zeros_like(k, dtype=torch.float32)], dim=2)
    em = torch.where(valid[:, None, :], emit.gather(
        2, k[:, None, :].expand(H, N_AA, k.shape[1])), 0.0)
    em = torch.cat([em, em.new_zeros(H, 1, k.shape[1])], dim=1)
    return WalkPack(rec.contiguous(), em.contiguous(),
                    m_lens.to(torch.int32).contiguous(), mpad, threads)


def variant_facts(threads: int, mpad: int) -> dict:
    """Registers a thread (Forward), static shared memory a block and
    resident warps an SM of the kernel for `threads` a pair at mpad."""
    lib = library()
    return dict(threads=threads, columns=lib.hmm_columns(threads, mpad),
                registers=lib.hmm_num_regs(threads, mpad, 1),
                smem_bytes=lib.hmm_smem_bytes(threads, mpad, 1),
                warps_per_sm=lib.hmm_warps_per_sm(threads, mpad, 1))


def hmm_score(codes_all: torch.Tensor, lens_all: torch.Tensor,
              walk: WalkPack, seq_idx: torch.Tensor, hmm_idx: torch.Tensor,
              lpad: int, forward: bool) -> torch.Tensor:
    """The kernel: raw Forward (or Viterbi) bits of the pairs
    (seq_idx[b], hmm_idx[b]), codes_all (N, Lmax) int8, lens_all (N,)
    int32, the profiles' walk pack, the index vectors (B,) int32, all on
    one CUDA device; sequences are read to min(length, lpad).  Returns
    (B,) float32."""
    dev = codes_all.device
    named = [("codes_all", codes_all, torch.int8),
             ("lens_all", lens_all, torch.int32),
             ("walk.rec", walk.rec, torch.float32),
             ("walk.emit", walk.emit, torch.float32),
             ("walk.m_lens", walk.m_lens, torch.int32),
             ("seq_idx", seq_idx, torch.int32),
             ("hmm_idx", hmm_idx, torch.int32)]
    for name, x, dtype in named:
        if x.device != dev or x.device.type != "cuda":
            raise ValueError(f"{name} must be on {dev} (a CUDA device), got "
                             f"{x.device}")
        if x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if codes_all.dim() != 2:
        raise ValueError(f"codes_all must be (N, Lmax), got "
                         f"{tuple(codes_all.shape)}")
    N, lmax = codes_all.shape
    H, slots = walk.rec.shape[0], walk.slots
    if lens_all.shape != (N,) or walk.rec.shape != (H, slots, SLOT) \
            or walk.emit.shape != (H, EMIT_ROWS, slots) \
            or walk.m_lens.shape != (H,):
        raise ValueError("lens_all or the walk pack does not match the "
                         "packs' shapes")
    B = seq_idx.shape[0]
    if seq_idx.shape != (B,) or hmm_idx.shape != (B,):
        raise ValueError("seq_idx and hmm_idx must be (B,)")
    if not 1 <= walk.mpad <= MAX_MPAD or not 1 <= lpad <= lmax:
        raise ValueError(f"need 1 <= Mpad <= {MAX_MPAD} and 1 <= lpad <= "
                         f"Lmax, got Mpad {walk.mpad}, lpad {lpad}, Lmax "
                         f"{lmax}")
    out = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    LAUNCHES["hmm"] += 1
    with torch.cuda.device(dev):
        rc = lib.hmm_launch(
            codes_all.data_ptr(), lmax, lens_all.data_ptr(),
            walk.rec.data_ptr(), walk.emit.data_ptr(),
            walk.m_lens.data_ptr(), walk.mpad, slots, seq_idx.data_ptr(),
            hmm_idx.data_ptr(), B, int(lpad), walk.threads,
            int(bool(forward)), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"hmm launch failed: CUDA error {rc} "
                           f"({lib.hmm_error_string(rc).decode()})")
    return out
