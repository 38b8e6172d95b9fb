"""Pruning forward and gradient kernels: build, binding, wrappers and
their plain PyTorch versions.

The CUDA source is `csrc/pruning.cu` (replacing the Pallas kernels
`pepr_tpu/ops/pallas_pruning.py::_kernel` and
`pepr_tpu/ops/pallas_pruning_grad.py::_bwd_kernel`).  `ops/_cuda.py`
compiles it at first use with `nvcc` for `sm_90a` into
`_build/libpepr_pruning.so`, a library with a plain C interface loaded
with `ctypes`.

Layouts, over a batch of B trees scored against one alignment:
  codes     (n_leaves, L) int8 shared by the batch, or (B, n_leaves, L)
  children  (B, n_int, 3) int32, postorder, -1 padding, root last
  pmats     (B, C, V, 20, 20) float32, rows = parent state, V = nodes
  pi        (20,) float32
  site LL   (B, L) float32
  gradient  (B, C, V, 20, 20) float32 of sum_s ct[b, s] * ll[b, s]

`site_ll` is the differentiable entry.  A tensor on the card goes
through the kernels (or the wrapper raises); a tensor on the CPU goes
through `site_ll_reference` / `site_ll_grad_reference`, which compute
the same functions (the same shared per-site rescaling every 2nd
internal node and at the root) with plain PyTorch operations.
"""

from __future__ import annotations

import ctypes
import math

import torch

from pepr_tpu_torch.ops import _cuda

N_AA = 20
RESCALE_EVERY = 2

SOURCE = _cuda.source_path("pruning")

# Gamma categories a block holds (MAXC in the source) and sites per
# tile (S_TILE).
MAX_CATS = 4
S_TILE = 64
# Largest tree the wrappers accept: node ids and scratch offsets stay
# well inside 32-bit launch arguments.
MAX_NODES = 8192
# Thread blocks aimed for per launch (132 SMs, several blocks each);
# each block owns a scratch slice, so this also bounds the scratch.
FWD_TARGET_BLOCKS = 1056
BWD_TARGET_BLOCKS = 528

# Launch counts, one per wrapper, bumped where the wrapper launches.
LAUNCHES = {"pruning_fwd": 0, "pruning_bwd": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- binding -----------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# Argument lists of the C launchers (checked against the source by the
# tests).
ARGTYPES = {
    "pruning_fwd_launch": [_P, _LL, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _P],
    "pruning_bwd_launch": [_P, _LL, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _I, _I, _I, _P],
    "pruning_fwd_scratch_floats": [_I, _I, _I],
    "pruning_bwd_scratch_floats": [_I, _I, _I],
    "pruning_site_tile": [],
    "pruning_max_cats": [],
    "pruning_error_string": [_I],
}
RESTYPES = {
    "pruning_fwd_launch": _I, "pruning_bwd_launch": _I,
    "pruning_fwd_scratch_floats": _LL, "pruning_bwd_scratch_floats": _LL,
    "pruning_site_tile": _I, "pruning_max_cats": _I,
    "pruning_error_string": ctypes.c_char_p,
}

_lib = None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = _cuda.load("pruning", ARGTYPES, RESTYPES)
        if (lib.pruning_site_tile(), lib.pruning_max_cats()) \
                != (S_TILE, MAX_CATS):
            raise RuntimeError("pruning library was built with another "
                               "S_TILE/MAXC than ops/pruning.py expects")
        _lib = lib
    return _lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.pruning_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _check_inputs(codes, children, pmats, pi):
    """Validate kernel inputs on the card; returns the sizes."""
    dev = pmats.device
    for name, t in (("codes", codes), ("children", children),
                    ("pmats", pmats), ("pi", pi)):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name} must be on {dev} (a CUDA device), "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if codes.dtype != torch.int8:
        raise ValueError(f"codes must be int8, got {codes.dtype}")
    if children.dtype != torch.int32 or children.dim() != 3 \
            or children.shape[2] != 3:
        raise ValueError("children must be int32 (B, n_int, 3)")
    if pmats.dtype != torch.float32 or pi.dtype != torch.float32:
        raise ValueError("pmats and pi must be float32")
    B, n_int = children.shape[:2]
    if codes.dim() == 2:
        n_leaves, L = codes.shape
        bstride = 0
    elif codes.dim() == 3 and codes.shape[0] == B:
        n_leaves, L = codes.shape[1:]
        bstride = n_leaves * L
    else:
        raise ValueError("codes must be (n_leaves, L) or (B, n_leaves, L)")
    V = n_leaves + n_int
    C = pmats.shape[1] if pmats.dim() == 5 else -1
    if pmats.shape != (B, C, V, N_AA, N_AA) or not 1 <= C <= MAX_CATS:
        raise ValueError(f"pmats must be (B={B}, C<={MAX_CATS}, V={V}, 20, 20), "
                         f"got {tuple(pmats.shape)}")
    if pi.shape != (N_AA,):
        raise ValueError("pi must be (20,)")
    if V > MAX_NODES:
        raise ValueError(f"tree of {V} nodes exceeds the kernels' limit of "
                         f"{MAX_NODES} nodes")
    if B < 1 or n_int < 1 or L < 1 or B > 65535:
        raise ValueError(f"empty or oversized batch (B={B}, n_int={n_int}, "
                         f"L={L}; B <= 65535)")
    return B, n_leaves, n_int, L, C, bstride


def _n_chunks(target: int, B: int, L: int) -> int:
    n_tiles = -(-L // S_TILE)
    return max(1, min(n_tiles, -(-target // B)))


def pruning_fwd(codes, children, pmats, pi) -> torch.Tensor:
    """Kernel 1: per-site log-likelihood (B, L) on the card."""
    B, n_leaves, n_int, L, C, bstride = _check_inputs(codes, children,
                                                      pmats, pi)
    lib = library()
    n_chunks = _n_chunks(FWD_TARGET_BLOCKS, B, L)
    out = torch.empty((B, L), dtype=torch.float32, device=pmats.device)
    scratch = torch.empty(
        lib.pruning_fwd_scratch_floats(n_int, C, n_chunks * B),
        dtype=torch.float32, device=pmats.device)
    stream = torch.cuda.current_stream(pmats.device).cuda_stream
    LAUNCHES["pruning_fwd"] += 1
    rc = lib.pruning_fwd_launch(
        codes.data_ptr(), bstride, children.data_ptr(), pmats.data_ptr(),
        pi.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, n_leaves,
        n_int, L, C, n_chunks, stream)
    _check(lib, rc, "pruning_fwd")
    return out


def pruning_bwd(codes, children, pmats, pi, ct) -> torch.Tensor:
    """Kernel 2: d(sum_s ct[b, s] ll[b, s])/d pmats, (B, C, V, 20, 20)."""
    B, n_leaves, n_int, L, C, bstride = _check_inputs(codes, children,
                                                      pmats, pi)
    if ct.shape != (B, L) or ct.dtype != torch.float32 \
            or ct.device != pmats.device or not ct.is_contiguous():
        raise ValueError(f"ct must be contiguous float32 ({B}, {L}) on "
                         f"{pmats.device}")
    lib = library()
    V = n_leaves + n_int
    n_chunks = _n_chunks(BWD_TARGET_BLOCKS, B, L)
    grad = torch.empty((B, C, V, N_AA, N_AA), dtype=torch.float32,
                       device=pmats.device)
    gslot = torch.empty(B * n_chunks * C * V * N_AA * N_AA,
                        dtype=torch.float32, device=pmats.device)
    scratch = torch.empty(
        lib.pruning_bwd_scratch_floats(n_int, C, n_chunks * B),
        dtype=torch.float32, device=pmats.device)
    stream = torch.cuda.current_stream(pmats.device).cuda_stream
    LAUNCHES["pruning_bwd"] += 1
    rc = lib.pruning_bwd_launch(
        codes.data_ptr(), bstride, children.data_ptr(), pmats.data_ptr(),
        pi.data_ptr(), ct.data_ptr(), gslot.data_ptr(), grad.data_ptr(),
        scratch.data_ptr(), B, n_leaves, n_int, L, C, n_chunks, stream)
    _check(lib, rc, "pruning_bwd")
    return grad


# -- plain versions ----------------------------------------------------------

def tip_partials(codes: torch.Tensor, pi: torch.Tensor) -> torch.Tensor:
    """(..., L) codes -> (..., L, 20): one-hot, and ones over the live
    states (pi > 1e-6) for ambiguous codes (>= 20)."""
    c = codes.long()
    amb = (c >= N_AA) | (c < 0)
    onehot = torch.nn.functional.one_hot(c.clamp(0, N_AA - 1), N_AA)
    live = (pi > 1e-6).to(torch.float32)
    return torch.where(amb[..., None], live, onehot.to(torch.float32))


def site_ll_reference(codes, children, pmats, pi) -> torch.Tensor:
    """Plain PyTorch per-site log-likelihood (B, L), differentiable in
    `pmats` by ordinary autograd."""
    B = children.shape[0]
    n_int = children.shape[1]
    n_leaves = codes.shape[-2]
    C = pmats.shape[1]
    out = []
    for b in range(B):
        tips = tip_partials(codes if codes.dim() == 2 else codes[b], pi)
        parts: dict[int, torch.Tensor] = {}
        logscale = torch.zeros(tips.shape[1], dtype=torch.float32,
                               device=pmats.device)
        for i, row in enumerate(children[b].tolist()):
            prod = None
            for v in row:
                if v < 0:
                    continue
                p = pmats[b, :, v]  # (C, 20, 20)
                if v < n_leaves:
                    term = torch.einsum("cab,lb->cla", p, tips[v])
                else:
                    term = torch.einsum("cab,clb->cla", p, parts[v])
                prod = term if prod is None else prod * term
            if i % RESCALE_EVERY == RESCALE_EVERY - 1 or i == n_int - 1:
                m = prod.amax(dim=(0, 2)).clamp_min(1e-30)  # (L,)
                logscale = logscale + torch.log(m)
                prod = prod / m[None, :, None]
            parts[n_leaves + i] = prod
        root = parts[n_leaves + n_int - 1]
        site_cat = torch.log(torch.einsum("a,cla->cl", pi, root)
                             .clamp_min(1e-30)) + logscale
        out.append(torch.logsumexp(site_cat, dim=0) - math.log(C))
    return torch.stack(out)


def site_ll_grad_reference(codes, children, pmats, pi, ct) -> torch.Tensor:
    """Plain PyTorch d(sum_s ct[b, s] ll[b, s])/d pmats, by autograd
    through `site_ll_reference`."""
    with torch.enable_grad():
        p = pmats.detach().requires_grad_(True)
        ll = site_ll_reference(codes, children, p, pi)
        (g,) = torch.autograd.grad((ll * ct).sum(), p)
    return g


class SiteLL(torch.autograd.Function):
    """Per-site log-likelihood with the gradient kernel as its backward
    (the custom VJP `site_ll_pallas_diff` of the JAX package)."""

    @staticmethod
    def forward(ctx, codes, children, pmats, pi):
        ctx.save_for_backward(codes, children, pmats, pi)
        if pmats.is_cuda:
            return pruning_fwd(codes, children, pmats, pi)
        return site_ll_reference(codes, children, pmats, pi)

    @staticmethod
    def backward(ctx, grad_out):
        codes, children, pmats, pi = ctx.saved_tensors
        ct = grad_out.contiguous()
        if pmats.is_cuda:
            gp = pruning_bwd(codes, children, pmats, pi, ct)
        else:
            gp = site_ll_grad_reference(codes, children, pmats, pi, ct)
        return None, None, gp, None


def site_ll(codes, children, pmats, pi) -> torch.Tensor:
    """Per-site log-likelihood (B, L), differentiable in `pmats`."""
    return SiteLL.apply(codes, children, pmats, pi)
