"""Pruning forward and gradient kernels: build, binding, the host-side
slot plan, wrappers and their plain PyTorch versions.

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

Before each launch the wrapper plans where node partials live
(`plan_slots`): a shared-memory slot per internal node by liveness over
the postorder, the nodes beyond what shared memory holds in a global
spill tier, and for the gradient the same for the upper messages over
the reverse order.  The plan is sized for one block per SM.  Plans are
kept for the last few `children` tensors (held,
so that their memory is not reused), so a loop over one tree plans
once.

`site_ll` is the differentiable entry.  A tensor on the card goes
through the kernels (or the wrapper raises); a tensor on the CPU goes
through `site_ll_reference` / `site_ll_grad_reference`, which compute
the same functions (the same shared per-site rescaling every 2nd
internal node and at the root) with plain PyTorch operations.
"""

from __future__ import annotations

import ctypes
import math
import time
from collections import OrderedDict

import numpy as np
import torch

from pepr_tpu_torch.ops import _cuda

N_AA = 20
RESCALE_EVERY = 2
# sites a tile of the plain gradient (site_ll_grad_reference)
GRAD_TILE = 8192

SOURCE = _cuda.source_path("pruning")

# Gamma categories a block holds (MAXC in the source, one warp each),
# lanes of a warp (WARP) and ints per node of the plan (PLAN_W).
MAX_CATS = 4
WARP = 32
PLAN_W = 12
# Largest tree the wrappers accept: node ids and scratch offsets stay
# well inside 32-bit launch arguments.
MAX_NODES = 8192
# Shared memory one block may take on an H100.
SMEM_PER_BLOCK = 232448
# Most slots a plan uses (bits of an int64 mask).
MAX_SLOTS = 62
# Scratch a launch may take (spill records; for the gradient also every
# node's kept partials and the gradient slots): fewer blocks per tree,
# and for the gradient groups of trees, keep within it.
SCRATCH_BYTES = 4 << 30
# The variant the source builds (SITES_PER_LANE, WARPS_PER_CAT): each
# lane holds 2 sites, 2 warps hold each category, so a tile has 128
# sites.
SITES_PER_LANE = 2
WARPS_PER_CAT = 2
SITE_TILE = WARP * WARPS_PER_CAT * SITES_PER_LANE
PLAN_CACHE = 16

# Launch counts, one per wrapper, bumped where the wrapper launches.
LAUNCHES = {"pruning_fwd": 0, "pruning_bwd": 0}
# Plans made (plan-cache misses), host seconds spent copying `children`
# to the host (which waits for the work queued before it) and planning
# (to the plan on the card); reset with the launch counts.
PLANNING = {"plans": 0, "copy_seconds": 0.0, "plan_seconds": 0.0}
# The last launch of each kernel: its plan (on the card) and grid, and
# the spill-tier accesses the kernel counted in one tile of each tree
# (`kernel_spills`, (B, 4) int32 on the card: forward-partial writes and
# reads, upper-message writes and reads).
LAST: dict[str, dict] = {}


def reset_launch_counts() -> None:
    """Zero the launch counts and the planning tally."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    PLANNING.update(plans=0, copy_seconds=0.0, plan_seconds=0.0)


# Floats of one node record, partials (MAXC, 20, tile) and per-category
# maxima (MAXC, tile), and of one upper-message record (MAXC, 20, tile).
REC_FLOATS = MAX_CATS * (N_AA + 1) * SITE_TILE
UREC_FLOATS = MAX_CATS * N_AA * SITE_TILE


# -- the slot plan (host) ----------------------------------------------------

def _forward_slots(rows: list, n_leaves: int, cap: int) -> tuple:
    """Forward slot codes of one tree's internal nodes (`rows`: its
    children rows), the most slots live at once and the spill records
    used."""
    n_int = len(rows)
    full = (1 << min(cap, MAX_SLOTS)) - 1
    fs = [0] * n_int
    used = live = peak = spilled = 0
    for i in range(n_int - 1):
        free = ~used & full
        if free:
            low = free & -free
            used |= low
            fs[i] = low.bit_length() - 1
            live += 1
            if live > peak:
                peak = live
        else:
            spilled += 1
            fs[i] = -spilled
        for v in rows[i]:
            if v >= n_leaves and fs[v - n_leaves] >= 0:
                used &= ~(1 << fs[v - n_leaves])
                live -= 1
    return fs, peak, spilled


def _upper_slots(rows: list, n_leaves: int, cap: int) -> tuple:
    """Upper-message slot codes over the reverse order: a node's internal
    children are placed when it is processed, and its own slot frees
    after them.  Returns as `_forward_slots`."""
    n_int = len(rows)
    full = (1 << min(cap, MAX_SLOTS)) - 1
    us = [0] * n_int
    used = live = peak = spilled = 0
    for i in range(n_int - 1, -1, -1):
        for v in rows[i]:
            if v < n_leaves:
                continue
            free = ~used & full
            if free:
                low = free & -free
                used |= low
                us[v - n_leaves] = low.bit_length() - 1
                live += 1
                if live > peak:
                    peak = live
            else:
                spilled += 1
                us[v - n_leaves] = -spilled
        if i != n_int - 1 and us[i] >= 0:
            used &= ~(1 << us[i])
            live -= 1
    return us, peak, spilled


def plan_slots(children: np.ndarray, n_leaves: int, cap_f,
               cap_u: int | None = None) -> tuple[np.ndarray, dict]:
    """The kernels' plan (B, n_int, PLAN_W) int32 and its numbers,
    planned tree by tree.

    Forward slots: node i takes the lowest free shared-memory slot below
    `cap_f` (the root takes none), else the next spill record of its
    tree; its internal children's slots free once i is placed, so a slot
    is never reused while it is live and never by the node that reads
    it.  With `cap_u` (the gradient), upper messages get slots the same
    way over the reverse order; `cap_f` may then be a function of the
    upper slots the batch uses (the gradient's forward slots take the
    shared memory the upper messages leave).
    Slot codes: s >= 0 a shared slot, s < 0 spill record -s - 1.
    Numbers: slots used at most (`slots_f`, `slots_u`), spilled nodes
    per tree at most (`spill_f`, `spill_u`) and in all (`spilled_f`,
    `spilled_u`)."""
    ch = np.asarray(children, np.int64)
    if ch.ndim == 2:
        ch = ch[None]
    B, n_int, _ = ch.shape
    trees = ch.tolist()
    upper = [_upper_slots(rows, n_leaves, cap_u) if cap_u is not None
             else ([0] * n_int, 0, 0) for rows in trees]
    if callable(cap_f):
        cap_f = cap_f(max(u[1] for u in upper))
    forward = [_forward_slots(rows, n_leaves, cap_f) for rows in trees]
    fs = np.array([f[0] for f in forward], np.int64)
    us = np.array([u[0] for u in upper], np.int64)
    nums_f = np.array([f[1:] for f in forward], np.int64)
    nums_u = np.array([u[1:] for u in upper], np.int64)

    plan = np.zeros((B, n_int, PLAN_W), np.int32)
    plan[:, :, 0:3] = ch
    plan[:, :, 3] = fs
    plan[:, :, 7] = us
    kid_int = ch >= n_leaves
    kid_node = np.where(kid_int, ch - n_leaves, 0)
    for k in range(3):
        m = kid_int[:, :, k]
        plan[:, :, 4 + k] = np.where(m, np.take_along_axis(
            fs, kid_node[:, :, k], axis=1), 0)
        plan[:, :, 8 + k] = np.where(m, np.take_along_axis(
            us, kid_node[:, :, k], axis=1), 0)
    stats = dict(slots_f=int(nums_f[:, 0].max()),
                 slots_u=int(nums_u[:, 0].max()),
                 spill_f=int(nums_f[:, 1].max()),
                 spill_u=int(nums_u[:, 1].max()),
                 spilled_f=int(nums_f[:, 1].sum()),
                 spilled_u=int(nums_u[:, 1].sum()))
    return plan, stats


# -- binding -----------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# Argument lists of the C launchers (checked against the source by the
# tests).
ARGTYPES = {
    "pruning_fwd_launch": [_P, _LL, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _I, _I, _I, _I, _I, _P],
    "pruning_bwd_launch": [_P, _LL, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "pruning_smem_bytes": [_I, _I, _I],
    "pruning_occupancy": [_I, _LL],
    "pruning_num_regs": [_I],
    "pruning_warp_sites": [],
    "pruning_site_tile": [],
    "pruning_max_cats": [],
    "pruning_plan_width": [],
    "pruning_error_string": [_I],
}
RESTYPES = {
    "pruning_fwd_launch": _I, "pruning_bwd_launch": _I,
    "pruning_smem_bytes": _LL, "pruning_occupancy": _I,
    "pruning_num_regs": _I, "pruning_warp_sites": _I,
    "pruning_site_tile": _I,
    "pruning_max_cats": _I, "pruning_plan_width": _I,
    "pruning_error_string": ctypes.c_char_p,
}

_lib = None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = _cuda.load("pruning", ARGTYPES, RESTYPES)
        if (lib.pruning_warp_sites(), lib.pruning_max_cats(),
                lib.pruning_plan_width(), lib.pruning_site_tile()) \
                != (WARP, MAX_CATS, PLAN_W, SITE_TILE):
            raise RuntimeError("pruning library was built with another "
                               "WARP/MAXC/PLAN_W/tile than ops/pruning.py "
                               "expects")
        if lib.pruning_smem_bytes(1, 1, 1) - lib.pruning_smem_bytes(1, 0, 0) \
                != 4 * (REC_FLOATS + UREC_FLOATS):
            raise RuntimeError("pruning library's record sizes differ from "
                               "ops/pruning.py's")
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


_PLANS: OrderedDict = OrderedDict()
_OCCUPANCY: dict = {}


def _planned(children, n_leaves: int, kind: int) -> tuple:
    """(plan on the card, plan numbers, shared-memory bytes) of a launch.
    The gradient gives shared memory first to the upper messages (a
    spilled one is a write and a read), then to the recompute's partials
    (a spilled one is read from its kept record)."""
    key = (kind, children.data_ptr(), children._version,
           tuple(children.shape), tuple(children.stride()), children.device)
    hit = _PLANS.get(key)
    if hit is not None:
        _PLANS.move_to_end(key)
        return hit[1:]
    lib = library()
    t0 = time.perf_counter()
    ch = children.cpu().numpy()
    t1 = time.perf_counter()
    budget = SMEM_PER_BLOCK - lib.pruning_smem_bytes(kind, 0, 0)
    rec, urec = 4 * REC_FLOATS, 4 * UREC_FLOATS
    if kind == 0:
        plan, st = plan_slots(ch, n_leaves, max(0, budget // rec))
    else:
        plan, st = plan_slots(
            ch, n_leaves, lambda slots_u: max(0, (budget - slots_u * urec)
                                                // rec),
            max(0, budget // urec))
    smem = lib.pruning_smem_bytes(kind, st["slots_f"], st["slots_u"])
    out = (torch.as_tensor(plan, device=children.device), st, smem)
    _PLANS[key] = (children,) + out
    if len(_PLANS) > PLAN_CACHE:
        _PLANS.popitem(last=False)
    PLANNING["plans"] += 1
    PLANNING["copy_seconds"] += t1 - t0
    PLANNING["plan_seconds"] += time.perf_counter() - t1
    return out


def blocks_per_tree(B: int, n_tiles: int, resident: int) -> int:
    """Blocks per tree: of the counts that keep a launch within two
    waves of `resident` blocks (or one block per tree), the one whose
    launch takes the fewest block rounds, each as long as the most tiles
    a block walks (waves times ceil(n_tiles / n)); ties go to fewer
    blocks."""
    best, best_t = 1, None
    for n in range(1, min(n_tiles, -(-2 * resident // B)) + 1):
        t = -(-B * n // resident) * -(-n_tiles // n)
        if best_t is None or t < best_t:
            best, best_t = n, t
    return best


def _grid(kind: int, smem: int, B: int, L: int, dev) -> tuple:
    """(blocks per tree, resident blocks per SM) of a launch."""
    key = (kind, smem, dev)
    if key not in _OCCUPANCY:
        lib = library()
        per_sm = lib.pruning_occupancy(kind, smem)
        if per_sm < 0:
            _check(lib, -per_sm, "pruning occupancy")
        if per_sm == 0:
            raise RuntimeError(f"pruning kernel {kind} cannot reside with "
                               f"{smem} bytes of shared memory")
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        _OCCUPANCY[key] = (per_sm, n_sm)
    per_sm, n_sm = _OCCUPANCY[key]
    n_tiles = -(-L // SITE_TILE)
    return blocks_per_tree(B, n_tiles, n_sm * per_sm), per_sm


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def pruning_fwd(codes, children, pmats, pi) -> torch.Tensor:
    """Kernel 1: per-site log-likelihood (B, L) on the card."""
    B, n_leaves, n_int, L, C, bstride = _check_inputs(codes, children,
                                                      pmats, pi)
    lib = library()
    dev = pmats.device
    plan_d, st, smem = _planned(children, n_leaves, 0)
    n_chunks, per_sm = _grid(0, smem, B, L, dev)
    per_block = 4 * st["spill_f"] * REC_FLOATS
    if per_block:
        n_chunks = min(n_chunks, max(1, SCRATCH_BYTES // (B * per_block)))
    out = torch.empty((B, L), dtype=torch.float32, device=dev)
    amb = torch.empty((B, C, n_leaves, N_AA), dtype=torch.float32, device=dev)
    spill = torch.empty(max(1, B * n_chunks * st["spill_f"] * REC_FLOATS),
                        dtype=torch.float32, device=dev)
    spills = torch.empty((B, 4), dtype=torch.int32, device=dev)
    LAUNCHES["pruning_fwd"] += 1
    rc = lib.pruning_fwd_launch(
        codes.data_ptr(), bstride, plan_d.data_ptr(), pmats.data_ptr(),
        amb.data_ptr(), pi.data_ptr(), out.data_ptr(), spill.data_ptr(),
        spills.data_ptr(), B, n_leaves, n_int, L, C, n_chunks,
        st["slots_f"], st["spill_f"], _stream(dev))
    _check(lib, rc, "pruning_fwd")
    LAST["pruning_fwd"] = dict(plan=plan_d, smem_bytes=smem,
                               blocks_per_sm=per_sm, n_chunks=n_chunks,
                               kernel_spills=spills, **st)
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
    W = WARPS_PER_CAT
    dev = pmats.device
    V = n_leaves + n_int
    plan_d, st, smem = _planned(children, n_leaves, 1)
    n_chunks, per_sm = _grid(1, smem, B, L, dev)
    per_block = 4 * (n_int * REC_FLOATS + st["spill_u"] * UREC_FLOATS
                     + W * C * V * N_AA * N_AA)
    n_chunks = min(n_chunks, max(1, SCRATCH_BYTES // per_block))
    group = max(1, min(B, SCRATCH_BYTES // (n_chunks * per_block)))
    grad = torch.empty((B, C, V, N_AA, N_AA), dtype=torch.float32,
                       device=dev)
    gslot = torch.empty(group * n_chunks * W * C * V * N_AA * N_AA,
                        dtype=torch.float32, device=dev)
    keep = torch.empty(group * n_chunks * n_int * REC_FLOATS,
                       dtype=torch.float32, device=dev)
    uspill = torch.empty(max(1, group * n_chunks * st["spill_u"]
                             * UREC_FLOATS), dtype=torch.float32, device=dev)
    amb = torch.empty((group, C, n_leaves, N_AA), dtype=torch.float32,
                      device=dev)
    spills = torch.empty((B, 4), dtype=torch.int32, device=dev)
    for b0 in range(0, B, group):
        nb = min(group, B - b0)
        cd = codes if bstride == 0 else codes[b0:b0 + nb]
        LAUNCHES["pruning_bwd"] += 1
        rc = lib.pruning_bwd_launch(
            cd.data_ptr(), bstride, plan_d[b0:b0 + nb].data_ptr(),
            pmats[b0:b0 + nb].data_ptr(), amb.data_ptr(), pi.data_ptr(),
            ct[b0:b0 + nb].data_ptr(), gslot.data_ptr(),
            grad[b0:b0 + nb].data_ptr(), keep.data_ptr(), uspill.data_ptr(),
            spills[b0:b0 + nb].data_ptr(), nb, n_leaves, n_int, L, C,
            n_chunks, st["slots_f"], st["slots_u"], st["spill_u"],
            _stream(dev))
        _check(lib, rc, "pruning_bwd")
    LAST["pruning_bwd"] = dict(plan=plan_d, smem_bytes=smem,
                               blocks_per_sm=per_sm, n_chunks=n_chunks,
                               trees_per_launch=group,
                               kernel_spills=spills, **st)
    return grad


# -- plain versions ----------------------------------------------------------

def tip_partials(codes: torch.Tensor, pi: torch.Tensor) -> torch.Tensor:
    """(..., L) codes -> (..., L, 20) in pi's type: one-hot, and ones
    over the live states (pi > 1e-6) for ambiguous codes (>= 20)."""
    c = codes.long()
    amb = (c >= N_AA) | (c < 0)
    onehot = torch.nn.functional.one_hot(c.clamp(0, N_AA - 1), N_AA)
    live = (pi > 1e-6).to(pi.dtype)
    return torch.where(amb[..., None], live, onehot.to(pi.dtype))


def site_ll_reference(codes, children, pmats, pi) -> torch.Tensor:
    """Plain PyTorch per-site log-likelihood (B, L), differentiable in
    `pmats` by ordinary autograd; in float32, or in float64 where
    `pmats` and `pi` are float64."""
    B = children.shape[0]
    n_int = children.shape[1]
    n_leaves = codes.shape[-2]
    C = pmats.shape[1]
    out = []
    for b in range(B):
        tips = tip_partials(codes if codes.dim() == 2 else codes[b], pi)
        # one view per edge: their gradients are stacked once, where an
        # index per edge would add a zeroed copy of all of `pmats` each
        edges = pmats[b].unbind(1)
        parts: dict[int, torch.Tensor] = {}
        logscale = torch.zeros(tips.shape[1], dtype=pmats.dtype,
                               device=pmats.device)
        for i, row in enumerate(children[b].tolist()):
            prod = None
            for v in row:
                if v < 0:
                    continue
                p = edges[v]  # (C, 20, 20)
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
    through `site_ll_reference` on tiles of GRAD_TILE sites, the tiles'
    gradients summed pairwise.  One float32 sum over all the sites
    drifts from the float64 gradient as their count grows, far more than
    the kernel's per-warp slots do (PERF.md, F4); the tiles keep it near
    the kernel's.  Up to GRAD_TILE sites it is one autograd pass."""
    L = codes.shape[-1]
    parts = []
    with torch.enable_grad():
        for s0 in range(0, L, GRAD_TILE):
            p = pmats.detach().requires_grad_(True)
            ll = site_ll_reference(codes[..., s0:s0 + GRAD_TILE], children,
                                   p, pi)
            (g,) = torch.autograd.grad(
                (ll * ct[:, s0:s0 + GRAD_TILE]).sum(), p)
            parts.append(g)
    while len(parts) > 1:
        parts = [sum(parts[i:i + 2]) for i in range(0, len(parts), 2)]
    return parts[0]


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
