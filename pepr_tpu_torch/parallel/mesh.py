"""Fan-out over several GPUs with `torch.distributed` (PyTorch port of
`pepr_tpu/parallel/mesh.py`).

The reference's concurrency over jackknife replicates and alignment
columns maps onto a 2-D mesh of ranks, one card a rank:

- axis "rep": replicates; each row of ranks fits its own share of a
  block's replicates (`sharded_replicate_blopt`);
- axis "site": alignment columns; the ranks of a row split the columns
  and sum over them (`sharded_loglik`, and the gradient of every Adam
  step), over the row's `site` group.

The JAX package gets its collectives from XLA's sharding annotations;
here they are explicit, and every one is an `all_reduce`, the one
collective that NCCL and Gloo (on CPU and on CUDA tensors) all have.
The rows' results are gathered over the `rep` group as an all_reduce of
zero buffers into which each row writes its own replicates, so every
rank returns the same arrays, as `process_allgather` does for JAX.  One
rank (no process group, or a world of 1) is `Mesh.single()`: no group
and no collective.

A run over several ranks: every rank runs the whole pipeline, and only
rank 0 writes files (`is_writer`; the others wait at `barrier`).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from pepr_tpu_torch.alphabet import PAD
from pepr_tpu_torch.device import rank_device, resolve_device
from pepr_tpu_torch.ops.likelihood import (WagModel, loglik_weighted,
                                           model_tensors)
from pepr_tpu_torch.parallel import replicates
from pepr_tpu_torch.parallel.replicates import replicate_codes, site_slice

# a collective that waits longer than this for a rank ends the run with
# an error instead of a hang
TIMEOUT_S = 1800.0

# the mesh's all_reduce calls and their bytes since the last reset
COLLECTIVES = {"all_reduce": 0, "bytes": 0}


def reset_collective_counts() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, device=None,
                           backend: str | None = None,
                           timeout: float = TIMEOUT_S) -> bool:
    """Join the process group of a run over several ranks.

    Reads PEPR_COORDINATOR / PEPR_NUM_PROCS / PEPR_PROC_ID when the
    arguments are not given, as the JAX function does; returns False
    when there is no coordinator (one process) and True once the group
    exists.  `host:port` is the TCP store of rank 0; `auto` takes the
    environment `torchrun` sets (env://).
    The backend is NCCL for a CUDA device and Gloo for the CPU unless
    named.  A rank's card is cuda:(LOCAL_RANK % device_count)
    (`device.rank_device`; LOCAL_RANK defaults to the rank, and
    LOCAL_WORLD_SIZE, the ranks on this node, to the world size).  On
    the card the node's local rank 0 builds the kernels while the other
    ranks wait at a barrier, then every rank loads them."""
    coordinator = coordinator or os.environ.get("PEPR_COORDINATOR")
    if coordinator is None:
        return False
    if coordinator == "auto":
        init, kw = "env://", {}
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        world = int(num_processes or os.environ["PEPR_NUM_PROCS"])
        rank = int(process_id if process_id is not None
                   else os.environ["PEPR_PROC_ID"])
        init, kw = f"tcp://{coordinator}", dict(world_size=world, rank=rank)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        rank_device(local_rank,
                    int(os.environ.get("LOCAL_WORLD_SIZE", world)), backend)
    dist.init_process_group(backend, init_method=init,
                            timeout=timedelta(seconds=timeout), **kw)
    if dev.type == "cuda":
        if local_rank == 0:
            from pepr_tpu_torch.ops import _cuda
            _cuda.build()
        barrier()
    return True


def shutdown_distributed() -> None:
    """Destroy the process group (if any) and forget its meshes."""
    _MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_writer() -> bool:
    """True on the rank that writes files: rank 0, or the one process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _control_all_reduce(t: torch.Tensor) -> torch.Tensor:
    # NCCL takes tensors on the rank's card only
    if dist.get_backend() == "nccl":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    dist.all_reduce(t)
    return t.cpu()


def barrier() -> None:
    """Wait until every rank gets here (nothing with one rank)."""
    if _world() > 1:
        _control_all_reduce(torch.zeros(1))


def rank0_value(x: float) -> float:
    """Rank 0's `x` on every rank (`x` itself with one rank): one answer
    to a question each rank would answer by its own clock."""
    if _world() == 1:
        return x
    t = torch.tensor([x if dist.get_rank() == 0 else 0.0],
                     dtype=torch.float64)
    return float(_control_all_reduce(t)[0])


@dataclass
class Mesh:
    """This rank's place in a (rep, site) grid of ranks: rank r is
    (r // S, r % S).  `site_group`: the S ranks of its row, which split
    the row's columns; `rep_group`: the R ranks that hold the same slice
    of columns in each row.  An axis of size 1 has no group."""
    shape: dict
    coords: dict
    site_group: object = None
    rep_group: object = None
    backend: str | None = None

    @classmethod
    def single(cls) -> "Mesh":
        return cls({"rep": 1, "site": 1}, {"rep": 0, "site": 0})

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum `t` in place over this rank's `axis` group."""
        if self.shape[axis] > 1:
            COLLECTIVES["all_reduce"] += 1
            COLLECTIVES["bytes"] += t.numel() * t.element_size()
            dist.all_reduce(t, group=self.site_group if axis == "site"
                            else self.rep_group)
        return t


def mesh_shape(world: int, local_world: int | None = None,
               axes: tuple[str, ...] = ("rep", "site")) -> dict:
    """{"rep": R, "site": S} with R * S == world.  One node (`local_world`
    ranks, default all): R as square as possible, the JAX
    single-process rule.  Several nodes: "rep" across nodes and "site"
    within one (the JAX multi-process layout, NVLink in the role of
    ICI), so the per-step sums never leave a node.  One axis: all
    ranks on it."""
    local_world = world if local_world is None else local_world
    if len(axes) == 1:
        shape = {"rep": 1, "site": 1}
        shape[axes[0]] = world
        return shape
    if local_world < world:
        if world % local_world:
            raise ValueError(f"world size {world} is not a multiple of "
                             f"the {local_world} ranks of a node")
        return {"rep": world // local_world, "site": local_world}
    r = math.isqrt(world)
    while world % r:
        r -= 1
    return {"rep": r, "site": world // r}


_MESHES: dict = {}


def default_mesh(axes: tuple[str, ...] = ("rep", "site")) -> Mesh:
    """The mesh over every rank of the process group (`mesh_shape`,
    LOCAL_WORLD_SIZE the ranks of a node); `Mesh.single()` without a
    group or in a world of 1.  Made once per group: every rank creates
    every group, in the same order."""
    if _world() == 1:
        return Mesh.single()
    world_pg = dist.group.WORLD
    key = tuple(axes)
    hit = _MESHES.get(key)
    if hit is not None and hit[0] is world_pg:
        return hit[1]
    W = dist.get_world_size()
    shape = mesh_shape(W, int(os.environ.get("LOCAL_WORLD_SIZE", W)), axes)
    R, S = shape["rep"], shape["site"]
    i, j = divmod(dist.get_rank(), S)
    mesh = Mesh(shape, {"rep": i, "site": j}, backend=dist.get_backend())
    if S > 1:
        for a in range(R):
            g = dist.new_group([a * S + b for b in range(S)])
            if a == i:
                mesh.site_group = g
    if R > 1:
        for b in range(S):
            g = dist.new_group([a * S + b for a in range(R)])
            if b == j:
                mesh.rep_group = g
    _MESHES[key] = (world_pg, mesh)
    return mesh


def shard_sites(mesh: Mesh, codes, weights, device=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's contiguous slice of the columns, on its device: codes
    (n_leaves, L / S) padded with PAD and weights padded with 0 to a
    multiple of the mesh's S, so padding never contributes."""
    dev = resolve_device(device)
    index, count = mesh.coords["site"], mesh.shape["site"]
    codes = np.asarray(codes, np.int8)
    weights = np.asarray(weights, np.float32)
    if count > 1:
        codes = site_slice(codes, 1, index, count, PAD)
        weights = site_slice(weights, weights.ndim - 1, index, count, 0.0)
    return (torch.as_tensor(np.ascontiguousarray(codes), device=dev),
            torch.as_tensor(np.ascontiguousarray(weights), device=dev))


def sharded_loglik(mesh: Mesh, codes, weights, children, blen,
                   model: WagModel, device=None) -> float:
    """Site-sharded total weighted log-likelihood of one tree: each rank
    computes its slice's with the forward kernel, summed over the
    `site` group (float64)."""
    dev = resolve_device(device)
    codes_t, w_t = shard_sites(mesh, codes, weights, dev)
    with torch.no_grad():
        total = loglik_weighted(
            codes_t, torch.as_tensor(np.asarray(children, np.int32),
                                     device=dev),
            torch.as_tensor(np.asarray(blen, np.float32), device=dev),
            *model_tensors(model, dev), w_t)
    return float(mesh.all_reduce(total.reshape(1), "site")[0])


def _pad_reps(a: np.ndarray, mult: int) -> np.ndarray:
    """Pad the replicate axis to a multiple of `mult` by repeating the
    last replicate (as `pepr_tpu/parallel/mesh.py:265-274` does)."""
    pad = (-a.shape[0]) % mult
    if pad:
        a = np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0)
    return a


def sharded_replicate_blopt(mesh: Mesh, codes, rep_weights: np.ndarray,
                            rep_children: np.ndarray, rep_blen: np.ndarray,
                            model: WagModel, steps: int = 60, device=None):
    """Jackknife fan-out: optimize the branch lengths of R replicates
    (each its own topology and site-weight mask), the replicates spread
    over the mesh's `rep` rows and the columns over each row's `site`
    ranks.  A row fits its replicates in blocks of `BLOCK_REPS`, each
    block on its compacted codes (`replicate_codes`) cut to this rank's
    slice; every Adam step sums the gradient over the `site` group
    before its update, and the final LLs are summed the same way.
    Every rank returns the same (blen (R, V) float32, ll (R,) float64),
    ll the weighted LL at the final branch lengths."""
    from pepr_tpu_torch.models.treebuild import (_inv_softplus, _softplus,
                                                 adam_blopt)
    dev = resolve_device(device)
    codes = np.asarray(codes, np.int8)
    R = rep_weights.shape[0]
    n_rep = mesh.shape["rep"]
    rw = _pad_reps(np.asarray(rep_weights, np.float32), n_rep)
    rc = _pad_reps(np.asarray(rep_children), n_rep)
    rb = _pad_reps(np.asarray(rep_blen), n_rep)
    per = rw.shape[0] // n_rep
    row0 = mesh.coords["rep"] * per
    margs = model_tensors(model, dev)
    site = (mesh.coords["site"], mesh.shape["site"])

    def sum_sites(t):
        return mesh.all_reduce(t, "site")

    blen = torch.zeros((rw.shape[0], rb.shape[1]), dtype=torch.float32,
                       device=dev)
    ll = torch.zeros(rw.shape[0], dtype=torch.float64, device=dev)
    block = replicates.BLOCK_REPS
    for r0 in range(row0, row0 + per, block):
        sl = slice(r0, min(r0 + block, row0 + per))
        codes_d, w_d = replicate_codes(codes, rw[sl], dev, site)
        ch = torch.as_tensor(np.asarray(rc[sl], np.int32), device=dev)
        theta0 = torch.as_tensor(
            _inv_softplus(np.asarray(rb[sl], np.float64))
            .astype(np.float32), device=dev)
        theta, _ = adam_blopt(codes_d, ch, theta0, margs, w_d, steps,
                              reduce_grad=sum_sites)
        b = _softplus(theta)
        with torch.no_grad():
            ll[sl] = sum_sites(loglik_weighted(codes_d, ch, b, *margs, w_d))
        blen[sl] = b
    mesh.all_reduce(blen, "rep")
    mesh.all_reduce(ll, "rep")
    return blen.cpu().numpy()[:R], ll.cpu().numpy()[:R]
