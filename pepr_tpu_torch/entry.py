"""The port's entry points in the role of `__graft_entry__.py`: a compile
check of the forward step and a dry run over several ranks.

`entry()` returns the weighted total log-likelihood of the WAG+Gamma
pruning model through the forward kernel, with its example arguments on
the device.  `dryrun_multi(n)` spawns n ranks (`run_ranks`) and runs
one sharded step on a (rep, site) mesh of them: the site-sharded
log-likelihood and a 3-step branch-length fit of jackknife replicates
over the `rep` rows.

    python -m pepr_tpu_torch.entry [--device cpu]
    python -m pepr_tpu_torch.entry --dryrun 4 [--device cpu] [--backend gloo]

The backend is NCCL on the card and Gloo on the CPU unless named; n
ranks on fewer cards need `--backend gloo`.
"""

from __future__ import annotations

import argparse
import os
import queue
import socket
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

from pepr_tpu_torch.device import resolve_device
from pepr_tpu_torch.ops.likelihood import (WagModel, loglik_weighted,
                                           model_tensors, tree_to_arrays)
from pepr_tpu_torch.parallel.mesh import (default_mesh,
                                          initialize_distributed,
                                          shutdown_distributed,
                                          sharded_loglik,
                                          sharded_replicate_blopt)
from pepr_tpu_torch.tree import parse_newick
from pepr_tpu_torch.utils.simulate import simulate_alignment

TINY_NEWICK = ("((((A:0.1,B:0.1):0.1,(C:0.1,D:0.1):0.1):0.1,"
               "(E:0.1,F:0.1):0.1):0.1,(G:0.1,H:0.1):0.1);")


def _tiny_problem(L: int = 256, seed: int = 0):
    """The 8-taxon problem of `__graft_entry__.py`: (codes, taxa,
    TreeArrays, WagModel)."""
    rng = np.random.default_rng(seed)
    tree = parse_newick(TINY_NEWICK)
    codes, taxa = simulate_alignment(tree, L, rng)
    return codes, taxa, tree_to_arrays(tree, taxa), WagModel.create()


def forward(codes, children, blen, weights, eig, u, u_inv, pi, rates):
    """Total weighted log-likelihood (float64) of one tree."""
    return loglik_weighted(codes, children, blen, eig, u, u_inv, pi, rates,
                           weights)


def entry(device=None):
    """(fn, example_args): the forward step and its arguments on the
    device (the card unless "cpu")."""
    dev = resolve_device(device)
    codes, _, arr, model = _tiny_problem()
    example_args = (
        torch.as_tensor(codes, device=dev),
        torch.as_tensor(arr.children, device=dev),
        torch.as_tensor(arr.blen, device=dev),
        torch.ones(codes.shape[1], device=dev),
        *model_tensors(model, dev))
    return forward, example_args


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, n, port, tasks, device, backend, threads, timeout,
               results):
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(n)
    try:
        fn, args = tasks.get()
        torch.set_num_threads(threads)
        initialize_distributed(f"127.0.0.1:{port}", n, rank, device=device,
                               backend=backend, timeout=timeout)
        out = fn(*args)
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, out))
    shutdown_distributed()


def run_ranks(n: int, fn, args=(), device=None, backend=None,
              timeout: float = 600.0, threads: int | None = None) -> list:
    """Run fn(*args) on n spawned ranks of one process group on this
    host (a free TCP port on 127.0.0.1; LOCAL_RANK = rank, so rank r
    takes card r % device_count) and return their results in rank
    order.  A rank that raises, dies or outlives `timeout` seconds (also
    the group's collective timeout) ends every rank and raises here.
    `fn` must be importable (a module-level function); each rank uses
    `threads` CPU threads (default: the cores shared out)."""
    ctx = mp.get_context("spawn")
    results, tasks = ctx.Queue(), ctx.Queue()
    # the work goes through a queue, not the processes' arguments: a
    # spawn start blocks until its child has read them, which it does
    # only after its imports, so large arguments would start the ranks
    # one after another
    for _ in range(n):
        tasks.put((fn, args))
    port = free_port()
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // n)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, port, tasks, device, backend,
                               threads, timeout, results))
             for r in range(n)]
    for p in procs:
        p.start()
    got: dict = {}
    t_end = time.time() + timeout
    try:
        while len(got) < n:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = {r: p.exitcode for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)}
                if dead:
                    raise RuntimeError(f"ranks died with exit codes {dead}")
                if time.time() > t_end:
                    raise TimeoutError(f"{n - len(got)} of {n} ranks did "
                                       f"not finish in {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{out}")
            got[rank] = out
    finally:
        for p in procs:
            if len(got) == n:
                p.join(timeout=60)
            if p.is_alive():
                p.kill()
            p.join()
        # work that a dead rank never took must not hold this process at
        # exit, waiting to flush it into the pipe
        tasks.cancel_join_thread()
        tasks.close()
        results.close()
    return [got[r] for r in range(n)]


def _dryrun_rank(device) -> dict:
    mesh = default_mesh()
    reps = max(mesh.shape["rep"] * 2, 4)
    codes, _, arr, model = _tiny_problem(L=64 * mesh.shape["site"])
    L = codes.shape[1]
    rng = np.random.default_rng(1)
    total = sharded_loglik(mesh, codes, np.ones(L, np.float32),
                           arr.children, arr.blen, model, device=device)
    rep_weights = (rng.random((reps, L)) < 0.5).astype(np.float32)
    rep_children = np.repeat(arr.children[None], reps, axis=0)
    rep_blen = np.repeat(arr.blen[None], reps, axis=0) * \
        rng.uniform(0.5, 1.5, size=(reps, 1)).astype(np.float32)
    blen, ll = sharded_replicate_blopt(mesh, codes, rep_weights,
                                       rep_children, rep_blen, model,
                                       steps=3, device=device)
    if not (np.isfinite(total) and np.isfinite(ll).all()
            and blen.shape == (reps, arr.blen.shape[0])):
        raise RuntimeError(f"dry run: total {total}, ll {ll}, blen "
                           f"{blen.shape}")
    return dict(mesh=dict(mesh.shape), coords=dict(mesh.coords),
                backend=mesh.backend, total=total, blen=blen, ll=ll)


def dryrun_multi(n: int, device=None, backend=None) -> list[dict]:
    """One full sharded step over n ranks that this function spawns:
    jackknife replicates over the mesh's `rep` rows, columns over its
    `site` ranks.  Every rank must return the same total and arrays;
    returns the ranks' results."""
    resolve_device(device)  # no card: raise here, before any rank starts
    outs = run_ranks(n, _dryrun_rank, (device,), device=device,
                     backend=backend)
    first = outs[0]
    for o in outs[1:]:
        if not (o["total"] == first["total"]
                and np.array_equal(o["ll"], first["ll"])
                and np.array_equal(o["blen"], first["blen"])):
            raise RuntimeError("dry run: the ranks returned different "
                               "results")
    print(f"dryrun_multi OK on {n} ranks ({first['backend']}): "
          f"mesh={first['mesh']} total={first['total']:.4f} "
          f"ll[0]={float(first['ll'][0]):.4f}", flush=True)
    return outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dryrun", type=int, default=0, metavar="N",
                    help="run one sharded step over N spawned ranks")
    ap.add_argument("--device", default=None, help="cpu (default: the card)")
    ap.add_argument("--backend", default=None, help="nccl or gloo")
    args = ap.parse_args(argv)
    if args.dryrun:
        dryrun_multi(args.dryrun, device=args.device, backend=args.backend)
        return 0
    fn, example_args = entry(args.device)
    with torch.no_grad():
        print(f"entry OK on {example_args[0].device}: total "
              f"{float(fn(*example_args)):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
