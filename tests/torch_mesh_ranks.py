"""Rank functions for tests/test_torch_mesh.py.  Each runs on ranks that
`pepr_tpu_torch.entry.run_ranks` spawns, which import this module by
name: it imports no JAX, so a rank starts with torch and the port
alone."""

import contextlib
import io

import torch.distributed as dist

from pepr_tpu_torch.models.support import support_trees
from pepr_tpu_torch.parallel import mesh as pm
from pepr_tpu_torch.pipeline.checkpoint import CheckpointStore, Deadline
from pepr_tpu_torch.tree import to_newick


def mesh_work(codes, weights, full, model, fits=(), cat=None,
              support_kw=None, store_dir=None) -> dict:
    """On each rank: the mesh; sharded_loglik of the tree `full`
    (children, blen); sharded_replicate_blopt of each (weights,
    children, blen, steps) of `fits`; support_trees on `cat`; a store
    that every rank saves its rank into; deadlines of 1e6 s on rank 0
    and 0 s elsewhere, asked on every rank."""
    rank = dist.get_rank()
    mesh = pm.default_mesh()
    out = dict(rank=rank, world=dist.get_world_size(),
               shape=dict(mesh.shape), coords=dict(mesh.coords),
               total=pm.sharded_loglik(mesh, codes, weights, *full, model,
                                       device="cpu"))
    out["fits"] = [pm.sharded_replicate_blopt(mesh, codes, w, ch, bl, model,
                                              steps=steps, device="cpu")
                   for w, ch, bl, steps in fits]
    if cat is not None:
        out["support"] = [to_newick(t) for t in support_trees(
            cat, device="cpu", **support_kw)]
    if store_dir is not None:
        store = CheckpointStore(store_dir, fingerprint="mesh-test")
        store.save("who", rank)
        pm.barrier()
        out["stored"] = store.load("who")
    deadline = Deadline(1e6 if rank == 0 else 0.0)
    out["deadline"] = (deadline.expired, deadline.near(10.0),
                       deadline.remaining() > 1e5)
    return out


def fail_on_rank_one() -> None:
    """Rank 1 raises; rank 0 waits in a collective for it."""
    if dist.get_rank() == 1:
        raise ValueError("planted failure on rank 1")
    pm.barrier()


def cli_run(argv: list[str]) -> tuple[str, list[int], list[str]]:
    """The CLI's main in a rank of an existing group: (its stdout, the
    ranks that wrote the output files, the store keys this rank
    saved)."""
    import pepr_tpu_torch.pipeline.checkpoint as ck
    import pepr_tpu_torch.pipeline.pepr as pp
    from pepr_tpu_torch.pipeline import cli
    wrote, saved = [], []
    write_outputs, save = pp.write_outputs, ck.CheckpointStore.save

    def counted_write(*a, **kw):
        wrote.append(dist.get_rank())
        return write_outputs(*a, **kw)

    def counted_save(self, key, obj):
        if self.writer:
            saved.append(key)
        save(self, key, obj)

    pp.write_outputs = counted_write
    ck.CheckpointStore.save = counted_save
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc}")
    return buf.getvalue(), wrote, saved
