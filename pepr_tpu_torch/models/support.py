"""Gene-wise jackknife branch supports (PyTorch port of
`pepr_tpu/models/support.py`).

Each of `reps` support trees is built from a random half of the gene
families (PhylogenomicPipeline2.java:994-1126).  A replicate is a 0/1
site-weight vector over the same concatenated alignment, so all
replicates share the device data; their branch lengths are optimized
together over the ranks of the mesh (`sharded_replicate_blopt` on
`default_mesh()`: replicates over its `rep` rows, columns over its
`site` ranks; one rank without a process group), and every NNI round
scores each replicate's whole neighborhood in batched kernel calls, on
every rank, as in the JAX package.  The masks come from seeded numpy
generators, identical to the JAX package's.  `resample="bootstrap_sites"`
draws multinomial column counts instead of gene halves (the classic
bootstrap as a reweighting), and `method="nj"` builds each replicate's
plain NJ tree on the serial path, as the JAX package does.

With a checkpoint store the finished replicates are saved one by one
(`support_{r:04d}`, Newick), and the batched path saves its phases:
the starting trees (`support_starts`), the first branch-length fits in
blocks of `BLOCK_REPS` replicates (`support_blopt_blocks`, keyed by a
block's first replicate), the state after each NNI round
(`support_batch_state`), a round's candidate scores by replicate
(`support_nni_scores_{rnd}`) and its refits in blocks of `BLOCK_REPS`
of the moved replicates (`support_moved_blopt_{rnd}`).  A replicate's
fit depends on the replicates that share its block (the block's codes
are compacted to the union of their live columns), so the blocks are a
function of (reps, moved) alone, never of the world size (a store
written at 4 ranks resumes at 1 and the other way round), and a block
is saved only whole.
"""

from __future__ import annotations

import logging
import time

import numpy as np

from pepr_tpu_torch.device import resolve_device
from pepr_tpu_torch.models.concat import ConcatenatedAlignment
from pepr_tpu_torch.models.treebuild import (_nni_candidate, _nni_moves,
                                             _score_topologies, ml_tree,
                                             nj_start_tree, nj_tree)
from pepr_tpu_torch.ops.likelihood import (TreeArrays, WagModel,
                                           arrays_to_tree, model_tensors,
                                           tree_to_arrays)
from pepr_tpu_torch.parallel import replicates
from pepr_tpu_torch.parallel.mesh import (default_mesh, rank0_value,
                                          sharded_replicate_blopt)
from pepr_tpu_torch.parallel.replicates import replicate_codes
from pepr_tpu_torch.pipeline.checkpoint import Incomplete, check_deadline
from pepr_tpu_torch.tree import decorate_supports, parse_newick, to_newick
from pepr_tpu_torch.tree.basic import Tree

log = logging.getLogger("pepr_tpu_torch")


def jackknife_mask(cat: ConcatenatedAlignment, rep_idx: int, seed: int,
                   fraction: float = 0.5) -> np.ndarray:
    """(L,) float32 site-weight mask for one replicate: a random
    `fraction` of gene families sampled without replacement, seeded per
    (seed, rep)."""
    rng = np.random.default_rng([seed, rep_idx])
    G = cat.n_genes
    k = max(int(G * fraction), 1)
    genes = rng.choice(G, size=k, replace=False)
    return cat.gene_column_mask(genes).astype(np.float32)


def jackknife_gene_masks(cat: ConcatenatedAlignment, reps: int, seed: int,
                         fraction: float = 0.5) -> np.ndarray:
    return np.stack([jackknife_mask(cat, r, seed, fraction)
                     for r in range(reps)])


def bootstrap_weights(length: int, rep_idx: int, seed: int) -> np.ndarray:
    """(L,) float32 multinomial column-resampling weights (the classic
    bootstrap as a reweighting)."""
    rng = np.random.default_rng([seed, rep_idx, 7])
    counts = rng.multinomial(length, np.full(length, 1.0 / length))
    return counts.astype(np.float32)


def replicate_weights(cat: ConcatenatedAlignment, rep_idx: int, seed: int,
                      fraction: float = 0.5,
                      resample: str = "jackknife_genes") -> np.ndarray:
    """(L,) float32 site weights of one replicate: its gene-wise
    jackknife mask, or its multinomial column counts for
    `resample="bootstrap_sites"`."""
    if resample == "bootstrap_sites":
        return bootstrap_weights(cat.length, rep_idx, seed)
    return jackknife_mask(cat, rep_idx, seed, fraction)


def support_tree_single(cat: ConcatenatedAlignment, rep_idx: int,
                        seed: int, *, model: WagModel | None = None,
                        method: str = "fast_ml", fraction: float = 0.5,
                        nni_rounds: int = 2, bl_steps: int = 60,
                        resample: str = "jackknife_genes",
                        device=None) -> Tree:
    """One replicate on its weights (`resample`): the plain NJ tree for
    `method="nj"`, else `ml_tree` with NNI only (`spr_rounds=0`), like
    the batched path, with refits of max(bl_steps // 2, 20) steps."""
    w = replicate_weights(cat, rep_idx, seed, fraction, resample)
    if method == "nj":
        return nj_tree(cat.mat, cat.taxa, site_weights=w, device=device)
    tree, _ = ml_tree(cat.mat, cat.taxa, model, site_weights=w,
                      nni_rounds=nni_rounds, bl_steps=bl_steps,
                      bl_refine_steps=max(bl_steps // 2, 20),
                      spr_rounds=0, device=device)
    return tree


def support_trees(cat: ConcatenatedAlignment, reps: int, seed: int, *,
                  model: WagModel | None = None, method: str = "fast_ml",
                  fraction: float = 0.5, nni_rounds: int = 2,
                  bl_steps: int = 60, resample: str = "jackknife_genes",
                  store=None, deadline=None, device=None) -> list[Tree]:
    """Build `reps` support trees: the batched replicate fan-out for
    `ml` and `fast_ml` with `reps` > 1, else `support_tree_single` one
    replicate at a time (every `nj` replicate), each saved to `store`
    and the `deadline` polled before each, as in the JAX package."""
    if model is None:
        model = WagModel.create()
    if method in ("ml", "fast_ml") and reps > 1:
        return support_trees_batched(
            cat, reps, seed, model=model, fraction=fraction,
            nni_rounds=nni_rounds, bl_steps=bl_steps, resample=resample,
            store=store, deadline=deadline, device=device)
    out: list[Tree] = []
    for r in range(reps):
        key = f"support_{r:04d}"
        if store is not None and store.has(key):
            out.append(parse_newick(store.load(key)))
            continue
        check_deadline(deadline, f"support tree {r}/{reps}")
        tree = support_tree_single(cat, r, seed, model=model, method=method,
                                   fraction=fraction, nni_rounds=nni_rounds,
                                   bl_steps=bl_steps, resample=resample,
                                   device=device)
        if store is not None:
            store.save(key, to_newick(tree))
        out.append(tree)
    return out


def support_trees_batched(cat: ConcatenatedAlignment, reps: int,
                          seed: int, *, model: WagModel | None = None,
                          fraction: float = 0.5, nni_rounds: int = 2,
                          bl_steps: int = 60,
                          resample: str = "jackknife_genes", store=None,
                          deadline=None, device=None) -> list[Tree]:
    """All replicates at once: per-replicate NJ starts, joint BL-opt,
    then NNI rounds until no replicate improves (FastTree-style cap of
    ~4 log2 N rounds; `nni_rounds` is a floor).  `store` and `deadline`
    make it resumable at the points the module docstring lists."""
    dev = resolve_device(device)
    if model is None:
        model = WagModel.create()
    keys = [f"support_{r:04d}" for r in range(reps)]
    if store is not None and all(store.has(k) for k in keys):
        return [parse_newick(store.load(k)) for k in keys]

    def cached(key, fn):
        return store.cached(key, fn) if store is not None else fn()

    def load(key, default):
        return store.load(key) if store is not None and store.has(key) \
            else default

    def save(key, obj):
        if store is not None:
            store.save(key, obj)

    masks = np.stack([replicate_weights(cat, r, seed, fraction, resample)
                      for r in range(reps)])
    # the starting trees through Newick, as the store keeps them
    start_nwks = cached("support_starts", lambda: [
        to_newick(nj_start_tree(cat.mat, cat.taxa, masks[r], device=dev))
        for r in range(reps)])
    arrs = [tree_to_arrays(parse_newick(nwk), cat.taxa)
            for nwk in start_nwks]
    children = np.stack([a.children for a in arrs])  # (R, n_int, 3)
    check_deadline(deadline, "support starts")

    block = replicates.BLOCK_REPS
    mesh = default_mesh()
    state = load("support_batch_state", None)
    if state is not None:
        children, blens, lls, round_done = state
    else:
        blens0 = np.stack([a.blen for a in arrs])
        bstate: dict = load("support_blopt_blocks", {})
        last_block = 0.0
        for b0 in range(0, reps, block):
            if b0 in bstate:
                continue
            check_deadline(deadline, "support BL-opt")
            if deadline is not None and last_block > 0.0 and \
                    deadline.remaining() < 1.1 * last_block:
                # a block that cannot finish inside the budget is lost
                raise Incomplete("support BL-opt (block won't fit)")
            t0 = time.time()
            sl = slice(b0, b0 + block)
            bstate[b0] = sharded_replicate_blopt(
                mesh, cat.mat, masks[sl], children[sl], blens0[sl], model,
                steps=bl_steps, device=dev)
            # rank 0's clock, so that every rank takes the budget's turn
            last_block = rank0_value(time.time() - t0)
            save("support_blopt_blocks", bstate)
            log.info("support: BL-opt block %d-%d/%d done", b0,
                     b0 + len(bstate[b0][1]) - 1, reps)
        starts = range(0, reps, block)
        blens = np.concatenate([bstate[b0][0] for b0 in starts])
        lls = np.concatenate([bstate[b0][1] for b0 in starts])
        round_done = 0
        save("support_batch_state", (children, blens, lls, round_done))
        log.info("support: batched BL-opt of %d replicates done", reps)
    check_deadline(deadline, "support BL-opt")

    n_leaves = len(cat.taxa)
    margs = model_tensors(model, dev)
    codes = np.asarray(cat.mat, np.int8)
    rep_data: dict = {}  # each replicate's (compacted) codes, made once
    max_rounds = max(nni_rounds, 4 * int(np.ceil(np.log2(max(n_leaves, 4)))))
    for rnd in range(round_done, max_rounds):
        # every replicate's NNI neighbourhood, scored (by replicate,
        # saved at most once a minute, at the end and on interruption)
        sc_key = f"support_nni_scores_{rnd}"
        sstate: dict = load(sc_key, {})
        last_save = time.time()
        new_children = children.copy()
        moved: list[int] = []
        for r in range(reps):
            moves = _nni_moves(children[r], n_leaves)
            cands = [_nni_candidate(children[r], blens[r], n_leaves, [m])
                     for m in moves]
            if r not in sstate:
                if deadline is not None and deadline.near(60.0):
                    save(sc_key, sstate)
                    raise Incomplete(f"support NNI scoring round {rnd}")
                if r not in rep_data:
                    rep_data[r] = replicate_codes(codes, masks[r:r + 1], dev)
                cd, w = rep_data[r]
                sstate[r] = _score_topologies(
                    cd[0] if cd.dim() == 3 else cd, [c for c, _ in cands],
                    [b for _, b in cands], margs, w[0])
                if time.time() - last_save > 60.0:
                    save(sc_key, sstate)
                    last_save = time.time()
            scores = sstate[r]
            improving = np.nonzero(scores > lls[r] + 1e-4)[0]
            if len(improving) == 0:
                continue
            taken, touched = [], set()
            for idx in improving[np.argsort(-scores[improving])]:
                k_c, k_p, kid, z = moves[int(idx)]
                if {k_c, k_p} & touched:
                    continue
                touched |= {k_c, k_p}
                taken.append(moves[int(idx)])
            fixed, nb = _nni_candidate(children[r], blens[r], n_leaves,
                                       taken)
            blens[r] = nb
            new_children[r] = fixed
            moved.append(r)
        save(sc_key, sstate)
        children = new_children
        if not moved:
            log.info("support: NNI converged after round %d", rnd)
            break
        # re-optimize branch lengths of the moved replicates only, in
        # blocks of the moved list
        mv_key = f"support_moved_blopt_{rnd}"
        mstate: dict = load(mv_key, {})
        for m0 in range(0, len(moved), block):
            sel = moved[m0:m0 + block]
            if m0 not in mstate:
                if deadline is not None and deadline.near(60.0):
                    raise Incomplete(f"support moved-BL-opt round {rnd}")
                mstate[m0] = sharded_replicate_blopt(
                    mesh, cat.mat, masks[sel], children[sel], blens[sel],
                    model, steps=max(bl_steps // 2, 20), device=dev)
                save(mv_key, mstate)
            blens[sel], lls[sel] = mstate[m0]
        save("support_batch_state", (children, blens, lls, rnd + 1))
        log.info("support: NNI round %d moved %d/%d replicates", rnd,
                 len(moved), reps)
        if rnd == max_rounds - 1:
            log.warning("support: NNI round cap %d hit with %d "
                        "replicates still moving", max_rounds, len(moved))
        check_deadline(deadline, f"support NNI round {rnd}")

    trees = []
    for r in range(reps):
        tree = arrays_to_tree(TreeArrays(children[r], blens[r],
                                         arrs[r].node_of_tree_node,
                                         list(cat.taxa)))
        save(keys[r], to_newick(tree))
        trees.append(tree)
    return trees


def decorated_tree(full_tree: Tree, reps_trees: list[Tree]) -> Tree:
    """Support counts written onto the full tree
    (TreeSupportDecorator.java:86-163)."""
    return decorate_supports(full_tree, reps_trees)
