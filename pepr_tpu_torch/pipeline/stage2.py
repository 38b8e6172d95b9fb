"""Stage 2 from aligned families: concatenation -> Gamma shape -> full
ML tree -> jackknife support trees -> support decoration (PyTorch port
of the tail of `pepr_tpu/pipeline/stage2.py::run_stage2`, from
`concatenate(alignments)` to `decorated_tree`).

Ported: the `ml` and `fast_ml` full-tree methods under WAG+Gamma, with
or without the alpha estimate.  Not ported yet: filtering, alignment
and trimming of homolog groups, the congruence filter, matrix
evaluation, the nucleotide model, the `nj`/`parsimony` full-tree
methods and checkpoint/deadline resume.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

from pepr_tpu_torch.device import resolve_device
from pepr_tpu_torch.models.concat import ConcatenatedAlignment, concatenate
from pepr_tpu_torch.models.msa import Alignment
from pepr_tpu_torch.models.support import decorated_tree, support_trees
from pepr_tpu_torch.models.treebuild import (estimate_gamma_alpha, ml_tree,
                                             nj_start_tree)
from pepr_tpu_torch.ops.likelihood import WagModel
from pepr_tpu_torch.tree import parse_newick, to_newick
from pepr_tpu_torch.tree.basic import Tree

log = logging.getLogger("pepr_tpu_torch")


@dataclass
class Stage2Config:
    """The stage-2 settings the aligned-families tail reads (same names
    and defaults as the JAX package's `Stage2Config`)."""
    full_tree_method: str = "ml"  # ml | fast_ml
    support_method: str = "fast_ml"
    support_reps: int = 100
    jackknife_fraction: float = 0.5
    gamma_alpha: float = 1.0
    estimate_alpha: bool = True
    nni_rounds: int = 8
    bl_steps: int = 200
    support_bl_steps: int = 60
    seed: int = 12345


@dataclass
class Stage2Result:
    tree: Tree  # support-decorated full tree
    full_tree: Tree
    support_trees: list[Tree]
    concat: ConcatenatedAlignment
    alignments: list[Alignment]
    log_likelihood: float | None = None
    gamma_alpha: float = 1.0
    model_name: str = "WAG"
    timings: dict = field(default_factory=dict)

    @property
    def newick(self) -> str:
        return to_newick(self.tree)


def run_stage2_aligned(alignments: list[Alignment],
                       cfg: Stage2Config | None = None,
                       device=None) -> Stage2Result:
    """Stage 2 from aligned (trimmed) families to the support-decorated
    ML tree, on the card unless `device="cpu"`."""
    cfg = cfg or Stage2Config()
    if cfg.full_tree_method not in ("ml", "fast_ml"):
        raise ValueError(f"full_tree_method {cfg.full_tree_method!r} is not "
                         "ported yet (ml and fast_ml are)")
    dev = resolve_device(device)
    timings: dict = {}

    t0 = time.time()
    cat = concatenate(alignments)
    timings["concat"] = time.time() - t0
    log.info("stage2: concatenated %d genes, %d columns", cat.n_genes,
             cat.length)

    alpha = cfg.gamma_alpha
    if cfg.estimate_alpha:
        t0 = time.time()
        start = nj_start_tree(cat.mat, cat.taxa, device=dev)
        alpha = estimate_gamma_alpha(cat.mat, cat.taxa, start, device=dev)
        timings["alpha_estimate"] = time.time() - t0
        log.info("stage2: gamma alpha = %.3f (%.1fs)", alpha,
                 timings["alpha_estimate"])
    model = WagModel.create(alpha=alpha)

    t0 = time.time()
    fast = cfg.full_tree_method == "fast_ml"
    full, ll = ml_tree(
        cat.mat, cat.taxa, model,
        nni_rounds=(2 if fast else cfg.nni_rounds),
        bl_steps=(60 if fast else cfg.bl_steps),
        bl_refine_steps=(30 if fast else max(cfg.bl_steps // 3, 40)),
        spr_rounds=(1 if fast else 2), device=dev)
    full = parse_newick(to_newick(full))  # the Newick round trip, as
    # the JAX package keeps the full tree
    timings["full_tree"] = time.time() - t0
    log.info("stage2: full tree (%s) in %.1fs", cfg.full_tree_method,
             timings["full_tree"])

    t0 = time.time()
    reps = support_trees(
        cat, cfg.support_reps, cfg.seed, model=model,
        method=cfg.support_method, fraction=cfg.jackknife_fraction,
        nni_rounds=cfg.nni_rounds, bl_steps=cfg.support_bl_steps,
        device=dev)
    timings["support_trees"] = time.time() - t0
    log.info("stage2: %d support trees in %.1fs", len(reps),
             timings["support_trees"])

    dec = decorated_tree(full, reps)
    return Stage2Result(dec, full, reps, cat, alignments, ll, alpha, "WAG",
                        timings)
