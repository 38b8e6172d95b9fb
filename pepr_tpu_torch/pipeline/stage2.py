"""Stage 2: homolog groups -> alignments -> concatenation -> trees
(PyTorch port of `pepr_tpu/pipeline/stage2.py`).

The orchestration replacing PhylogenomicPipeline2
(PhylogenomicPipeline2.java:102-427): filter sets by taxa counts,
align (batched progressive MSA with a refinement pass), trim (Gblocks
semantics), concatenate over the taxon union, estimate the Gamma shape,
build the full ML tree and gene-wise jackknife support trees, decorate
supports.  `run_stage2` starts from homolog groups; `run_stage2_aligned`
from aligned families.  Both end in one tail, `_tree_stage`.

Ported: the `ml` and `fast_ml` full-tree methods under WAG+Gamma, with
or without the alpha estimate, on the amino-acid alphabet.  Not ported
yet (each raises NotImplementedError naming its ROADMAP Queue 1 item):
the congruence filter, matrix evaluation, the nucleotide model and the
`nj`/`parsimony` full-tree methods (item 8); nor checkpoint/deadline
resume (item 14).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

from pepr_tpu_torch.device import resolve_device
from pepr_tpu_torch.io.fasta import SequenceSet
from pepr_tpu_torch.models.concat import ConcatenatedAlignment, concatenate
from pepr_tpu_torch.models.msa import (Alignment, align_families_chunked,
                                       refine_families)
from pepr_tpu_torch.models.support import decorated_tree, support_trees
from pepr_tpu_torch.models.treebuild import (estimate_gamma_alpha, ml_tree,
                                             nj_start_tree)
from pepr_tpu_torch.ops.likelihood import WagModel
from pepr_tpu_torch.ops.profile_align import release_plans
from pepr_tpu_torch.ops.trim import gblocks_mask
from pepr_tpu_torch.tree import parse_newick, to_newick
from pepr_tpu_torch.tree.basic import Tree

log = logging.getLogger("pepr_tpu_torch")


@dataclass
class Stage2Config:
    """Every field of the JAX package's `Stage2Config`, under the same
    names and defaults; `check_ported` refuses the values whose code is
    not ported yet."""
    min_taxa: int = 4
    max_taxa: int = 10 ** 9
    target_sets: int | None = None  # cap on gene families (largest kept)
    representative_only: bool = False  # one member per taxon per set
    trim: bool = True
    congruence_filter: bool = False
    congruence_drop: float = 0.1
    full_tree_method: str = "ml"  # ml | fast_ml | nj | parsimony[_bl]
    support_method: str = "fast_ml"  # FastTree-equivalent
    support_reps: int = 100
    jackknife_fraction: float = 0.5
    gamma_alpha: float = 1.0
    # ML estimate of the Gamma shape on the NJ starting topology before
    # tree search; gamma_alpha is the fallback/fixed value
    estimate_alpha: bool = True
    # matrix evaluation (PhylogenomicPipeline2.java:252-295): False, True
    # or a list of model names
    matrix_evaluation: bool | list = False
    # muscle-style MSA refinement passes (re-estimate the guide tree from
    # the current alignment, re-align, keep on improved sum-of-pairs)
    msa_refine_iters: int = 1
    nni_rounds: int = 8
    bl_steps: int = 200
    # support replicates play the reference's FastTree role: a lighter
    # branch-length budget than the full tree's bl_steps
    support_bl_steps: int = 60
    seed: int = 12345
    # "nt": blastn-style alignment scores and GTR+Gamma trees
    alphabet: str = field(default="aa", repr=False)


def check_ported(cfg: Stage2Config) -> None:
    """Raise NotImplementedError for an option whose code is not ported
    yet, naming its ROADMAP Queue 1 item."""
    if cfg.congruence_filter:
        raise NotImplementedError(
            "congruence_filter is not ported yet (ROADMAP Queue 1 item 8)")
    if cfg.matrix_evaluation:
        raise NotImplementedError(
            "matrix_evaluation is not ported yet (ROADMAP Queue 1 item 8)")
    if cfg.alphabet != "aa":
        raise NotImplementedError(
            f"alphabet {cfg.alphabet!r} (the GTR nucleotide model) is not "
            "ported yet (ROADMAP Queue 1 item 8)")
    if cfg.full_tree_method in ("nj", "parsimony", "parsimony_bl"):
        raise NotImplementedError(
            f"full_tree_method {cfg.full_tree_method!r} is not ported yet "
            "(ROADMAP Queue 1 item 8)")
    if cfg.full_tree_method not in ("ml", "fast_ml"):
        raise ValueError(f"unknown full_tree_method {cfg.full_tree_method!r}")


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


def filter_sets(sets: list[SequenceSet],
                cfg: Stage2Config) -> list[SequenceSet]:
    """Taxon-count and representative filters
    (SequenceSetProviderImpl.java:115-140, 223-247, 295-329)."""
    out = []
    for s in sets:
        taxa = s.distinct_taxa()
        if not (cfg.min_taxa <= len(taxa) <= cfg.max_taxa):
            continue
        if cfg.representative_only and len(taxa) != len(s):
            # keep first member per taxon
            seen: set[str] = set()
            keep = []
            for i, t in enumerate(s.taxa):
                if t not in seen:
                    seen.add(t)
                    keep.append(i)
            s = s.subset(keep)
        out.append(s)
    out.sort(key=len, reverse=True)
    if cfg.target_sets is not None:
        out = out[: cfg.target_sets]
    return out


def run_stage2(sets: list[SequenceSet], cfg: Stage2Config | None = None,
               device=None) -> Stage2Result:
    """Stage 2 from homolog groups: filter, align, refine, trim, then
    the tree stage, on the card unless `device="cpu"`."""
    cfg = cfg or Stage2Config()
    check_ported(cfg)
    dev = resolve_device(device)
    timings: dict = {}

    t0 = time.time()
    kept = filter_sets(sets, cfg)
    if not kept:
        raise ValueError("no homolog groups survive the taxa filters")
    mats = align_families_chunked([s.seqs for s in kept], device=dev)
    if cfg.msa_refine_iters > 0:
        mats, n_imp = refine_families(mats, iters=cfg.msa_refine_iters,
                                      device=dev)
        log.info("stage2: MSA refinement improved %d/%d families", n_imp,
                 len(mats))
    release_plans()  # the DP's cached plans; the tree stage needs the room
    alignments = [Alignment(s.name, list(s.taxa), m, titles=list(s.titles))
                  for s, m in zip(kept, mats)]
    if cfg.trim:
        trimmed = []
        for a in alignments:
            mask = gblocks_mask(a.mat)
            if mask.sum() == 0:
                continue
            trimmed.append(Alignment(a.name, a.taxa, a.mat[:, mask],
                                     titles=a.titles))
        if trimmed:
            alignments = trimmed
    timings["align"] = time.time() - t0
    log.info("stage2: aligned %d families in %.1fs", len(alignments),
             timings["align"])
    return _tree_stage(alignments, cfg, dev, timings)


def run_stage2_aligned(alignments: list[Alignment],
                       cfg: Stage2Config | None = None,
                       device=None) -> Stage2Result:
    """Stage 2 from aligned (trimmed) families to the support-decorated
    ML tree, on the card unless `device="cpu"`."""
    cfg = cfg or Stage2Config()
    check_ported(cfg)
    return _tree_stage(alignments, cfg, resolve_device(device), {})


def _tree_stage(alignments: list[Alignment], cfg: Stage2Config, dev,
                timings: dict) -> Stage2Result:
    """Concatenation -> Gamma shape -> full ML tree -> jackknife support
    trees -> support decoration (the tail of the JAX `run_stage2`)."""
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
