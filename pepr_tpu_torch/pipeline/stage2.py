"""Stage 2: homolog groups -> alignments -> concatenation -> trees
(PyTorch port of `pepr_tpu/pipeline/stage2.py`).

The orchestration replacing PhylogenomicPipeline2
(PhylogenomicPipeline2.java:102-427): filter sets by taxa counts,
align (batched progressive MSA with a refinement pass; blastn-style
scores for the nucleotide alphabet), trim (Gblocks semantics), drop the
least congruent genes (optional), concatenate over the taxon union,
estimate the Gamma shape, pick the substitution model (matrix
evaluation, optional; GTR for nucleotides), build the full tree (`ml`,
`fast_ml`, `nj`, `parsimony`, `parsimony_bl`) and the support trees,
decorate supports.  `run_stage2` starts from homolog groups;
`run_stage2_aligned` from aligned families.  Both end in one tail,
`_tree_stage`.

Every `Stage2Config` value of the JAX package runs here.  With a
checkpoint `store` the alignments (slices under `s2_align_chunk_{i}`,
then `alignments`), the Gamma shape (`gamma_alpha`), matrix evaluation
(`matrix_eval`), the full tree (`full_tree`, its search state under
`full_tree_state`) and the support trees are saved under the JAX
package's keys, and `deadline` is polled after each of them.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

import numpy as np

from pepr_tpu_torch.alphabet import N_NT
from pepr_tpu_torch.data.nt_scores import NT_GAP_EXTEND, NT_GAP_OPEN, nt_core
from pepr_tpu_torch.device import resolve_device
from pepr_tpu_torch.io.fasta import SequenceSet
from pepr_tpu_torch.models.concat import ConcatenatedAlignment, concatenate
from pepr_tpu_torch.models.congruence import filter_congruent
from pepr_tpu_torch.models.msa import (Alignment, align_families_chunked,
                                       refine_families)
from pepr_tpu_torch.models.support import decorated_tree, support_trees
from pepr_tpu_torch.models.treebuild import (empirical_aa_freqs,
                                             estimate_gamma_alpha,
                                             evaluate_substitution_models,
                                             ml_tree, nj_start_tree, nj_tree,
                                             parsimony_tree)
from pepr_tpu_torch.ops.likelihood import WagModel
from pepr_tpu_torch.ops.trim import gblocks_mask
from pepr_tpu_torch.pipeline.checkpoint import check_deadline
from pepr_tpu_torch.tree import parse_newick, to_newick
from pepr_tpu_torch.tree.basic import Tree

log = logging.getLogger("pepr_tpu_torch")


@dataclass
class Stage2Config:
    """Every field of the JAX package's `Stage2Config`, under the same
    names and defaults."""
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


FULL_TREE_METHODS = ("ml", "fast_ml", "nj", "parsimony", "parsimony_bl")


def check_config(cfg: Stage2Config) -> None:
    """Raise ValueError for an unknown full-tree method before any work
    is done."""
    if cfg.full_tree_method not in FULL_TREE_METHODS:
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
               store=None, deadline=None, device=None) -> Stage2Result:
    """Stage 2 from homolog groups: filter, align, refine, trim, then
    the tree stage, on the card unless `device="cpu"`; `store` and
    `deadline` as in the module docstring."""
    cfg = cfg or Stage2Config()
    check_config(cfg)
    dev = resolve_device(device)
    timings: dict = {}

    t0 = time.time()
    kept = filter_sets(sets, cfg)
    if not kept:
        raise ValueError("no homolog groups survive the taxa filters")

    def align_and_trim():
        nt_kw = {}
        if cfg.alphabet == "nt":
            nt_kw = dict(core=nt_core(), gap_open=float(NT_GAP_OPEN),
                         gap_extend=float(NT_GAP_EXTEND))
        mats = align_families_chunked(
            [s.seqs for s in kept], store=store, deadline=deadline,
            ckpt_key="s2_align_chunk", device=dev, **nt_kw)
        if cfg.msa_refine_iters > 0:
            mats, n_imp = refine_families(mats, iters=cfg.msa_refine_iters,
                                          device=dev, **nt_kw)
            log.info("stage2: MSA refinement improved %d/%d families",
                     n_imp, len(mats))
        alignments = [Alignment(s.name, list(s.taxa), m,
                                titles=list(s.titles))
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
        return alignments

    alignments = store.cached("alignments", align_and_trim) \
        if store is not None else align_and_trim()
    timings["align"] = time.time() - t0
    log.info("stage2: aligned %d families in %.1fs", len(alignments),
             timings["align"])
    check_deadline(deadline, "alignment")
    return _tree_stage(alignments, cfg, dev, timings, store, deadline)


def run_stage2_aligned(alignments: list[Alignment],
                       cfg: Stage2Config | None = None, store=None,
                       deadline=None, device=None) -> Stage2Result:
    """Stage 2 from aligned (trimmed) families to the support-decorated
    ML tree, on the card unless `device="cpu"`; `store` and `deadline`
    as in the module docstring."""
    cfg = cfg or Stage2Config()
    check_config(cfg)
    return _tree_stage(alignments, cfg, resolve_device(device), {}, store,
                       deadline)


def substitution_model(model_name: str, alpha: float,
                       mat: np.ndarray) -> WagModel:
    """The tree stage's model: GTR+Gamma with the alignment's base
    frequencies for "GTR" (FastTree -gtr -nt role,
    FastTreeRunner.java:67-77), WAG+Gamma, or a registered model with
    the alignment's residue frequencies for its '...F' form."""
    if model_name == "GTR":
        counts = np.bincount(mat[mat < N_NT].ravel(),
                             minlength=N_NT).astype(np.float64)
        return WagModel.gtr_nt(freqs=counts / max(counts.sum(), 1.0),
                               alpha=alpha)
    if model_name == "WAG":
        return WagModel.create(alpha=alpha)
    return WagModel.named(model_name, alpha=alpha,
                          empirical_freqs=empirical_aa_freqs(mat))


def _tree_stage(alignments: list[Alignment], cfg: Stage2Config, dev,
                timings: dict, store=None, deadline=None) -> Stage2Result:
    """Congruence filter -> concatenation -> Gamma shape -> matrix
    evaluation -> full tree -> support trees -> support decoration (the
    tail of the JAX `run_stage2`)."""

    def cached(key, fn):
        return store.cached(key, fn) if store is not None else fn()

    if cfg.congruence_filter:
        t0 = time.time()
        alignments = filter_congruent(alignments,
                                      drop_fraction=cfg.congruence_drop)
        timings["congruence_filter"] = time.time() - t0
        log.info("stage2: congruence filter kept %d families (%.1fs)",
                 len(alignments), timings["congruence_filter"])

    t0 = time.time()
    cat = concatenate(alignments)
    timings["concat"] = time.time() - t0
    log.info("stage2: concatenated %d genes, %d columns", cat.n_genes,
             cat.length)

    alpha = cfg.gamma_alpha
    # under WAG for the nucleotide alphabet too, as the JAX package does
    if cfg.estimate_alpha and cfg.full_tree_method != "nj":
        t0 = time.time()

        def estimate():
            start = nj_start_tree(cat.mat, cat.taxa, device=dev)
            return estimate_gamma_alpha(cat.mat, cat.taxa, start, device=dev)

        alpha = cached("gamma_alpha", estimate)
        timings["alpha_estimate"] = time.time() - t0
        log.info("stage2: gamma alpha = %.3f (%.1fs)", alpha,
                 timings["alpha_estimate"])
        check_deadline(deadline, "alpha estimation")

    model_name = "WAG"
    if cfg.matrix_evaluation:
        t0 = time.time()
        names = cfg.matrix_evaluation \
            if isinstance(cfg.matrix_evaluation, list) else None
        model_name, _ = cached("matrix_eval", lambda: (
            evaluate_substitution_models(cat.mat, cat.taxa, names,
                                         alpha=alpha, device=dev)))
        timings["matrix_evaluation"] = time.time() - t0
        log.info("stage2: matrix evaluation chose %s (%.1fs)", model_name,
                 timings["matrix_evaluation"])
        check_deadline(deadline, "matrix evaluation")

    if cfg.alphabet == "nt":
        model_name = "GTR"
    model = substitution_model(model_name, alpha, cat.mat)

    t0 = time.time()

    def full_tree():
        if cfg.full_tree_method == "nj":
            return to_newick(nj_tree(cat.mat, cat.taxa, device=dev)), None
        if cfg.full_tree_method in ("parsimony", "parsimony_bl"):
            t, _ = parsimony_tree(
                cat.mat, cat.taxa, model=model,
                branch_lengths=cfg.full_tree_method == "parsimony_bl",
                nni_rounds=cfg.nni_rounds, bl_steps=cfg.bl_steps, device=dev)
            return to_newick(t), None
        fast = cfg.full_tree_method == "fast_ml"
        t, ll = ml_tree(
            cat.mat, cat.taxa, model,
            nni_rounds=(2 if fast else cfg.nni_rounds),
            bl_steps=(60 if fast else cfg.bl_steps),
            bl_refine_steps=(30 if fast else max(cfg.bl_steps // 3, 40)),
            spr_rounds=(1 if fast else 2), store=store, deadline=deadline,
            ckpt_key="full_tree_state", device=dev)
        return to_newick(t), ll

    # the full tree kept as Newick, as the JAX package keeps it
    full_nwk, ll = cached("full_tree", full_tree)
    full = parse_newick(full_nwk)
    timings["full_tree"] = time.time() - t0
    log.info("stage2: full tree (%s) in %.1fs", cfg.full_tree_method,
             timings["full_tree"])
    check_deadline(deadline, "full tree")

    t0 = time.time()
    reps = support_trees(
        cat, cfg.support_reps, cfg.seed, model=model,
        method=cfg.support_method, fraction=cfg.jackknife_fraction,
        nni_rounds=cfg.nni_rounds, bl_steps=cfg.support_bl_steps,
        store=store, deadline=deadline, device=dev)
    timings["support_trees"] = time.time() - t0
    log.info("stage2: %d support trees in %.1fs", len(reps),
             timings["support_trees"])

    dec = decorated_tree(full, reps)
    return Stage2Result(dec, full, reps, cat, alignments, ll, alpha,
                        model_name, timings)
