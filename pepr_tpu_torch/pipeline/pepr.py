"""Top-level PEPR pipeline: genomes in, rooted supported species tree out
(PyTorch port of `pepr_tpu/pipeline/pepr.py`).

The orchestration role of PhyloPipeline (PhyloPipeline.java:111-708):
stage 1 (homology -> MCL -> homolog groups -> HMM enhancement and
outgroup selection), stage 2 (align -> trim -> concatenate -> full tree
+ jackknife supports), outgroup rooting, progressive refinement by
sub-runs on low-support subtrees, and the output files
(nwk/json/sup/hs/clp/report.xml).  Everything runs on `device` (the
card unless "cpu").

`checkpoint_dir` makes a run resumable: every stage saves its results
in a store there (`pipeline/checkpoint.py`), each refinement sub-run in
its own store `sub{round}` under it, and a second run of the same
configuration picks up where the first stopped.  `time_budget` is a
soft budget in seconds: the stages poll it and raise `Incomplete`,
naming the stage, with the store left resumable; a sub-run gets what
remains of it.  Over several ranks (`parallel.mesh`) every rank runs the
whole pipeline, the support replicates spread over the mesh, and only
rank 0 writes the store and the output files while the others wait at
a barrier.  The store's fingerprint covers what the JAX package's
covers plus the alphabet, which that package leaves out (its
`Stage1Config`/`Stage2Config` reprs omit it), so a nucleotide run never
resumes a protein store.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field, replace

from pepr_tpu_torch.device import resolve_device
from pepr_tpu_torch.io.fasta import SequenceSet, read_fasta
from pepr_tpu_torch.parallel.mesh import barrier, is_writer
from pepr_tpu_torch.pipeline.checkpoint import (CheckpointStore, Deadline,
                                                config_fingerprint)
from pepr_tpu_torch.pipeline.refine import refine_tree
from pepr_tpu_torch.pipeline.reports import RunTracker, write_outputs
from pepr_tpu_torch.pipeline.stage1 import Stage1Config, run_stage1
from pepr_tpu_torch.pipeline.stage2 import (Stage2Config, Stage2Result,
                                            run_stage2)
from pepr_tpu_torch.tree import root_by_outgroup, to_newick
from pepr_tpu_torch.tree.basic import Tree
from pepr_tpu_torch.tree.rooting import compress_name


@dataclass
class PeprConfig:
    run_name: str = "pepr_run"
    genome_files: list[str] = field(default_factory=list)
    outgroup_files: list[str] = field(default_factory=list)
    outgroup_count: int = 2
    out_dir: str = "."
    refine: bool = True
    refine_cutoff: float = 100.0
    max_refine_rounds: int = 10
    subtree: bool = False  # set for refinement sub-runs
    checkpoint_dir: str | None = None  # enables resume
    time_budget: float | None = None  # soft seconds budget (resumable)
    min_taxa_multiplier: float = 0.8
    min_taxa: int | None = None
    max_taxa: int | None = None
    target_sets: int | None = None
    # "nt": nucleotide pipeline (propagated to both stages)
    alphabet: str = "aa"
    stage1: Stage1Config = field(default_factory=Stage1Config)
    stage2: Stage2Config = field(default_factory=Stage2Config)

    def __post_init__(self):
        self.stage1.alphabet = self.alphabet
        self.stage2.alphabet = self.alphabet

    # preset equivalent to the reference's default -track
    # (PhyloPipeline.java:1102-1147: blast/blat + bidirectional,
    # concatenated ML full tree, FastTree-style jackknife supports,
    # 100 reps, Gblocks trim, refine on, min_taxa_multiplier 0.99)
    @classmethod
    def default_track(cls, **kw) -> "PeprConfig":
        cfg = cls(**kw)
        cfg.min_taxa_multiplier = 0.99
        cfg.stage2.full_tree_method = "ml"
        cfg.stage2.support_method = "fast_ml"
        cfg.stage2.support_reps = 100
        cfg.stage1.unique_species = True
        cfg.stage2.congruence_filter = False
        return cfg


@dataclass
class PeprResult:
    tree: Tree  # rooted, support-decorated
    stage2: Stage2Result
    selected_outgroups: list[str]
    output_paths: dict = field(default_factory=dict)
    # wall seconds: stage1, stage2, refine, write (host clock)
    timings: dict = field(default_factory=dict)
    refine_rounds: int = 0
    stage1_counts: dict = field(default_factory=dict)

    @property
    def newick(self) -> str:
        return to_newick(self.tree)


def _load_genomes(paths: list[str],
                  alphabet: str = "aa") -> list[SequenceSet]:
    return [read_fasta(p, alphabet=alphabet) for p in paths]


def _sync(dev) -> None:
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)


def run_pepr(cfg: PeprConfig,
             genomes: list[SequenceSet] | None = None,
             outgroup_pool: list[SequenceSet] | None = None,
             write_files: bool = True, device=None) -> PeprResult:
    dev = resolve_device(device)
    timings: dict = {}
    tracker = RunTracker(cfg.run_name)
    rec = tracker.new_round("round_1" if not cfg.subtree else "subtree")

    store = None
    if cfg.checkpoint_dir is not None:
        # everything that affects saved results, not the per-slice knobs
        # (time_budget, out_dir, checkpoint_dir) nor the device
        fp = config_fingerprint(
            cfg.stage1, cfg.stage2, cfg.outgroup_count,
            cfg.min_taxa_multiplier, cfg.min_taxa, cfg.max_taxa,
            cfg.target_sets,
            [os.path.basename(p) for p in cfg.genome_files],
            [os.path.basename(p) for p in cfg.outgroup_files],
            cfg.alphabet)
        store = CheckpointStore(cfg.checkpoint_dir, fingerprint=fp)
    deadline = Deadline(cfg.time_budget)

    if genomes is None:
        genomes = _load_genomes(cfg.genome_files, cfg.alphabet)
    if outgroup_pool is None:
        outgroup_pool = _load_genomes(cfg.outgroup_files, cfg.alphabet)

    t0 = time.time()
    s1cfg = replace(cfg.stage1, outgroup_count=cfg.outgroup_count)

    def stage1():
        s1 = run_stage1(genomes, outgroup_pool, s1cfg, store=store,
                        deadline=deadline, device=dev)
        return s1.hg_sets, s1.selected_outgroups, s1.timings, s1.counts

    hg_sets, selected_outgroups, s1_timings, s1_counts = \
        store.cached("stage1", stage1) if store is not None else stage1()
    _sync(dev)
    timings["stage1"] = time.time() - t0
    rec["wall_seconds"].update(s1_timings)
    rec["outgroups"] = selected_outgroups

    t0 = time.time()
    max_taxa = cfg.max_taxa if cfg.max_taxa is not None else len(genomes)
    min_taxa = cfg.min_taxa if cfg.min_taxa is not None else \
        int(max_taxa * cfg.min_taxa_multiplier)
    min_taxa = max(min_taxa, 3)
    s2cfg = replace(
        cfg.stage2, min_taxa=min_taxa,
        max_taxa=max_taxa + len(selected_outgroups),
        target_sets=cfg.target_sets)
    s2 = run_stage2(hg_sets, s2cfg, store=store, deadline=deadline,
                    device=dev)
    _sync(dev)
    timings["stage2"] = time.time() - t0
    rec["wall_seconds"].update(s2.timings)
    rec["taxa"] = s2.concat.taxa
    rec["genes"] = s2.concat.n_genes
    rec["aligned_positions"] = s2.concat.length
    rec["tree_method"] = s2cfg.full_tree_method
    rec["support_method"] = s2cfg.support_method
    rec["gamma_alpha"] = s2.gamma_alpha
    rec["substitution_model"] = s2.model_name
    rec["tree"] = to_newick(s2.tree)

    rooted = root_by_outgroup(s2.tree, selected_outgroups) \
        if selected_outgroups else s2.tree

    rounds = 0
    if cfg.refine and not cfg.subtree:
        t0 = time.time()
        taxon_to_genome: dict[str, SequenceSet] = {}
        for g in genomes + outgroup_pool:
            taxon_to_genome[compress_name(g.taxon)] = g

        def run_subtree(ingroup_taxa, outgroup_taxa, round_idx):
            nonlocal rounds
            rounds = round_idx
            sub_in = [taxon_to_genome[compress_name(t)]
                      for t in ingroup_taxa
                      if compress_name(t) in taxon_to_genome]
            sub_out = [taxon_to_genome[compress_name(t)]
                       for t in outgroup_taxa
                       if compress_name(t) in taxon_to_genome]
            sub_ckpt = None
            if store is not None:
                sub_ckpt = os.path.join(store.root, f"sub{round_idx}")
            budget = None
            if deadline.t_end is not None:
                budget = deadline.remaining()
            # the unique-species filter is disabled for small subtree
            # runs (PhylogeneticTreeRefiner.java:89,145-149: fewer than
            # 5 unique species; a refinement region is often a cluster
            # of same-species genomes, which the filter would collapse)
            uniq_species = len({"_".join(g.taxon.split("_")[:2])
                                for g in sub_in}) >= 5
            sub_s1 = replace(cfg.stage1,
                             unique_species=cfg.stage1.unique_species
                             and uniq_species)
            sub_cfg = replace(
                cfg, run_name=f"{cfg.run_name}_refine_sub{round_idx}",
                refine=False, subtree=True,
                outgroup_count=min(len(sub_out), 2),
                min_taxa=None, max_taxa=None, stage1=sub_s1,
                checkpoint_dir=sub_ckpt, time_budget=budget)
            res = run_pepr(sub_cfg, genomes=sub_in, outgroup_pool=sub_out,
                           write_files=False, device=dev)
            srec = tracker.new_round(f"refine_{round_idx}")
            srec["taxa"] = res.stage2.concat.taxa
            srec["genes"] = res.stage2.concat.n_genes
            srec["aligned_positions"] = res.stage2.concat.length
            srec["tree"] = res.newick
            srec["outgroups"] = res.selected_outgroups
            return res.tree

        rooted = refine_tree(rooted, selected_outgroups, run_subtree,
                             cutoff=cfg.refine_cutoff,
                             max_rounds=cfg.max_refine_rounds)
        _sync(dev)
        timings["refine"] = time.time() - t0

    result = PeprResult(rooted, s2, selected_outgroups, timings=timings,
                        refine_rounds=rounds, stage1_counts=s1_counts)
    if write_files:
        t0 = time.time()
        clp = ["-run_name", cfg.run_name,
               "-genome_file", *cfg.genome_files,
               "-outgroup", *cfg.outgroup_files,
               "-outgroup_count", str(cfg.outgroup_count),
               "-refine", str(cfg.refine).lower()]
        if is_writer():
            result.output_paths = write_outputs(
                cfg.out_dir, cfg.run_name, tracker, rooted,
                support_trees=s2.support_trees,
                hs_text=s2.concat.hs_matrix_text(), clp_args=clp)
        barrier()
        timings["write"] = time.time() - t0
    return result
