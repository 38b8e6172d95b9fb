"""Command-line entry point with pepr-compatible flags (PyTorch port of
`pepr_tpu/pipeline/cli.py`).

Flag vocabulary follows the reference (HandyConstants.java:9-102 /
scripts/pepr.sh): -run_name, -genome_file, -outgroup, -outgroup_count,
-refine, -track, -conf, -support_reps, -tree_method (ml | fasttree |
nj | parsimony | parsimony_bl), -mcl_inflation, -min_taxa / -max_taxa
/ -min_taxa_multiplier, -unique_species / -unique_genus,
-congruence_filter, -matrix_eval [model,list], -alphabet nt (or -nt:
the blastn/GTR nucleotide pipeline), -logfile <path> (rolling file
log, the log4j role of lib/log4j.properties:1-10),
-track default|fast|blat_fast|
blast_fast|blat_raxml|blast_raxml (the reference's named tracks all
expand to the same default property list, PhyloPipeline.java:
1102-1147; *_fast keeps the FastTree full-tree method), -checkpoint
<dir> (save every stage's results there and resume from them) and
-time_budget <seconds> (a soft budget: when it runs out the run stops
with `Incomplete`, naming the stage, and the same command run again
resumes from the checkpoint directory).  The port adds -device
cpu|cuda (default: the card); a store written on one resumes on the
other.

Over several GPUs, one rank a card: with PEPR_COORDINATOR set
(`host:port` with PEPR_NUM_PROCS and PEPR_PROC_ID, or `auto` under
`torchrun`) every rank runs the pipeline, the support replicates spread
over the ranks (`parallel.mesh`), and rank 0 alone prints the tree and
writes the files, the log file and the checkpoint store.

Usage:
  python -m pepr_tpu_torch.pipeline.cli -run_name X \
      -genome_file in/*.faa -outgroup og/*.faa -outgroup_count 2 \
      [-device cpu] [-checkpoint DIR [-time_budget S]]
  PEPR_COORDINATOR=auto torchrun --nproc-per-node 4 \
      -m pepr_tpu_torch.pipeline.cli -run_name X ...
"""

from __future__ import annotations

import sys

import torch.distributed as dist

from pepr_tpu_torch.parallel.mesh import (initialize_distributed,
                                          is_writer, shutdown_distributed)
from pepr_tpu_torch.pipeline.pepr import PeprConfig, run_pepr
from pepr_tpu_torch.utils.cli import (RunProperties, expand_paths,
                                      setup_logfile)


def config_from_args(argv: list[str]) -> PeprConfig:
    rp = RunProperties(argv)
    conf = rp.get("conf")
    if conf:
        rp = RunProperties.load(conf).merged_under(rp)

    track = rp.get("track", "default")
    # every named track in the reference expands the same default
    # property list (PhyloPipeline.getTrackProperties — the *_fast
    # branch's array is immediately overwritten, a reference quirk);
    # we honor the *_fast intent (FastTree full tree) anyway
    known_tracks = ("default", "fast", "blat_fast", "blast_fast",
                    "blat_raxml", "blast_raxml")
    cfg = PeprConfig.default_track() if track in known_tracks \
        else PeprConfig()

    cfg.run_name = rp.get("run_name", cfg.run_name)
    cfg.genome_files = expand_paths(rp.values("genome_file"))
    cfg.outgroup_files = expand_paths(rp.values("outgroup"))
    cfg.outgroup_count = rp.get_int("outgroup_count", cfg.outgroup_count)
    cfg.out_dir = rp.get("out_dir", cfg.out_dir)
    if "checkpoint" in rp:
        cfg.checkpoint_dir = rp.get("checkpoint")
    if "time_budget" in rp:
        cfg.time_budget = rp.get_float("time_budget")
    cfg.refine = rp.get_bool("refine", cfg.refine)
    cfg.refine_cutoff = rp.get_float("refine_cutoff", cfg.refine_cutoff)
    if "min_taxa" in rp:
        cfg.min_taxa = rp.get_int("min_taxa")
    if "max_taxa" in rp:
        cfg.max_taxa = rp.get_int("max_taxa")
    cfg.min_taxa_multiplier = rp.get_float("min_taxa_multiplier",
                                           cfg.min_taxa_multiplier)
    if "target_ntax" in rp:
        cfg.target_sets = rp.get_int("target_ntax")

    hsm = rp.get("homology_search_method")
    if hsm and hsm.lower() not in ("blast", "blat", "false"):
        cfg.stage1.homology_file = hsm
    cfg.stage1.inflation = rp.get_float("mcl_inflation",
                                        cfg.stage1.inflation)
    cfg.stage1.inflation = rp.get_float("inflation", cfg.stage1.inflation)
    cfg.stage1.use_hmm = rp.get_bool("hmm", cfg.stage1.use_hmm)
    cfg.stage1.bidirectional = rp.get_bool("bidirectional",
                                           cfg.stage1.bidirectional)
    cfg.stage1.unique_species = rp.get_bool("unique_species",
                                            cfg.stage1.unique_species)
    cfg.stage2.support_reps = rp.get_int("support_reps",
                                         cfg.stage2.support_reps)
    method = rp.get("tree_method") or rp.get("full_tree_method")
    if method:
        cfg.stage2.full_tree_method = \
            {"ml": "ml", "fasttree": "fast_ml", "nj": "nj",
             "fast_ml": "fast_ml", "parsimony": "parsimony",
             "parsimony_bl": "parsimony_bl"}.get(method.lower(), "ml")
    # nucleotide pipeline (-alphabet nt or -nt): blastn-equivalent
    # homology scores + GTR+Gamma trees (BlastRunner.java:603-706)
    if rp.get("alphabet", "").lower() in ("nt", "dna", "nucleotide") \
            or rp.get_bool("nt", False):
        cfg.alphabet = "nt"
        cfg.stage1.alphabet = "nt"
        cfg.stage2.alphabet = "nt"
    cfg.stage2.congruence_filter = rp.get_bool(
        "congruence_filter", cfg.stage2.congruence_filter)
    # -matrix_eval [true | model,list] (PhylogenomicPipeline2.java:
    # 252-295 role): pick the substitution model by per-site LL of a
    # parsimony tree before building the full tree
    mev = rp.get("matrix_eval", rp.get("matrix_evaluation"))
    if mev is None and ("matrix_eval" in rp or "matrix_evaluation" in rp):
        cfg.stage2.matrix_evaluation = True  # bare flag
    if mev:
        low = mev.lower()
        if low in ("true", "1", "yes"):
            cfg.stage2.matrix_evaluation = True
        elif low not in ("false", "0", "no"):
            cfg.stage2.matrix_evaluation = [m.strip() for m in
                                            mev.split(",") if m.strip()]
    if track.endswith("fast"):
        cfg.stage2.full_tree_method = "fast_ml"
        if track == "fast":
            cfg.stage2.support_reps = min(cfg.stage2.support_reps, 20)
    return cfg


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or "-h" in argv or "--help" in argv:
        print(__doc__)
        return 0
    rp = RunProperties(argv)
    cfg = config_from_args(argv)
    if not cfg.genome_files:
        print("error: -genome_file is required", file=sys.stderr)
        return 2
    # the process group this call makes, it also ends
    joined = not dist.is_initialized() and \
        initialize_distributed(device=rp.get("device"))
    try:
        logfile = rp.get("logfile")
        if logfile and is_writer():
            setup_logfile(logfile)
        result = run_pepr(cfg, device=rp.get("device"))
        if is_writer():
            print(result.newick)
            for suffix, path in result.output_paths.items():
                print(f"wrote {path}", file=sys.stderr)
    finally:
        if joined:
            shutdown_distributed()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
