"""Drive the port's paths once on one NVIDIA H100 and check them: stage
1 with and without the HMM enhancer, stage 2, the tools (per-site
log-likelihoods, the AU test and the six CLIs), the fan-out over ranks
(the mesh, at one NCCL rank and at four Gloo ranks sharing the card),
the reference's own Aquificales and Erysipelotrichi families through
stage 2 against the JAX run's results, and run_pepr, the reference's
default run from genomes to its output files.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line with the elapsed seconds:
  device   nvidia-smi name, power limit and max SM clock, capability (9.x
           required), torch and nvcc versions
  build    nvcc builds every pepr_tpu_torch/csrc/*.cu for sm_90a, one
           process per source side by side, into the git-ignored
           pepr_tpu_torch/_build/; ptxas registers and spills per kernel;
           then g++ builds the native host library
           (pepr_tpu_torch/native/fastio.cpp) there, its seconds printed
  data_stage1   seeded genomes at the shape of the Aquificales example:
           11 ingroup genomes and 1 outgroup-pool genome of ~1,140
           proteins (~1,300 WAG families, lengths lognormal around 306,
           3 families of 2,100-2,600 residues, 100 random proteins each)
  sw_kernel  the SW kernel against its plain PyTorch version on the card:
           up to SW_CHECK_PAIRS real pairs of the stage-1 pair list from
           every length bucket (BLOSUM62 11/1; the plain version once on
           all of them, padded with PAD to the largest bucket, and
           timed), the planted ties of
           planted_tie_pairs (two top cells either side of a strip or
           lane boundary of the kernel's walk, or in one row; query
           lengths 255-257 and 511-513) and one bucket of planted ACGT
           pairs under blastn 5/2; all five outputs must be equal; the
           same pairs embedded in a bucket twice as long on each side
           (more trailing PAD) must give identical outputs; then one
           launch at the main path's batch size for the bucket with the
           most pairs, timed, held against the plain version on the
           same batch; and every bucket at the main path's launches,
           each timed, beside its bound (per_bucket)
  small_stage1  run_stage1 on a small input on the card and on the CPU:
           identical groups and selected outgroups
  stage1   run_stage1 (use_hmm=False, outgroup_count=2) at full size;
           the SW launch count is reset just before and read just after;
           the pool genome must be selected and at least half of the
           families in >= 2 ingroup genomes recovered as clean groups;
           the native library's k-mer profiles of the run's universe and
           components of its hit graph, recorded during the run, against
           their plain versions (profiles equal or at most one float32
           ulp apart, with the rows that differ counted; components
           identical)
  profile_stage1  torch.profiler's device time by kernel over a second
           stage-1 run on the first PROFILE_S1_INGROUP ingroup genomes
           and the pool, so the stage1 time carries no profiler
  small_hmm  run_stage1(use_hmm=True) on a small input on the card and on
           the CPU: identical groups and selected outgroups
  stage1_hmm  run_stage1(use_hmm=True, outgroup_count=2) at the
           Aquificales shape on the pepr_genomes input (a planted clade,
           below); the SW and HMM launch counts are reset just before and
           read just after (the HMM's must be the card plan's, one a
           pack); the pool genome must be selected; the
           enhancer's prefilter pairs, scored pairs by bucket, padded and
           real DP cells and its sub-phase seconds (alignment, prefilter,
           scoring) are printed
  hmm_kernel  the HMM kernel against its plain PyTorch version on the
           stage1_hmm run's own pairs: up to HMM_CHECK_PAIRS a reference
           (lpad, mpad) bucket, Forward and Viterbi, within HMM_ATOL +
           HMM_RTOL (the plain version once a profile pack, on all its
           buckets' pairs at its largest lpad, and timed, plain_by_pack);
           the same batch permuted and with each pair twice must give
           bit-identical scores; every launch of the card's
           plan (one a pack), timed, beside its bound (per_launch), its
           scores identical to the reference buckets' launches'; each
           configuration of each pack (threads a pair) with its
           registers, shared memory and resident warps an SM, timed
           (variants); the kernels line's entry is the card plan's
           largest launch (the widest pack's), its time beside its bound,
           HMM_CHECK_PAIRS of its own scores held against the plain
           version, which is timed on them beside the kernel
  data     the seeded 53-taxon dataset: 405 WAG+Gamma(0.5) families of
           100-250 columns, 64,433 concatenated columns, ~10% of the
           taxa absent from each family
  kernels  each kernel against its plain PyTorch version on the card,
           with times over repeated launches, at the slice shape (4
           trees x 8,192 sites), at the shapes run_stage2_aligned gives
           the kernels on the true alignments: the full tree (1 x 64,433
           sites), a block of 64 jackknife replicates on their
           compacted per-replicate codes (all against the plain
           version), and a batch of SPR candidates scored
           against the full width; and a tree of 8,191 nodes (the
           kernels' limit) on 256 random columns;
           at each shape the nodes in the spill tiers as planned, and the
           spill-record writes and reads the kernel made in one tile of
           each tree (per tree, each must equal the plan's spilled
           nodes), shared memory, resident blocks per SM and registers;
           two gradient launches on the same inputs must be
           bit-identical
  small    run_stage2_aligned on a small input on the card and on the
           CPU (plain path): same topology and supports
  small_align  the profile-profile DP (`nw_profile_batch`) on the card
           against the CPU on dyadic profiles (values k/4, exact in
           float32) at the 128 and 256 buckets: identical scores and
           pointers; release_plans gives back the plans' memory, and with
           the plan cache's share at 0 every shape evicts the last and the
           results stay identical; the DP step's time run eagerly,
           captured as a CUDA graph and replayed; on the last merge wave
           of the stage-2 input's true alignments (each family's rows
           split in two halves) the pointers and scores that differ are
           counted; and
           run_stage2 on seeded 3-sequence families over 6 taxa, card
           against CPU: identical alignments, topology and supports
  stage2   run_stage2 at full width, the `ml` full tree and STAGE2_REPS
           jackknife replicates (cut from the default 100 for time)
           from the 405 families unaligned, each sequence with 0-3 seeded
           deletions of 1-8 residues: filter, progressive MSA, one
           refinement pass, Gblocks trim, then the tree stage; launch
           counts, the MSA tally (DP calls and steps, pointer bytes,
           host seconds in tracebacks and merges, CUDA graphs captured
           and evicted) and the wrapper's planning tally (plans made, host
           seconds copying `children` and planning) are reset just before
           and read just after; the run must have made an SPR sweep and
           released the DP's plans; then path_checks: the final tree's LL
           by the kernel within 1e-5 of the plain path, and both kernels
           against their plain versions at the run's own shapes (its full
           tree over the trimmed columns, its first block of jackknife
           replicates, PLAIN_REP_TREES of them against the plain
           version); the float64 plain LL and gradient are computed too,
           and the kernel's must be within the same tolerances of them
  stage2_options  stage 2's other options (option_runs) on the data
           phase's 53 taxa, the pruning launch counts reset just before
           and read just after: A, run_stage2_aligned on the true
           alignments with the congruence filter (365 of 405 families
           kept), matrix evaluation over every registered model, the
           parsimony_bl full tree and OPTION_REPS nj jackknife replicates;
           B, on A's concatenation, OPTION_REPS fast_ml bootstrap
           replicates, the NJ tree, and a shallow ml_tree under a
           constraint of OPTION_CLADES clades of the generating tree with
           its NNI neighbourhood capped (no bipartition may conflict with
           the constraint, the cap must be logged); C, run_stage2 with the
           nucleotide alphabet (GTR) on NT_FAMILIES seeded JC+Gamma
           families of NT_LENGTH nt over the generating tree, from the
           families unaligned; one Fitch batch of A's NNI candidates
           timed (plain PyTorch, no kernel); then path_checks at A's
           chosen model and at C's GTR model (the float64 LL and gradient
           errors, and the dead states' transition probabilities, which
           must be within DEAD_LEAK_TOL), both kernels on B's bootstrap
           replicates (compacted codes, integer column counts as the
           cotangent), and both kernels at A's full tree under a model
           matrix evaluation did not choose (BLOSUM62F, or WAGF if
           BLOSUM62F won)
  real_data  the reference's own example runs (real_data_phase), read
           from realdata/ (tests/torch_realdata_export.py's export of the
           JAX run's stores: aqu, 673 Aquificales families of 12 taxa,
           185,239 columns; ery, 528 Erysipelotrichi families, 154,086),
           each through run_stage2_aligned at full width under the JAX
           run's stage-2 configuration (ml, seed 12345), with
           REAL_RUNS' replicates (aqu one block of 64, ery none), the
           pruning launch counts reset just before and read just after;
           then real_data_compare against the JAX run: the Gamma shapes
           (within REAL_ALPHA_ATOL), the RF of the full trees over all
           splits and over the JAX splits at least REAL_SPLIT_MIN long,
           the RF to FastTree's tree, the port's LL beside the JAX tree's
           under the port's likelihood (at its own lengths and refitted),
           the first replicates against the JAX run's topology by
           topology and the supports both sets give the JAX tree's
           splits (the port's tree must keep every long JAX split or
           score at least as high, its LL be within REAL_LL_RTOL of the
           JAX run's, and the replicates be the JAX run's topologies
           with its supports); then path_checks (the full tree, and
           aqu's first replicate block)
  tools    the tools on the data phase's 53 taxa (tools_phase): (a)
           per_site_log_likelihoods of 8 trees (the generating tree,
           the stage2 full tree, the NJ tree, TOOLS_NNI NNI neighbours
           of the generating tree, a random topology) over the 64,433
           columns under the CLIs' WAG+Gamma(1), the pruning launch
           counts reset just before and read just after (one forward
           launch); the launch repeated, and each tree launched alone,
           must give its row bit for bit; every row against the plain
           version (FWD_RTOL), each total against a float64 plain one
           (FINAL_LL_RTOL), the launch timed beside its bound; (b)
           au_test on those rows with AU_REPS replicates (cut from the
           CLI's 2,000): the highest-LL tree not rejected, the random
           topology rejected, its host seconds; then on each of the
           first AU_FAMILIES families' columns with the CLI's 2,000: the
           same verdicts, and the multiscale fit run for some tree (an
           AU strictly between 0 and 1); (c) the six CLIs through
           their main(argv) on files in a temporary directory: the
           alignment written as FASTA and phylip must parse back;
           tree_comparison (the stage2 full tree and the random
           topology, -align): its .sitelh within SITELH_TOL of (a)'s
           rows, its RF line compare_trees'; au_test from that .sitelh
           and from the phylip file and the trees (AU_CLI_REPS
           replicates each), identical reports;
           tree_support: decorate_supports' tree on the stage2 full tree
           and its replicates; set_extractor on the stage1 run's groups:
           one file per group with its members; neighbor_masher on the
           first MASH_GENOMES stage1 genomes with the pool genome as the
           outgroup: the pool genome picked, a symmetric distance
           matrix; (d)
           compare_builders (TOOLS_METHODS) on the first TOOLS_COLUMNS
           columns, the launch counts reset and read around it, each
           method's LL within FINAL_LL_RTOL of the plain path's, then
           both kernels at its three trees against their plain versions
  distributed  the mesh (distributed_phase): (a) one NCCL rank in this
           process (initialize_distributed on a 127.0.0.1 coordinator,
           one all_reduce): default_mesh() is (1, 1), sharded_loglik of
           the generating tree over the 64,433 columns bit-identical to
           loglik, sharded_replicate_blopt of DIST_REPS jackknife
           replicates (the stage2 phase's masks, NJ start trees) for 60
           steps bit-identical to replicate_blopt, both timed, and
           support_trees_batched on a small input (DIST_SMALL) at one
           rank; then the group is destroyed; (b) DIST_RANKS ranks that
           share the card over Gloo on CUDA tensors, spawned (run_ranks,
           dist_rank), mesh (2, 2): each rank's total within DIST_LL_RTOL
           of (a)'s, its fit within DIST_BLEN_RTOL (lengths) and
           DIST_RLL_RTOL (LLs) of (a)'s, every rank's arrays identical to
           rank 0's; per rank its seconds, pruning launches and the
           bytes it all-reduced (per Adam step and in all); (c) in the
           same ranks, support_trees_batched on the small input through
           the mesh: every rank's topologies those of (a)'s one rank; (d)
           dryrun_multi(DIST_RANKS, backend="gloo") on the card, and
           entry()'s total equal to loglik's
  pepr    run_pepr with PeprConfig.default_track() (ml full tree,
           PEPR_REPS replicates, refinement) on the pepr_genomes input,
           files written and a checkpoint store kept in a temporary
           directory (the seconds in CheckpointStore.save timed by a
           wrapper the script puts in place); every launch count is
           reset just before and read just after, and every kernel must
           have been launched; at least one refinement round, the six
           output files and the genomes as the tree's leaves are
           required; wall split into stage 1, stage 2, refinement and
           writing; then path_checks on its stage-2 result, as in
           stage2 (stage 1's groups to a tree over the 12 genomes; the
           full tree's gradient also against a float64 plain gradient,
           both float32 sides' errors printed)
  resume   (a) the pepr run's store: files and bytes of the store and
           of each refinement sub-store, the seconds and number of saves,
           and the pepr wall beside it; (b) run_pepr again, the same
           configuration on the finished store: the same Newick, full
           tree, supports and LL, the files of RESUME_FILES byte for byte,
           and no kernel launched (every launch count reset just before
           and read just after); (c) run_stage1(use_hmm=True) and
           run_stage2 (fast_ml, RESUME_REPS replicates) on the small_hmm
           input with a store, once whole, then under Countdown deadlines
           (run out at the n-th poll) until a chain of runs, each
           resuming the last one's store, finishes (`interrupted_runs`):
           the stages that stopped it after saved work are listed, the
           first stop at each of RESUME_STAGES is resumed on a copy of
           the store with no deadline, and each resumed run and the
           chain's end must equal the whole run bit for bit (hits,
           groups, HMM bits, alignments, Newick with lengths, supports,
           LL); alignment slices of RESUME_CHUNK families in all runs
  profile  torch.profiler's device time by kernel over a shallower
           stage-2 run from the true alignments (run_stage2_aligned,
           fast_ml, PROFILE_REPS replicates), so the stage2 time above
           carries no profiler overhead
Then one JSON line with every kernel's numbers (launches from the pepr
run), the nvidia-smi line, and the result line.  Any failure ends the
run with a non-zero exit; without a CUDA device it exits 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import subprocess
import sys
import time

T0 = time.time()

# published peaks of one H100 SXM (dense): float32 outside the tensor
# cores, and HBM bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# int32 lanes of one H100 SXM (132 SMs x 64); the int32 rate is this
# times the SM clock that nvidia-smi reports as clocks.max.sm
INT32_LANES = 132 * 64
# int32 operations of one SW DP cell in the algorithm (not the kernel's
# extra work): E 3 (two subtractions, a max), F 3, the diagonal add 1,
# H 3 (max of four), the row best 1; trackers: E and F select + add 4,
# the diagonal tracker's match test and adds 3, H's tracker selects 2
SW_OPS_PER_CELL = 20

# stage 1 at the shape of the Aquificales example (11 ingroup genomes,
# a 1-genome outgroup pool; ~12,500 ingroup proteins)
S1_INGROUP = 11
S1_POOL = 1
S1_FAMILIES = 1300
S1_RANDOM = 100
# profile_stage1's ingroup genomes: all 11 until the stage2_options
# phase came
PROFILE_S1_INGROUP = 4
# pairs per bucket held against the plain version: 256 until the
# distributed phase came
SW_CHECK_PAIRS = 128
# the same for the HMM kernel (hmm_kernel): 512 until the distributed
# phase came
HMM_CHECK_PAIRS = 256
RECOVERY_FLOOR = 0.5  # a broken path recovers far fewer families

N_TAXA = 53
N_FAMILIES = 405
N_COLUMNS = 64433
KERNEL_SITES = 8192
KERNEL_TREES = 4
SUPPORT_REPS = 100  # the pipeline's default (the kernels phase's block)
# the stage2 phase's replicates: cut from the default 100 to keep the
# script within its 600 s once the pepr phase came (100 took 605.5 s
# on one run), and from 50 to 16 when the stage2_options phase came
STAGE2_REPS = 16
# the profile phase's replicates: 8 until the stage2_options phase came
PROFILE_REPS = 4
# stage2_options: A's nj replicates and B's bootstrap replicates, the
# clades of the generating tree in B's constraint, B's NNI cap (below
# the ~200 moves of a 53-taxon tree), and C's nucleotide families
OPTION_REPS = 16
OPTION_CLADES = 4
OPTION_MAX_CANDIDATES = 64
NT_FAMILIES = 80
NT_LENGTH = (300, 750)
NT_REPS = 8
# int32 operations of one Fitch child combine in the algorithm: the
# intersection, its empty test, the union, the select and the step count
FITCH_OPS_PER_COMBINE = 5
MAX_TREE_TAXA = 4096  # a rooted tree of 8,191 nodes: the kernels' limit
MAX_TREE_SITES = 256
# stage 2 from unaligned families: per sequence 0-3 deleted stretches of
# 1-8 residues (the simulator makes no indels)
DELETIONS = (0, 3)
DELETION_LEN = (1, 8)
ALIGN_CHECK_BATCH = 32  # profile pairs per bucket in small_align
PLAIN_SPR_TREES = 32  # SPR candidates of the batch held against the plain
# version (one every SCORE_BATCH / PLAIN_SPR_TREES)
PLAIN_REP_TREES = 8  # replicates of a path's block held against the plain
# version
# tools: the AU test's replicates on the 8 trees (the CLI's default of
# 2,000 takes ~100 s of host draws and 1 GB of counts a scale at 64,433
# columns) and in the two AU CLI runs, whose reports are compared with
# each other; the families tested one by one (their columns of the same
# rows) and their replicates, the CLI's default; the ingroup genomes
# neighbor_masher sketches beside the pool (all 11 took 8.4-12.8 s of
# host numpy on the card's machine); the columns and methods of
# compare_builders, the NNI neighbours of the generating tree scored,
# the AU test's level, and how far a .sitelh value (six decimals) may
# be from the row it was written from
AU_REPS = 100
AU_CLI_REPS = 20
AU_FAMILIES = 8
AU_FAMILY_REPS = 2000
MASH_GENOMES = 4
TOOLS_COLUMNS = 8192
TOOLS_METHODS = ("fast_ml", "nj", "parsimony_bl")
TOOLS_NNI = 4
AU_LEVEL = 0.05
SITELH_TOL = 1e-6
# real_data: the reference's example runs exported to realdata/
# (tests/torch_realdata_export.py: aqu, 12 Aquificales taxa x 185,239
# columns; ery, 12 Erysipelotrichi taxa x 154,086), each through
# run_stage2_aligned at full width under the JAX run's stage-2
# configuration; the jackknife replicates each run makes (the JAX run
# made 100: aqu one block, ery none, for time); the shortest JAX branch
# whose split the port's tree must keep unless it scores at least as
# high under the port's likelihood (aqu's Hydrogenobaculum splits are
# 6e-8 to 3e-5 long); how far the Gamma shape may be from the JAX run's,
# and the port's LL from the JAX run's, relative (its products were
# bf16x3 on another device).  Two H100 runs read both shapes equal to
# the digit and LLs 2.2e-6 (aqu) and 1.6e-6 (ery) below the JAX run's;
# the replicates must be the JAX run's topologies with its supports
# (both runs: 64 of 64, support difference 0)
REALDATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "realdata")
REAL_RUNS = (("aqu", 64), ("ery", 0))
REAL_SPLIT_MIN = 1e-4
REAL_ALPHA_ATOL = 1e-4
REAL_LL_RTOL = 1e-5
# every depth cut made for the 600 s budget, printed in the stage2_start
# line (PERF.md §4 has the seconds each saved)
CUTS = [f"stage2 support_reps {SUPPORT_REPS} -> 50 (the pepr phase)",
        f"stage2 support_reps 50 -> {STAGE2_REPS} (the stage2_options "
        "phase)",
        f"profile support_reps 8 -> {PROFILE_REPS} (the stage2_options "
        "phase)",
        f"profile_stage1 ingroup {S1_INGROUP} -> {PROFILE_S1_INGROUP} "
        "genomes (the stage2_options phase)",
        "stage2_options C: 80 nucleotide families, not 120 (the same)",
        f"tools au_test reps 2000 -> {AU_REPS}, in the two CLI runs -> "
        f"{AU_CLI_REPS} (the tools phase)",
        f"tools neighbor_masher genomes {S1_INGROUP} -> {MASH_GENOMES} "
        "(the same)",
        f"tools compare_builders columns {N_COLUMNS} -> {TOOLS_COLUMNS} "
        "(the same)",
        f"sw_kernel plain check pairs a bucket 256 -> {SW_CHECK_PAIRS} (the "
        "distributed phase)",
        f"hmm_kernel plain check pairs a bucket 512 -> {HMM_CHECK_PAIRS} "
        "(the same)",
        f"real_data support_reps {SUPPORT_REPS} -> {dict(REAL_RUNS)['aqu']} "
        f"(aqu) and -> {dict(REAL_RUNS)['ery']} (ery) (the real_data phase)"]
# distributed: the ranks that share the card in (b)-(d), the replicates
# and Adam steps of the fits of (a) and (b) (STAGE2_REPS jackknife masks,
# the support path's steps), the small support input of (c) (taxa,
# families, replicates) and the tolerances against one rank: totals
# (site slices summed in another order), and the fits' lengths and LLs
# (those of tests/test_torch_support.py::test_replicate_blopt_matches_sharded)
DIST_RANKS = 4
DIST_REPS = STAGE2_REPS
DIST_STEPS = 60
DIST_SMALL = dict(taxa=12, families=8, reps=8)
DIST_LL_RTOL = 1e-6
DIST_BLEN_RTOL = 1e-3
DIST_RLL_RTOL = 1e-5
DIST_TIMEOUT = 300.0
FINAL_LL_RTOL = 1e-5  # a path's final LL, kernel against the plain path
# and against the float64 plain LL
# largest transition probability allowed between a dead state (pi <=
# 1e-6, nucleotide GTR's 16) and a live one: below it a dead state's
# internal partial stays under 1e-9 of the live ones' largest at every
# node, so it can never set a shared rescale
DEAD_LEAK_TOL = 1e-9
FWD_RTOL = 1e-5  # per-site LL, elementwise (plus 1e-5 absolute)
BWD_RTOL = 1e-4  # gradient, max |diff| over max |ref| (summation order)

# the HMM kernel: special-function (MUFU) results of one real DP cell of
# Plan7 Forward, the least the function needs: the match state's
# logaddexp2 of four terms is one max, three exp2 (the max's own term is
# 1) and one log2 (4), the insert's and the delete's two-term ones an
# exp2 and a log2 each (2 + 2), and the total one exp2 (1); the
# reference's pairwise form takes 11 (three two-term logaddexp2s for the
# match state), and shares are printed at both; csrc/hmm.cu spends 13
# (the pairwise form, and its lane-parallel delete chain is composed and
# then applied: a logaddexp2 more); the card's rate is MUFU_PER_SM_CLOCK
# results a clock on each of SMS SMs at the SM clock
HMM_MUFU_PER_CELL = 9
HMM_MUFU_PER_CELL_PAIRWISE = 11
SMS = 132
MUFU_PER_SM_CLOCK = 16
HMM_FLOATS_PER_COLUMN = 27  # a profile column: 20 emissions, 7 transitions
# kernel against plain, bits: sums in another order (per-thread online
# log-sum-exp2 against per-row sums, a thread-blocked delete chain
# against the Kogge-Stone doubling) and the MUFU's approximate exp2 and
# log2, over up to 4,096 x 4,096 cells
HMM_ATOL = 1e-3
HMM_RTOL = 1e-5
# small_hmm: proteins under 128 residues score below the pipeline's 144
# bits (the reference's -E 1e-40 at ~3k-protein genomes)
SMALL_HMM_MIN_BITS = 40.0
# pepr: the internal branches of the planted clade (pepr_genomes)
PEPR_CLADE_BRANCH = 2e-5
PEPR_REPS = 100  # the default track's replicates
PEPR_CUTS: list[str] = []  # depth cut from the default track (none)
PEPR_FILES = (".nwk", "_final_rooted.nwk", "_final_rooted.json", ".sup",
              ".hs", ".clp", ".report.xml")
# resume: the files a second run on the pepr run's finished store must
# write byte for byte (all but the report, which holds wall seconds)
RESUME_FILES = (".nwk", "_final_rooted.nwk", "_final_rooted.json", ".sup",
                ".hs", ".clp")
# resume (c): fast_ml replicates, families per alignment slice (so the
# small input's ~40 groups take several slices, in every run of the
# phase alike), the stages an interruption must have named, each
# resumed once from its first interruption, and a cap on the runs
RESUME_REPS = 8
RESUME_CHUNK = 8
RESUME_STAGES = ("homology SW", "profile HMM scoring", "family alignment",
                 "full-tree NNI", "support BL-opt")
RESUME_MAX_RUNS = 400


def phase(label: str, **info) -> None:
    print(json.dumps({"phase": label,
                      "elapsed_s": round(time.time() - T0, 3), **info}),
          flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


class Countdown:
    """A `Deadline` that runs out at its n-th poll: `expired` and
    `near` count as polls and report True from the n-th on, `remaining`
    is 0 from then on and a large number before; `t_end` is set, so a
    refinement sub-run is handed this countdown too."""

    def __init__(self, n: int):
        self.n, self.polls, self.t_end = n, 0, float("inf")

    def _poll(self) -> bool:
        self.polls += 1
        return self.polls >= self.n

    @property
    def expired(self) -> bool:
        return self._poll()

    def near(self, margin: float) -> bool:
        return self._poll()

    def remaining(self) -> float:
        return 0.0 if self.polls >= self.n else 1e9


def store_digest(root: str) -> str:
    """sha256 over a store's file names and contents, sub-stores
    included ("" if there is no store yet)."""
    import hashlib
    if not os.path.isdir(root):
        return ""
    h = hashlib.sha256()
    for d, dirs, files in sorted(os.walk(root)):
        dirs.sort()
        for f in sorted(files):
            h.update(os.path.relpath(os.path.join(d, f), root).encode())
            with open(os.path.join(d, f), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


def store_files(root: str) -> dict:
    """{store or sub-store: [files, bytes]} of a checkpoint directory."""
    out: dict = {}
    for d, _, files in os.walk(root):
        rel = os.path.relpath(d, root)
        out[rel] = [len(files), sum(os.path.getsize(os.path.join(d, f))
                                    for f in files)]
    return dict(sorted(out.items()))


def interrupted_runs(run, root: str, on_stop=None, restart: bool = False,
                     max_runs: int = RESUME_MAX_RUNS):
    """Run `run(deadline)` against the store at `root` under
    Countdown(c) until it finishes; returns (its result, the stages
    that stopped it, the number of runs).  c starts at 1; a stop that
    changed nothing in the store (a poll replayed from it, or one right
    after another stop) counts no stage and moves c one poll on; a stop
    that saved new work is counted, handed to on_stop(stage), and with
    `restart` sets c back to 1 (every poll that follows saved work),
    else keeps it."""
    from pepr_tpu_torch.pipeline.checkpoint import Incomplete
    c, stages = 1, []
    for n in range(1, max_runs + 1):
        before = store_digest(root)
        try:
            return run(Countdown(c)), stages, n
        except Incomplete as e:
            if store_digest(root) == before:
                c += 1
                continue
            stages.append(e.stage)
            if on_stop is not None:
                on_stop(e.stage)
            if restart:
                c = 1
    fail(f"the run did not finish in {max_runs} interrupted runs")


def smi_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def sw_bound(real_cells: int, code_bytes: int, n_pairs: int,
             sm_clock_mhz: float):
    """Least time (ms) for SW on a batch: its int32 operations (the real
    cells the pairs need) over the int32 rate, or its bytes (codes in,
    the substitution table in, 20 bytes out per pair) over HBM
    bandwidth; returns (ms, bound_by)."""
    t_ops = real_cells * SW_OPS_PER_CELL / (INT32_LANES * sm_clock_mhz * 1e6)
    t_bytes = (code_bytes + 25 * 25 * 4 + 20 * n_pairs) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def family_key(title: str) -> str:
    """famNNNN for a family member; the whole title for a random
    protein (each is a family of its own)."""
    head = title.split("_")[0]
    return head if head.startswith("fam") else title


def family_recovery(hg_sets, ingroup) -> tuple[int, int]:
    """(recovered, eligible): families present in >= 2 ingroup genomes,
    and those of them for which one group holds >= 90% of their ingroup
    members and no ingroup member of another family."""
    members: dict[str, set] = {}
    for g in ingroup:
        for t in g.titles:
            members.setdefault(family_key(t), set()).add(t)
    eligible = {f: m for f, m in members.items()
                if f.startswith("fam") and len(m) >= 2}
    recovered = set()
    for s in hg_sets:
        own = [t for t in s.titles if family_key(t) in members
               and t in members[family_key(t)]]
        keys = {family_key(t) for t in own}
        if len(keys) == 1:
            f = keys.pop()
            if f in eligible and len(own) >= 0.9 * len(eligible[f]):
                recovered.add(f)
    return len(recovered), len(eligible)


def planted_nt_pairs(rng, n: int, lq: int, lt: int):
    """(n, lq) and (n, lt) int8 ACGT codes: each query is a mutated,
    gapped copy of a piece of its target, PAD-filled past random real
    lengths."""
    import numpy as np
    q = np.full((n, lq), 24, np.int8)
    t = np.full((n, lt), 24, np.int8)
    for b in range(n):
        nt_ = int(rng.integers(lt // 2, lt + 1))
        t[b, :nt_] = rng.integers(0, 4, nt_)
        nq = int(rng.integers(lq // 2, min(lq, nt_) + 1))
        start = int(rng.integers(0, nt_ - nq + 1))
        piece = t[b, start:start + nq].copy()
        mut = rng.random(nq) < 0.1
        piece[mut] = rng.integers(0, 4, int(mut.sum()))
        keep = rng.random(nq) >= 0.03  # deletions
        piece = piece[keep]
        q[b, :len(piece)] = piece
    return q, t


def nt_families(tree, lengths, rng, absent: float = 0.1, min_taxa: int = 4,
                alpha: float = 0.5):
    """Nucleotide families evolved down `tree` under Jukes-Cantor with
    Gamma(`alpha`) site rates: on a branch of length t a site of rate r is
    redrawn uniformly from ACGT with probability 1 - exp(-4 r t / 3),
    which is JC's transition matrix.  One (name, taxa, codes) triple per
    entry of `lengths`, each family missing a random ~`absent` share of
    the taxa (at least `min_taxa` stay), as `simulate_families` does for
    proteins."""
    import math
    import numpy as np
    leaves = tree.leaves()
    taxa = [tree.labels[i] for i in leaves]
    fams = []
    for g, length in enumerate(lengths):
        rates = rng.gamma(alpha, 1.0 / alpha, size=int(length))
        states = {tree.root: rng.integers(0, 4, int(length)).astype(np.int8)}
        for node in tree.preorder():
            if node == tree.root:
                continue
            t = tree.blen[node]
            t = 0.1 if math.isnan(t) else float(t)
            cur = states[tree.parent[node]].copy()
            hit = rng.random(int(length)) < 1.0 - np.exp(-4.0 * rates * t
                                                          / 3.0)
            cur[hit] = rng.integers(0, 4, int(hit.sum()))
            states[node] = cur
        keep = rng.random(len(taxa)) >= absent
        if keep.sum() < min_taxa:
            keep[rng.choice(len(taxa), size=min_taxa, replace=False)] = True
        idx = np.nonzero(keep)[0]
        fams.append((f"ntfam{g:04d}", [taxa[i] for i in idx],
                     np.stack([states[leaves[i]] for i in idx])))
    return fams


# The planted tie of tests/test_torch_sw_ties.py (AA_ORDER codes): motif
# X scores 105 against itself over 10 identical residues, motif Z (27 A)
# 105 against a copy with one A -> S over 27 columns.  The query's
# filler I and the target's filler P score below 0 against every residue
# of the other side.
TIE_X = [17] * 8 + [4, 8]
TIE_ZQ = [0] * 27
TIE_ZT = [0] * 13 + [15] + [0] * 13
TIE_QFILL, TIE_TFILL = 9, 14
# query lengths 32 R - 1, 32 R and 32 R + 1 for strips of R = 8 and
# 16 rows a lane (the kernel takes 8 at most: one strip, then two)
TIE_LENGTHS = (255, 256, 257, 511, 512, 513)


def planted_tie_pairs(lengths=TIE_LENGTHS, lt: int = 100):
    """(query, target) int8 code arrays with two top cells of score 105,
    placed against the SW kernel's walk (`ops/sw.strip_layout`) for
    each query length: the two cells in the rows either side of the
    first strip boundary (of the middle lane boundary when the query
    takes one strip), X's first and then Z's first; and one query row
    ending X against two copies of X in the target (the same row at two
    columns)."""
    import numpy as np
    from pepr_tpu_torch.ops.sw import WARP, strip_layout

    def fill(x, n, code):
        return np.array(x + [code] * (n - len(x)), np.int8)

    pairs = []
    for L in lengths:
        n, rows = strip_layout(L)
        b = WARP * rows if n > 1 else rows * (WARP // 2)
        # the target holds the motifs in the other order, so that no
        # alignment joins them
        for first, second, t in ((TIE_X, TIE_ZQ, TIE_ZT + [TIE_TFILL] * 20
                                  + TIE_X),
                                 (TIE_ZQ, TIE_X, TIE_X + [TIE_TFILL] * 20
                                  + TIE_ZT)):
            q = [TIE_QFILL] * (b - len(first)) + first + second
            pairs.append((fill(q, L, TIE_QFILL), fill(t, lt, TIE_TFILL)))
        q = [TIE_QFILL] * (b - len(TIE_X)) + TIE_X
        t2 = [TIE_TFILL] * 5 + TIE_X + [TIE_TFILL] * 30 + TIE_X
        pairs.append((fill(q, L, TIE_QFILL), fill(t2, lt, TIE_TFILL)))
    return pairs


def padded(pairs, lq: int, lt: int):
    """(B, lq) and (B, lt) int8 codes of (query, target) pairs,
    PAD-filled."""
    import numpy as np
    q = np.full((len(pairs), lq), 24, np.int8)
    t = np.full((len(pairs), lt), 24, np.int8)
    for b, (x, y) in enumerate(pairs):
        q[b, :len(x)], t[b, :len(y)] = x, y
    return q, t


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median per-call milliseconds over `reps` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def family_lengths(rng):
    """405 lengths in [100, 250] summing to 64,433."""
    import numpy as np
    extra = rng.multinomial(N_COLUMNS - 100 * N_FAMILIES,
                            np.full(N_FAMILIES, 1.0 / N_FAMILIES))
    if extra.max() > 150:
        fail("family length draw out of range")
    return 100 + extra


def deletion_keep(n: int, rng):
    """(n,) bool: the residues of a length-n sequence left after DELETIONS
    seeded deletions of DELETION_LEN residues each."""
    import numpy as np
    keep = np.ones(n, bool)
    for _ in range(int(rng.integers(DELETIONS[0], DELETIONS[1] + 1))):
        d = int(rng.integers(DELETION_LEN[0], DELETION_LEN[1] + 1))
        s = int(rng.integers(0, max(n - d, 0) + 1))
        keep[s:s + d] = False
    return keep


def unaligned_families(fams, rng):
    """Simulated (name, taxa, codes) families as run_stage2's input:
    (homolog groups, true alignments).  Each sequence loses its seeded
    deletions, which become gaps in the true alignment; titles carry the
    taxon in brackets, as a homolog group's FASTA titles do."""
    import numpy as np
    from pepr_tpu_torch.alphabet import GAP
    from pepr_tpu_torch.io.fasta import SequenceSet
    from pepr_tpu_torch.models.msa import Alignment
    sets, true = [], []
    for name, taxa, codes in fams:
        keep = np.stack([deletion_keep(codes.shape[1], rng) for _ in taxa])
        sets.append(SequenceSet(name, [f"{name}_{t} [{t}]" for t in taxa],
                                [row[k] for row, k in zip(codes, keep)]))
        true.append(Alignment(name, list(taxa),
                              np.where(keep, codes, GAP).astype(np.int8)))
    return sets, true


# run_stage2 card against CPU (and, in the tests, against the JAX
# package): 3-sequence families over 6 taxa
SMALL_S2 = dict(min_taxa=3, full_tree_method="fast_ml", support_reps=3,
                nni_rounds=2, seed=7)


def three_sequence_sets(rng, n_families: int = 12, alphabet: str = "aa"):
    """`n_families` homolog groups of 3 sequences each, drawn from 6 taxa
    and evolved down one random tree (proteins under WAG, or nucleotides
    under `nt_families`' JC for `alphabet="nt"`), with seeded
    deletions."""
    from pepr_tpu_torch.utils.simulate import random_tree, simulate_families
    taxa = [f"T{i}" for i in range(6)]
    tree = random_tree(taxa, rng, scale=0.1)
    make = nt_families if alphabet == "nt" else simulate_families
    fams = make(tree, rng.integers(80, 160, size=n_families), rng,
                alpha=0.5, absent=0.5, min_taxa=3)
    fams = [(n, t[:3], c[:3]) for n, t, c in fams]
    return unaligned_families(fams, rng)[0]


def dyadic_profiles(rng, B: int, L: int):
    """(B, L, 20) float32 profiles of four draws a column (values k/4, a
    draw of code >= 20 adds no mass, as a gap), zero past random lengths
    in [L/2, L); and the (B,) lengths."""
    import numpy as np
    lens = rng.integers(L // 2, L, size=B).astype(np.int32)
    p = np.zeros((B, L, 20), np.float32)
    for b, n in enumerate(lens):
        draws = rng.integers(0, 24, size=(n, 4))
        for c in range(4):
            hit = draws[:, c] < 20
            np.add.at(p[b], (np.nonzero(hit)[0], draws[hit, c]), 0.25)
    return p, lens


def last_merge_wave(true_alns):
    """The last merge of each family's true alignment, as one wave: each
    family's rows split in two halves, columns all-gap in a half
    dropped, a profile per half; {(L1, L2): (p1, l1, p2, l2)} bucketed
    and padded as `align_families` buckets a wave."""
    import numpy as np
    from pepr_tpu_torch.alphabet import GAP
    from pepr_tpu_torch.models.msa import MIN_BUCKET, _pad_profiles, _profile
    pairs: dict = {}
    for a in true_alns:
        h = a.mat.shape[0] // 2
        prof = [_profile(m[:, (m != GAP).any(axis=0)])
                for m in (a.mat[:h], a.mat[h:])]
        key = tuple(max(MIN_BUCKET,
                        1 << int(np.ceil(np.log2(max(len(x), 1)))))
                    for x in prof)
        pairs.setdefault(key, []).append(prof)
    return {k: (*_pad_profiles([x[0] for x in v], k[0]),
                *_pad_profiles([x[1] for x in v], k[1]))
            for k, v in pairs.items()}


def edge_counts(children, n_leaves):
    """(internal-child edges, leaf edges) of a kernel children array."""
    kids = children[children >= 0]
    return int((kids >= n_leaves).sum()), int((kids < n_leaves).sum())


def kernel_bounds(B, n_leaves, n_int, L, C, children, code_bytes):
    """Least time (ms) the card could take for each kernel's work, from
    the bytes each must move (inputs once, outputs once) and the FLOPs
    its algorithm needs on these inputs; returns {name: (ms, by)}."""
    V = n_leaves + n_int
    e_int, e_leaf = edge_counts(children, n_leaves)
    in_bytes = code_bytes + B * n_int * 3 * 4 + B * C * V * 400 * 4 + 80
    # forward: P . D for internal children (2*400 per state vector),
    # a column gather for leaves, the 20-state product per edge
    f_fwd = B * C * L * (800 * e_int + 20 * (e_int + e_leaf))
    b_fwd = in_bytes + B * L * 4
    # backward: forward recompute, child messages and upper-message
    # pushes (P^T) for internal children, outer products for internal
    # edges, a 20-value scatter for leaf edges
    f_bwd = f_fwd + B * C * L * (2 * 800 * e_int + 20 * e_leaf)
    b_bwd = in_bytes + B * L * 4 + B * C * V * 400 * 4
    out = {}
    for name, f, b in (("pruning_fwd", f_fwd, b_fwd),
                       ("pruning_bwd", f_bwd, b_bwd)):
        t_ops, t_bytes = f / PEAK_F32_FLOPS, b / PEAK_BYTES
        out[name] = (1e3 * max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def timed(fn):
    """(fn(), milliseconds) for one call, by CUDA events."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def launch_facts(kernel: str) -> dict:
    """The plan and grid of a wrapper's last launch: nodes in the spill
    tiers (planned, and the spill-record writes and reads the kernel
    counted in one tile of each tree: each spilled node's partial and
    upper message is written once and read once, so per tree they must
    equal the plan's spilled nodes), shared memory, resident blocks per
    SM and registers."""
    import torch
    from pepr_tpu_torch.ops import pruning
    last = pruning.LAST[kernel]
    plan = last["plan"]
    want_f = (plan[:, :-1, 3] < 0).sum(dim=1)
    want_u = (plan[:, :-1, 7] < 0).sum(dim=1)
    got = last["kernel_spills"].long()
    want = torch.stack([want_f, want_f, want_u, want_u], dim=1)
    counted = got.sum(dim=0).tolist()
    if not torch.equal(got, want):
        bad = int((got != want).any(dim=1).nonzero()[0])
        fail(f"{kernel}: tree {bad}: the kernel counted spill-tier writes "
             f"and reads {got[bad].tolist()}, the plan spills "
             f"{want[bad].tolist()}")
    kind = 0 if kernel == "pruning_fwd" else 1
    return dict(
        registers=pruning.library().pruning_num_regs(kind),
        smem_bytes=last["smem_bytes"], blocks_per_sm=last["blocks_per_sm"],
        blocks_per_tree=last["n_chunks"],
        slots=dict(forward=last["slots_f"], upper=last["slots_u"]),
        spill_tier=dict(forward_nodes=last["spilled_f"],
                        upper_nodes=last["spilled_u"],
                        kernel_writes_reads=counted))


def check_kernels(codes, ch, pm, pi, ct, *, grad=True, plain_trees=None,
                  reps=5, wide=False):
    """Both wrappers (the gradient only if `grad`) against their plain
    versions on the same card tensors, tree by tree for the plain side
    (`plain_trees`: the trees held against it, default all); returns
    {kernel: numbers} and fails the run beyond tolerance, on spill counts
    that disagree, or on two gradient launches that differ in any bit.
    With `wide`, the plain gradient is also computed in float64 on the
    card and both float32 sides' max-normalised errors against it are
    reported (`float64_check`); the kernel's must be within BWD_RTOL."""
    import torch
    from pepr_tpu_torch.ops import pruning

    B, n_int = ch.shape[:2]
    L = codes.shape[-1]
    trees = list(range(B)) if plain_trees is None else list(plain_trees)

    def one(b):
        return codes if codes.dim() == 2 else codes[b:b + 1]

    def plain_fwd():
        return torch.cat([pruning.site_ll_reference(
            one(b), ch[b:b + 1], pm[b:b + 1], pi) for b in trees])

    def plain_bwd(g_k):
        with torch.no_grad():
            d_max = r_max = 0.0
            for b in trees:
                g_r = pruning.site_ll_grad_reference(
                    one(b), ch[b:b + 1], pm[b:b + 1], pi, ct[b:b + 1])
                d_max = max(d_max, float((g_k[b] - g_r[0]).abs().max()))
                r_max = max(r_max, float(g_r.abs().max()))
                del g_r
            return d_max, r_max

    def float64_errors(g_k):
        """Max |float32 - float64| over max |float64| of the kernel and
        of the plain float32 gradient, tree by tree."""
        err_k = err_p = ref = 0.0
        with torch.no_grad():
            for b in trees:
                g_w = pruning.site_ll_grad_reference(
                    one(b), ch[b:b + 1], pm[b:b + 1].double(), pi.double(),
                    ct[b:b + 1].double())[0]
                g_r = pruning.site_ll_grad_reference(
                    one(b), ch[b:b + 1], pm[b:b + 1], pi, ct[b:b + 1])[0]
                err_k = max(err_k, float((g_k[b].double() - g_w).abs().max()))
                err_p = max(err_p, float((g_r.double() - g_w).abs().max()))
                ref = max(ref, float(g_w.abs().max()))
                del g_w, g_r
        return dict(kernel_vs_float64=err_k / ref,
                    plain_float32_vs_float64=err_p / ref, tol=BWD_RTOL)

    bounds = kernel_bounds(B, codes.shape[-2], n_int, L, pm.shape[1],
                           ch[0].cpu().numpy(), codes.numel())
    ll_k = pruning.pruning_fwd(codes, ch, pm, pi)
    torch.cuda.synchronize()
    facts = launch_facts("pruning_fwd")
    with torch.no_grad():
        ll_r, plain_ms = timed(plain_fwd)
    d = (ll_k[trees] - ll_r).abs()
    out = {"pruning_fwd": dict(
        max_abs_err=float(d.max()),
        max_rel_err=float((d / (ll_r.abs() + 1.0)).max()), tol=FWD_RTOL,
        ms=time_ms(lambda: pruning.pruning_fwd(codes, ch, pm, pi), reps),
        plain_ms=plain_ms, plain_trees=len(trees), **facts)}
    ok = bool(torch.isfinite(ll_k).all()) and bool(
        (d <= FWD_RTOL * ll_r.abs() + 1e-5).all())
    del ll_k, ll_r, d
    if not ok:
        fail(f"pruning_fwd disagrees with its plain version: "
             f"{out['pruning_fwd']}")
    if grad:
        g_k = pruning.pruning_bwd(codes, ch, pm, pi, ct)
        torch.cuda.synchronize()
        facts = launch_facts("pruning_bwd")
        same = bool(torch.equal(g_k, pruning.pruning_bwd(codes, ch, pm, pi,
                                                         ct)))
        (d_max, r_max), plain_ms = timed(lambda: plain_bwd(g_k))
        out["pruning_bwd"] = dict(
            max_abs_err=d_max, max_rel_err=d_max / r_max, tol=BWD_RTOL,
            ms=time_ms(lambda: pruning.pruning_bwd(codes, ch, pm, pi, ct),
                       reps),
            plain_ms=plain_ms, plain_trees=len(trees),
            bit_identical_relaunch=same, **facts)
        ok = bool(torch.isfinite(g_k).all()) and d_max / r_max <= BWD_RTOL
        if wide:
            wide_err = float64_errors(g_k)
            out["pruning_bwd"]["float64_check"] = wide_err
            ok = ok and wide_err["kernel_vs_float64"] <= BWD_RTOL
        del g_k
        if not ok:
            fail(f"pruning_bwd disagrees with its plain version or with "
                 f"float64: {out['pruning_bwd']}")
        if not same:
            fail("two pruning_bwd launches on the same inputs differ")
    for k, v in out.items():
        v["bound_ms"], v["bound_by"] = bounds[k]
    torch.cuda.empty_cache()
    return out


def tree_tensors(trees, taxa, model, dev):
    """(children, transition matrices) of `trees` under `model` on
    `dev`, as the kernels take them."""
    import numpy as np
    import torch
    from pepr_tpu_torch.ops.likelihood import (transition_matrices,
                                               tree_to_arrays)
    arrs = [tree_to_arrays(tr, taxa) for tr in trees]
    ch = torch.as_tensor(np.stack([a.children for a in arrs]), device=dev)
    blen = torch.as_tensor(np.stack([a.blen for a in arrs]), device=dev)
    return ch, transition_matrices(model, blen).contiguous()


def replicate_block(cat, trees, weights, model, dev) -> tuple:
    """The first block of a path's replicates as `replicate_blopt` gives
    it to the kernels: the codes compacted to each replicate's live
    columns, its site weights (jackknife 0/1 masks or bootstrap column
    counts) as the cotangent, its trees under `model`.  Returns (codes,
    weights, children, transition matrices)."""
    from pepr_tpu_torch.parallel.replicates import BLOCK_REPS, replicate_codes
    codes_r, w_r = replicate_codes(cat.mat, weights[:BLOCK_REPS], dev)
    ch, pm = tree_tensors(trees[:w_r.shape[0]], cat.taxa, model, dev)
    return codes_r, w_r, ch, pm


def block_check(codes_r, w_r, ch, pm, pi, length: int) -> dict:
    """check_kernels on a replicate block, PLAIN_REP_TREES of its trees
    against the plain version, with the weights' largest count and the
    share of the `length` columns of the concatenation live in a
    replicate."""
    n_rep = w_r.shape[0]
    return dict(
        trees=n_rep, sites=codes_r.shape[-1],
        codes="per-replicate" if codes_r.dim() == 3 else "shared",
        weight_max=float(w_r.max()),
        live_share=float((w_r > 0).sum()) / (n_rep * length),
        **check_kernels(codes_r, ch, pm, pi, w_r, reps=3, plain_trees=range(
            0, n_rep, max(1, n_rep // PLAIN_REP_TREES))))


def path_checks(res, reps: int, seed: int, dev, model=None) -> dict:
    """The kernels at the shapes a run_stage2 run gave them, each against
    its plain version (check_kernels): the run's full tree over its
    trimmed concatenation, and the first block of its jackknife
    replicates (its own support trees; none when `reps` is 0) on their
    compacted codes, under the run's model (`model`, default WAG+Gamma
    at the run's shape); the full tree's LL by the kernel against the
    plain path, and both against
    a float64 plain LL (the kernel's within FINAL_LL_RTOL of each).  For
    a model with dead states (nucleotide GTR: pi = 1e-10 outside ACGT)
    the largest transition probability between a dead and a live state
    (`dead_state_leak`) must be within DEAD_LEAK_TOL.  Called after the
    run's launch counts are read."""
    import numpy as np
    import torch
    from pepr_tpu_torch.models.support import jackknife_gene_masks
    from pepr_tpu_torch.ops import pruning
    from pepr_tpu_torch.ops.likelihood import (WagModel, loglik,
                                               tree_to_arrays)
    cat = res.concat
    if model is None:
        model = WagModel.create(alpha=res.gamma_alpha)
    pi = torch.as_tensor(model.pi, device=dev)

    arr = tree_to_arrays(res.full_tree, cat.taxa)
    ch, pm = tree_tensors([res.full_tree], cat.taxa, model, dev)
    codes = torch.as_tensor(cat.mat, device=dev)
    ll_kernel = loglik(cat.mat, arr.children, arr.blen, model, device=dev)
    with torch.no_grad():
        ll_plain = float(pruning.site_ll_reference(codes, ch, pm, pi)
                         .double().sum())
        ll_wide = float(pruning.site_ll_reference(
            codes, ch, pm.double(), pi.double()).sum())
    ll_rel = abs(ll_kernel - ll_plain) / abs(ll_plain)
    ll_rel_wide = abs(ll_kernel - ll_wide) / abs(ll_wide)
    if not np.isfinite(ll_kernel) or not ll_rel <= FINAL_LL_RTOL \
            or not ll_rel_wide <= FINAL_LL_RTOL:
        fail(f"final log-likelihood {ll_kernel} is not finite or disagrees "
             f"with the plain path's {ll_plain} or the float64 one's "
             f"{ll_wide}")
    out = dict(final_ll_kernel=ll_kernel, final_ll_plain=ll_plain,
               final_ll_float64=ll_wide,
               final_ll_rel_vs_float64=dict(
                   kernel=ll_rel_wide,
                   plain=abs(ll_plain - ll_wide) / abs(ll_wide)),
               final_ll_rel=ll_rel)
    dead = pi <= 1e-6
    if bool(dead.any()):
        live = ~dead
        leak = float(torch.maximum(
            pm[..., dead, :][..., live].abs().max(),
            pm[..., live, :][..., dead].abs().max()))
        out["dead_state_leak"] = leak
        if not leak <= DEAD_LEAK_TOL:
            fail(f"a dead state's transition probability to a live one is "
                 f"{leak}, above {DEAD_LEAK_TOL}")
    shapes = {"full_tree": dict(
        trees=1, sites=cat.length, codes="shared",
        **check_kernels(codes, ch, pm, pi,
                        torch.ones((1, cat.length), device=dev), wide=True))}
    del codes, ch, pm
    if reps:
        block = replicate_block(cat, res.support_trees,
                                jackknife_gene_masks(cat, reps, seed), model,
                                dev)
        shapes["replicate_block"] = block_check(*block, pi, cat.length)
        del block
    torch.cuda.empty_cache()
    return dict(out, kernel_shapes=shapes)


def device_time(prof, wall: float) -> dict:
    """Device time by kernel name from a torch.profiler run, and the
    device's busy share of the wall time.  The profiles record the CUDA
    activity alone: host operators' events add nothing read here and take
    seconds to collect."""
    by_name = {}
    for ev in prof.key_averages():
        # device-side events only (kernels, copies); host ops report the
        # device time of what they launched, which would count it twice
        if str(getattr(ev, "device_type", "")).split(".")[-1] != "CUDA":
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            by_name[ev.key] = (us / 1e6, ev.count)
    device_s = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return dict(wall_s=round(wall, 3), device_s=round(device_s, 3),
                device_busy_share=round(device_s / wall, 4),
                top=[dict(name=k[:60], seconds=round(v[0], 4), calls=v[1])
                     for k, v in top])


class _Messages(logging.Handler):
    """Collects the port's log messages (search progress)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def stage1_genomes(seed: int):
    """The stage-1 input at the Aquificales shape: (ingroup, pool,
    generating tree)."""
    import numpy as np
    from pepr_tpu_torch.utils.simulate import simulate_genomes
    return simulate_genomes(
        np.random.default_rng(seed + 10), n_ingroup=S1_INGROUP,
        n_pool=S1_POOL, n_families=S1_FAMILIES, n_random=S1_RANDOM)


def stage1_pair_list(ingroup, dev):
    """The SW pair list of stage 1's all-vs-all search: (pairs_q, real
    lengths, eff_q, eff_t, buckets, the codes packed on `dev`), as
    `search_all_vs_all` and `_bucketed_sw` build them."""
    import numpy as np
    from pepr_tpu_torch.models.homology import (ProteinUniverse,
                                                candidate_union, pack_codes,
                                                sw_buckets)
    universe = ProteinUniverse.build(ingroup)
    pairs_q, pairs_t = candidate_union(universe, device=dev)
    eff_q, eff_t, buckets = sw_buckets(universe.lengths, pairs_q, pairs_t)
    return (pairs_q, universe.lengths.astype(np.int64), eff_q, eff_t,
            buckets, pack_codes(universe.seqs, device=dev))


def sw_bucket_table(ulens, eff_q, eff_t, buckets, codes, sub, dev,
                    sm_clock_mhz: float, reps: int = 3) -> dict:
    """Every bucket of a pair list cut into launches as the main path
    cuts it (`models/homology._bucketed_sw`: a bucket's pairs sorted by
    real cells, largest first, then batches of `batch_pairs`), each
    launch timed (median of `reps` CUDA-event timings after one
    warm-up).  Per bucket: pairs, launches, real and padded cells, ms
    (summed over its launches), ms per launch, the bound, real GCUPS and
    the bound's share of the time; and the totals.  Uses only what the
    port has had since the SW kernel came, so that `chip_turns.py` can
    time an earlier checkout's kernel on the same launches."""
    import numpy as np
    import torch
    from pepr_tpu_torch.models.homology import batch_pairs
    from pepr_tpu_torch.ops import sw

    rows = []
    for (blq, blt), idx in buckets.items():
        cells = ulens[eff_q[idx]] * ulens[eff_t[idx]]
        idx = idx[np.argsort(-cells, kind="stable")]
        step = batch_pairs(blq, blt, dev)
        ms = 0.0
        for s0 in range(0, len(idx), step):
            sel = idx[s0:s0 + step]
            q = codes[torch.as_tensor(eff_q[sel], device=dev), :blq]
            t = codes[torch.as_tensor(eff_t[sel], device=dev), :blt]
            ms += time_ms(lambda: sw.sw_align(q, t, sub), reps)
        launches = -(-len(idx) // step)
        real = int(cells.sum())
        bound_ms, _ = sw_bound(real, len(idx) * (blq + blt), len(idx),
                               sm_clock_mhz)
        rows.append([blq, blt, len(idx), launches, real,
                     len(idx) * blq * blt, round(ms, 4),
                     round(ms / launches, 4), round(bound_ms, 4),
                     round(real / ms / 1e6, 2), round(bound_ms / ms, 4)])
    tot_ms = sum(r[6] for r in rows)
    tot_bound = sum(r[8] for r in rows)
    return dict(columns=["blq", "blt", "pairs", "launches", "real_cells",
                         "padded_cells", "ms", "ms_per_launch", "bound_ms",
                         "gcups_real", "bound_share"],
                rows=rows, launches=sum(r[3] for r in rows),
                ms=round(tot_ms, 3), bound_ms=round(tot_bound, 3),
                bound_share=round(tot_bound / tot_ms, 4))


@contextlib.contextmanager
def native_inputs():
    """While open, record every call of the native host library on stage
    1's path, with its output: the universe's k-mer profiles
    (`models/homology.kmer_profiles`) and the hit graph's components
    (`ops/mcl.connected_components`).  Yields {name: [(args, kwargs,
    output)]}."""
    from pepr_tpu_torch.models import homology
    from pepr_tpu_torch.ops import mcl
    seen = {"kmer_profiles": [], "connected_components": []}
    saved = [(m, n, getattr(m, n)) for m, n in
             ((homology, "kmer_profiles"), (mcl, "connected_components"))]

    def recorder(name, orig):
        def rec(*a, **kw):
            out = orig(*a, **kw)
            seen[name].append((a, kw, out))
            return out
        return rec

    for mod, name, orig in saved:
        setattr(mod, name, recorder(name, orig))
    try:
        yield seen
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


def native_checks(seen: dict) -> dict:
    """The native library's outputs recorded by native_inputs against
    the plain versions on the same inputs: k-mer profiles row by row
    (equal, or at most one float32 ulp apart: the plain version's norm
    is float32, divided), components identical.  Fails otherwise or if
    either was not called."""
    import numpy as np
    from pepr_tpu_torch import native
    from pepr_tpu_torch.ops.kmer_filter import kmer_profiles_reference
    from pepr_tpu_torch.ops.mcl import connected_components_reference
    if not seen["kmer_profiles"] or not seen["connected_components"]:
        fail("stage 1 did not call the native library: "
             f"{ {k: len(v) for k, v in seen.items()} }")
    prof = []
    for a, kw, got in seen["kmer_profiles"]:
        t = time.time()
        ref = kmer_profiles_reference(*a, **kw)
        ulp = np.spacing(np.maximum(np.abs(got), np.abs(ref)))
        ulps = float((np.abs(got - ref) / ulp).max()) if got.size else 0.0
        prof.append(dict(rows=int(got.shape[0]), dim=int(got.shape[1]),
                         rows_differ=int((got != ref).any(axis=1).sum()),
                         max_ulps=ulps, plain_s=round(time.time() - t, 3)))
        if not ulps <= 1.0:
            fail(f"native k-mer profiles disagree with the plain version "
                 f"by more than one ulp: {prof[-1]}")
    comps = []
    for a, kw, got in seen["connected_components"]:
        t = time.time()
        same = bool(np.array_equal(got, connected_components_reference(
            *a, **kw)))
        comps.append(dict(nodes=int(a[0]), edges=int(len(a[1])),
                          components=int(len(np.unique(got))),
                          identical=same, plain_s=round(time.time() - t, 3)))
        if not same:
            fail(f"native components differ from the plain version: "
                 f"{comps[-1]}")
    return dict(library=native.lib_path(), kmer_profiles=prof,
                connected_components=comps)


def stage1_phases(seed: int, dev, sm_clock_mhz: float) -> tuple:
    """The stage-1 path: data_stage1, sw_kernel, small_stage1, stage1 and
    profile_stage1; returns the SW kernel's entry of the kernels line and
    the stage1 run's input and groups (`ingroup`, `pool`, `groups`)."""
    import numpy as np
    import torch

    from pepr_tpu_torch.data.nt_scores import (NT_GAP_EXTEND, NT_GAP_OPEN,
                                               nt_kernel_matrix)
    from pepr_tpu_torch.models.homology import _pow2_len, batch_pairs
    from pepr_tpu_torch.ops import sw
    from pepr_tpu_torch.ops.smith_waterman import (kernel_matrix,
                                                   sw_align_batch)
    from pepr_tpu_torch.pipeline.stage1 import Stage1Config, run_stage1
    from pepr_tpu_torch.utils.simulate import simulate_genomes

    # -- data_stage1
    t = time.time()
    ingroup, pool, _ = stage1_genomes(seed)
    lens = np.concatenate([g.lengths() for g in ingroup])
    phase("data_stage1", seconds=round(time.time() - t, 3),
          ingroup_genomes=len(ingroup), pool_genomes=len(pool),
          proteins=[len(g) for g in ingroup + pool],
          ingroup_proteins=int(len(lens)), ingroup_residues=int(lens.sum()),
          length_p50_p90_p99=[float(x) for x in
                              np.percentile(lens, [50, 90, 99])],
          length_max=int(lens.max()))

    # -- sw_kernel: the stage-1 pair list, bucket by bucket
    t = time.time()
    pairs_q, ulens, eff_q, eff_t, buckets, codes = stage1_pair_list(ingroup,
                                                                    dev)
    sub = sw.integer_sub(kernel_matrix(), dev)
    # the DP cells of the whole pair list: real, padded to the buckets,
    # and the padded share of the buckets with 4,096-long targets
    pad_cells = {k: len(i) * k[0] * k[1] for k, i in buckets.items()}
    list_cells = dict(
        real=int((ulens[eff_q] * ulens[eff_t]).sum()),
        padded=int(sum(pad_cells.values())),
        padded_share_t4096=sum(v for k, v in pad_cells.items()
                               if k[1] == 4096) / sum(pad_cells.values()))

    def gather(idx, blq, blt):
        qi = torch.as_tensor(eff_q[idx], device=dev)
        ti = torch.as_tensor(eff_t[idx], device=dev)
        return codes[qi, :blq].contiguous(), codes[ti, :blt].contiguous()

    def compare(got, want, what):
        err = max(float((got[k].double() - want[k].double()).abs().max())
                  for k in want)
        if err != 0:
            fail(f"SW kernel disagrees with its plain version at {what}: "
                 f"max abs err {err}")
        return err

    def embedded(q, tt):
        """The same pairs with more trailing PAD: twice the bucket's
        lengths, at most MAX_LEN."""
        return tuple(torch.nn.functional.pad(
            x, (0, min(2 * x.shape[1], sw.MAX_LEN) - x.shape[1]),
            value=24).contiguous() for x in (q, tt))

    checked, n_embedded, samples = [], 0, []
    for (blq, blt), idx in buckets.items():
        take = idx[np.linspace(0, len(idx) - 1,
                               min(len(idx), SW_CHECK_PAIRS)).astype(int)]
        q, tt = gather(take, blq, blt)
        got = sw.sw_align(q, tt, sub)
        samples.append((blq, blt, q, tt, got))
        # PAD tails: the same pairs in a larger bucket, all five outputs
        # identical
        qe, te = embedded(q, tt)
        if qe.shape != q.shape or te.shape != tt.shape:
            compare(sw.sw_align(qe, te, sub), got,
                    f"bucket ({blq}, {blt}) embedded in {tuple(qe.shape[1:])}"
                    f" x {tuple(te.shape[1:])}")
            n_embedded += 1
        checked.append([blq, blt, len(idx), len(take)])
    # the plain version once on every bucket's sample, each padded with
    # PAD to the largest bucket (its outputs do not see PAD tails): its
    # time follows its DP steps, not its pairs, so one call of the
    # largest shape costs about what that bucket's own call did
    wq = max(x[2].shape[1] for x in samples)
    wt = max(x[3].shape[1] for x in samples)
    q_all, t_all = (torch.cat([torch.nn.functional.pad(
        x[i], (0, w - x[i].shape[1]), value=24) for x in samples])
        for i, w in ((2, wq), (3, wt)))
    want, sample_plain_ms = timed(lambda: sw_align_batch(q_all, t_all, sub))
    off = 0
    for blq, blt, q, _, got in samples:
        compare(got, {k: v[off:off + len(q)] for k, v in want.items()},
                f"bucket ({blq}, {blt})")
        off += len(q)
    del samples, q_all, t_all, want
    # planted ties at the walk's strip and lane boundaries, in their own
    # bucket and embedded in a larger one
    ties = planted_tie_pairs()
    for L in sorted({len(a) for a, _ in ties}):
        group = [p for p in ties if len(p[0]) == L]
        q, tt = (torch.as_tensor(x, device=dev) for x in padded(
            group, _pow2_len(L), _pow2_len(len(group[0][1]))))
        got = sw.sw_align(q, tt, sub)
        compare(got, sw_align_batch(q, tt, sub), f"the planted ties, query "
                f"length {L}")
        compare(sw.sw_align(*embedded(q, tt), sub), got,
                f"the planted ties, query length {L}, embedded")
        if float(got["score"].min()) != 105:
            fail(f"the planted ties at query length {L} lost their score")
    # blastn 5/2 on planted ACGT pairs, at the dominant bucket's shape
    (blq, blt), idx = max(buckets.items(), key=lambda kv: len(kv[1]))
    qn, tn = planted_nt_pairs(np.random.default_rng(seed + 11),
                              SW_CHECK_PAIRS, blq, blt)
    qn, tn = torch.as_tensor(qn, device=dev), torch.as_tensor(tn, device=dev)
    nsub = sw.integer_sub(nt_kernel_matrix(), dev)
    nt_want = sw_align_batch(qn, tn, nsub, NT_GAP_OPEN, NT_GAP_EXTEND)
    compare(sw.sw_align(qn, tn, nsub, NT_GAP_OPEN, NT_GAP_EXTEND), nt_want,
            f"the 5/2 set ({blq}, {blt})")
    nt_best = float(nt_want["score"].max())
    # one launch at the main path's batch size for the dominant bucket,
    # and the plain version on the same batch
    n_main = min(len(idx), batch_pairs(blq, blt, dev))
    sel = idx[:n_main]
    q, tt = gather(sel, blq, blt)
    ms = time_ms(lambda: sw.sw_align(q, tt, sub), reps=5)
    got = sw.sw_align(q, tt, sub)
    want, plain_ms = timed(lambda: sw_align_batch(q, tt, sub))
    err = compare(got, want, f"the main batch ({blq}, {blt}) x {n_main}")
    real = int((ulens[eff_q[sel]] * ulens[eff_t[sel]]).sum())
    padded_cells = n_main * blq * blt
    bound_ms, bound_by = sw_bound(real, n_main * (blq + blt), n_main,
                                  sm_clock_mhz)
    entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by,
                 shape=[n_main, blq, blt], real_cells=real,
                 padded_cells=padded_cells, gcups_real=real / ms / 1e6,
                 gcups_padded=padded_cells / ms / 1e6,
                 registers=sw.library().sw_num_regs(),
                 blocks_per_sm=sw.library().sw_blocks_per_sm())
    del q, tt, got, want, qn, tn
    # every bucket at the main path's batches, each launch timed
    table = sw_bucket_table(ulens, eff_q, eff_t, buckets, codes, sub, dev,
                            sm_clock_mhz)
    del codes
    torch.cuda.empty_cache()
    phase("sw_kernel", seconds=round(time.time() - t, 3),
          union_pairs=int(len(pairs_q)), pair_list_cells=list_cells,
          buckets_checked=dict(
              columns=["blq", "blt", "pairs", "checked"], rows=checked,
              plain_shape=[sum(r[3] for r in checked), wq, wt],
              plain_ms=sample_plain_ms),
          embedded_buckets=n_embedded,
          planted_ties=dict(query_lengths=list(TIE_LENGTHS),
                            pairs=len(ties)),
          nt_check=dict(shape=[SW_CHECK_PAIRS, blq, blt],
                        best_score=nt_best), per_bucket=table, **entry)

    # -- small_stage1: the card against the CPU's plain path
    t = time.time()
    s_in, s_pool, _ = simulate_genomes(
        np.random.default_rng(seed + 12), n_ingroup=4, n_families=60,
        n_random=10, median_len=120.0, max_len=250, n_long=0)
    cfg = Stage1Config(use_hmm=False, outgroup_count=2)
    on_gpu = run_stage1(s_in, s_pool, cfg, device="cuda")
    on_cpu = run_stage1(s_in, s_pool, cfg, device="cpu")
    same = [x.titles for x in on_gpu.hg_sets] == \
        [x.titles for x in on_cpu.hg_sets]
    phase("small_stage1", seconds=round(time.time() - t, 3),
          proteins=[len(g) for g in s_in + s_pool],
          groups_gpu=len(on_gpu.hg_sets), groups_cpu=len(on_cpu.hg_sets),
          counts_gpu=on_gpu.counts, counts_cpu=on_cpu.counts,
          identical_groups=same, outgroups_gpu=on_gpu.selected_outgroups,
          outgroups_cpu=on_cpu.selected_outgroups)
    if not same or on_gpu.selected_outgroups != on_cpu.selected_outgroups:
        fail("small stage-1 run on the card disagrees with the CPU's")

    # -- stage1 at full size; the native library's calls on the run's
    # universe and hit graph are recorded (native_inputs) and held
    # against their plain versions after it
    cfg = Stage1Config(use_hmm=False, outgroup_count=2)
    torch.cuda.synchronize()
    sw.reset_launch_counts()
    with native_inputs() as seen:
        t = time.time()
        res = run_stage1(ingroup, pool, cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.time() - t
    launches = sw.LAUNCHES["sw"]
    native_res = native_checks(seen)
    sizes = np.array([len(x) for x in res.hg_sets])
    rec, elig = family_recovery(res.hg_sets, ingroup)
    phase("stage1", seconds=round(wall, 3),
          timings={k: round(v, 3) for k, v in res.timings.items()},
          counts=res.counts,
          group_size_min_p50_p90_max=[int(sizes.min()), float(
              np.percentile(sizes, 50)), float(np.percentile(sizes, 90)),
              int(sizes.max())] if len(sizes) else [],
          selected_outgroups=res.selected_outgroups, sw_launches=launches,
          families_recovered=rec, families_eligible=elig,
          recovered_share=rec / max(elig, 1), native=native_res)
    if launches <= 0:
        fail("the SW kernel was not launched on the stage-1 path")
    if pool[0].taxon not in res.selected_outgroups:
        fail(f"the pool genome was not selected: {res.selected_outgroups}")
    if rec < RECOVERY_FLOOR * elig:
        fail(f"only {rec} of {elig} families recovered")
    entry["launches"] = launches

    # -- profile_stage1: device time by kernel over a second, smaller run
    from torch.profiler import ProfilerActivity, profile
    t = time.time()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_stage1(ingroup[:PROFILE_S1_INGROUP], pool, cfg, device="cuda")
        torch.cuda.synchronize()
    phase("profile_stage1", ingroup=PROFILE_S1_INGROUP, pool=len(pool),
          **device_time(prof, time.time() - t))
    return entry, dict(ingroup=ingroup, pool=pool, groups=res.hg_sets)


# -- the HMM enhancement (stage 1 with use_hmm=True) and run_pepr

def pepr_genomes(seed: int):
    """The Aquificales-shape input of stage1_hmm and pepr: (ingroup,
    pool, generating tree).  As stage1_genomes, but the ingroup tree is
    ((CLADE, (4, 5)), ((6, 7), (8, (9, 10)))) over the genomes 00-10,
    CLADE = ((0, 1), (2, 3)) with internal branches PEPR_CLADE_BRANCH
    long, every other branch 0.01 + Exp(0.06): the clade's supports
    fall below 100 and its stem's do not, so run_pepr refines the clade
    once, as the reference's own example refines one
    (conformance/run_aqu.py:3-5); every other node has only internal,
    well-supported children (PhylogeneticTreeRefiner's rule) and is
    no candidate."""
    import numpy as np
    from pepr_tpu_torch.tree import parse_newick
    from pepr_tpu_torch.utils.simulate import simulate_genomes
    rng = np.random.default_rng(seed + 20)
    g = [f"Synthica_spec{i:02d}_strain_X" for i in range(S1_INGROUP)]

    def bl() -> str:
        return f"{rng.exponential(0.06) + 0.01:.4f}"

    def pair(x, y):
        return f"({x}:{bl()},{y}:{bl()})"

    b = PEPR_CLADE_BRANCH
    clade = (f"(({g[0]}:{bl()},{g[1]}:{bl()}):{b},"
             f"({g[2]}:{bl()},{g[3]}:{bl()}):{b})")
    left = f"({clade}:{bl()},{pair(g[4], g[5])}:{bl()})"
    right = (f"({pair(g[6], g[7])}:{bl()},({g[8]}:{bl()},"
             f"{pair(g[9], g[10])}:{bl()}):{bl()})")
    tree = parse_newick(f"({left},{right});")
    return simulate_genomes(rng, n_ingroup=S1_INGROUP, n_pool=S1_POOL,
                            n_families=S1_FAMILIES, n_random=S1_RANDOM,
                            ingroup_tree=tree)


class ScorerRecord:
    """Records the (sequences, profiles, pairs) of every
    `profile_score_pairs` call the enhancer makes while it is entered;
    the real function still runs."""

    def __enter__(self):
        from pepr_tpu_torch.models import hmm_enhancer
        self.module, self.orig = hmm_enhancer, hmm_enhancer.profile_score_pairs
        self.calls = []

        def record(seqs, hmms, pairs, **kw):
            self.calls.append((seqs, hmms, pairs))
            return self.orig(seqs, hmms, pairs, **kw)

        hmm_enhancer.profile_score_pairs = record
        return self

    def __exit__(self, *exc):
        self.module.profile_score_pairs = self.orig


def hmm_bound(real_cells: int, n_bytes: int, sm_clock_mhz: float,
              mufu_per_cell: int = HMM_MUFU_PER_CELL):
    """Least time (ms) for Forward scoring: its special-function
    results (`mufu_per_cell` a real cell) over the card's rate
    (MUFU_PER_SM_CLOCK a clock on each of SMS SMs), or its bytes over
    HBM bandwidth; returns (ms, bound_by)."""
    t_ops = real_cells * mufu_per_cell / (
        SMS * MUFU_PER_SM_CLOCK * sm_clock_mhz * 1e6)
    t_bytes = n_bytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def hmm_packs(call, dev) -> dict:
    """The device packs of a recorded scorer call (`call`: sequences,
    profiles, pairs) and both plans of the scorer's own planners
    (`ops/hmm.score_plan`, `card_score_plan`, `device_pack`,
    `walk_pack`): the sequence
    pack, and per mpad the profile pack, its lengths, its walk pack (and
    the milliseconds making it took), the reference's buckets (`buckets`)
    and the card's one bucket (`card`)."""
    import numpy as np
    import torch
    from pepr_tpu_torch.ops import hmm, hmm_kernel
    seqs, hmms, pairs = call
    codes_np, lens_np = hmm.pack_sequences(seqs)
    hmm_lens = np.array([h.length for h in hmms], np.int64)
    card = {mpad: bs[0] for mpad, _, bs in hmm.card_score_plan(
        lens_np, hmm_lens, pairs, codes_np.shape[1])}
    packs = {}
    for mpad, members, buckets in hmm.score_plan(lens_np, hmm_lens, pairs):
        pack, m_lens = hmm.device_pack([hmms[i] for i in members], mpad, dev)
        walk, walk_ms = timed(lambda: hmm_kernel.walk_pack(*pack))
        packs[mpad] = dict(pack=pack, m_lens=m_lens, walk=walk,
                           walk_ms=walk_ms, buckets=buckets, card=card[mpad])
    return dict(codes=torch.as_tensor(codes_np, device=dev),
                lens=torch.as_tensor(lens_np, device=dev), lens_np=lens_np,
                packs=packs, n_pairs=len(pairs))


def hmm_launch(p: dict, b, sel, dev, walk=None) -> tuple:
    """The kernel's arguments for the pairs `sel` of bucket `b` (on its
    pack's walk pack, or `walk`), their real DP cells, and the bytes the
    launch must move (the pairs' codes, the distinct profiles' emissions
    and transitions, the index vectors and the scores)."""
    import numpy as np
    import torch
    q = p["packs"][b.mpad]
    si, hi = b.seq_idx[sel], b.hmm_idx[sel]
    args = (p["codes"], p["lens"], walk or q["walk"],
            torch.as_tensor(si, device=dev), torch.as_tensor(hi, device=dev),
            b.lpad)
    uniq = np.unique(hi)
    n_bytes = int(np.minimum(p["lens_np"][si], b.lpad).sum()) + 4 * int((
        HMM_FLOATS_PER_COLUMN * np.minimum(q["m_lens"][uniq], b.mpad)).sum()) \
        + 12 * len(si)
    return args, b.real_cells(p["lens_np"], q["m_lens"], sel), n_bytes


def hmm_launch_table(p: dict, dev, sm_clock_mhz: float) -> tuple:
    """Every launch of the card's plan (one a pack, as profile_score_pairs
    makes them on the card), Forward, each timed once: rows [mpad,
    threads, pairs, real cells, walk-pack ms, ms, bound ms, bound share,
    bound share at HMM_MUFU_PER_CELL_PAIRWISE]; and the (B,) scores of
    every pair of the call, by its index."""
    import torch
    from pepr_tpu_torch.ops import hmm_kernel
    rows = []
    scores = torch.empty(p["n_pairs"], dtype=torch.float32, device=dev)
    for mpad, q in sorted(p["packs"].items()):
        b = q["card"]
        a, real, nb = hmm_launch(p, b, slice(None), dev)
        got, ms = timed(lambda: hmm_kernel.hmm_score(*a, True))
        scores[torch.as_tensor(b.pairs, device=dev)] = got
        bound_ms, _ = hmm_bound(real, nb, sm_clock_mhz)
        pair_ms, _ = hmm_bound(real, nb, sm_clock_mhz,
                                 HMM_MUFU_PER_CELL_PAIRWISE)
        rows.append([mpad, q["walk"].threads, len(b.pairs), real,
                     round(q["walk_ms"], 4), round(ms, 4),
                     round(bound_ms, 4), round(bound_ms / ms, 4),
                     round(pair_ms / ms, 4)])
    return rows, scores


HMM_LAUNCH_COLUMNS = ["mpad", "threads", "pairs", "real_cells",
                      "walk_pack_ms", "ms", "bound_ms", "bound_share",
                      "bound_share_pairwise"]


def hmm_variants(p: dict, dev) -> list:
    """Each kernel configuration (threads a pair) that can take a pack of
    the card's plan, on that pack's launch: [mpad, threads, columns a
    thread, registers, shared bytes a block, resident warps an SM, ms,
    the scorer's choice], Forward, the chosen one first; every other
    variant's scores must equal the chosen one's within HMM_ATOL +
    HMM_RTOL."""
    import torch
    from pepr_tpu_torch.ops import hmm_kernel
    rows = []
    for mpad, q in sorted(p["packs"].items()):
        chosen = q["walk"].threads
        want = None
        for threads in [chosen] + [t for t in (32, 64, 128, 256, 512)
                                   if t != chosen]:
            if hmm_kernel.library().hmm_columns(threads, mpad) < 0:
                continue
            walk = q["walk"] if threads == chosen else \
                hmm_kernel.walk_pack(*q["pack"], threads=threads)
            a, _, _ = hmm_launch(p, q["card"], slice(None), dev, walk)
            got, ms = timed(lambda: hmm_kernel.hmm_score(*a, True))
            if want is None:
                want = got
            d = (got - want).abs()
            if bool((~torch.isfinite(got) | (d > HMM_ATOL + HMM_RTOL
                                             * want.abs())).any()):
                fail(f"HMM kernel variant of {threads} threads at Mpad "
                     f"{mpad} disagrees: max abs err {float(d.max())}")
            f = hmm_kernel.variant_facts(threads, mpad)
            rows.append([mpad, threads, f["columns"], f["registers"],
                         f["smem_bytes"], f["warps_per_sm"], round(ms, 4),
                         threads == chosen])
            del walk, a, got
    return rows


def hmm_kernel_phase(call, dev, sm_clock_mhz: float) -> dict:
    """The HMM kernel against its plain version on the pairs of a
    stage1_hmm run (`call`: the recorded scorer inputs), bucket by
    reference bucket: up to HMM_CHECK_PAIRS real pairs, Forward and
    Viterbi, within HMM_ATOL + HMM_RTOL |plain| (the plain version run
    once a pack on all its buckets' pairs); the same batch permuted,
    and with each pair twice, bit-identical; every launch of the card's
    plan timed beside the bound, and its scores equal to the reference
    buckets' launches' (lpad enters only as the cap); every configuration
    of each pack timed (`hmm_variants`); then the kernels line's entry
    from the card plan's largest launch: its time and bound, and a sample
    of its own scores against the plain version, which is timed on the
    sample beside the kernel (`plain_ms`, `sample_ms`).  Returns that
    entry (`entry`) and the phase's numbers."""
    import numpy as np
    import torch
    from pepr_tpu_torch.ops import hmm, hmm_kernel
    p = hmm_packs(call, dev)

    def plain(args, fwd):
        q = p["packs"][args[2].mpad]
        c, l_, e, tr, m = hmm.gather_pairs(args[0], args[1], *q["pack"],
                                           args[3].long(), args[4].long(),
                                           args[5], args[2].mpad)
        return hmm.viterbi_score_batch(c, l_, e, *tr, m, forward=fwd)

    used = [0.0]  # the largest share of the tolerance any pair used

    def check(got, want, what):
        d = (got - want).abs()
        tol = HMM_ATOL + HMM_RTOL * want.abs()
        if bool((~torch.isfinite(got) | (d > tol)).any()):
            fail(f"the HMM kernel disagrees with its plain version {what}: "
                 f"max abs err {float(d.max())}")
        used[0] = max(used[0], float((d / tol).max()))
        return float(d.max())

    checked, worst, samples = [], 0.0, {}
    buckets = [b for _, q in sorted(p["packs"].items()) for b in q["buckets"]]
    for b in buckets:
        take = np.linspace(0, len(b.pairs) - 1, min(len(b.pairs),
                                                    HMM_CHECK_PAIRS)
                           ).astype(int)
        args, _, _ = hmm_launch(p, b, take, dev)
        kernel = {}
        for fwd in (True, False):
            got = kernel[fwd] = hmm_kernel.hmm_score(*args, fwd)
            perm = torch.randperm(len(take), device=dev)
            p_args = args[:3] + (args[3][perm].contiguous(),
                                 args[4][perm].contiguous(), b.lpad)
            d_args = args[:3] + (args[3].repeat_interleave(2),
                                 args[4].repeat_interleave(2), b.lpad)
            g_p = hmm_kernel.hmm_score(*p_args, fwd)
            g_d = hmm_kernel.hmm_score(*d_args, fwd)
            if not (torch.equal(g_p, got[perm]) and torch.equal(
                    g_d[0::2], got) and torch.equal(g_d[1::2], got)):
                fail(f"the HMM kernel's scores at ({b.lpad}, {b.mpad}) "
                     "depend on the batch (permuted or duplicated pairs "
                     "differ)")
        samples.setdefault(b.mpad, []).append((b, args, kernel))
    # the plain version once a pack on all its buckets' samples, at the
    # pack's largest lpad: a pair's score does not see positions past its
    # sequence, and the plain loop's time follows the longest sequence of
    # its batch, not the pairs
    plain_rows = []
    for mpad, items in sorted(samples.items()):
        a0 = items[0][1]
        m_args = a0[:3] + tuple(torch.cat([a[i] for _, a, _ in items])
                                for i in (3, 4)) + (
            max(b.lpad for b, _, _ in items),)
        want, row = {}, [mpad, m_args[5], len(m_args[3])]
        for fwd in (True, False):
            want[fwd], plain_ms = timed(lambda: plain(m_args, fwd))
            row.append(round(plain_ms, 3))
        plain_rows.append(row)
        off = 0
        for b, a, kernel in items:
            n, row = len(a[3]), [b.lpad, b.mpad, len(b.pairs), len(a[3])]
            for fwd in (True, False):
                err = check(kernel[fwd], want[fwd][off:off + n],
                            f"({'Forward' if fwd else 'Viterbi'}) at "
                            f"({b.lpad}, {b.mpad})")
                worst = max(worst, err)
                row.append(err)
            checked.append(row)
            off += n
    del samples, want
    table, card_scores = hmm_launch_table(p, dev, sm_clock_mhz)
    # the same pairs launched by the reference's buckets: identical
    ref_scores = torch.empty_like(card_scores)
    for b in buckets:
        for sel in b.launches():
            a, _, _ = hmm_launch(p, b, sel, dev)
            ref_scores[torch.as_tensor(b.pairs[sel], device=dev)] = \
                hmm_kernel.hmm_score(*a, True)
    if not torch.equal(card_scores, ref_scores):
        fail("the HMM kernel's scores under the card's plan differ from "
             "those under the reference's buckets")
    variants = hmm_variants(p, dev)
    # the kernels line's entry: the card plan's largest launch (the widest
    # pack's), its time from the per-launch table; HMM_CHECK_PAIRS of its
    # own scores, spread over its sorted pairs, held against the plain
    # version, which is timed on those pairs beside the kernel
    mpad = max(p["packs"])
    b = p["packs"][mpad]["card"]
    row = next(r for r in table if r[0] == mpad)
    take = np.linspace(0, len(b.pairs) - 1, min(len(b.pairs),
                                                HMM_CHECK_PAIRS)).astype(int)
    args, _, _ = hmm_launch(p, b, take, dev)
    want, plain_ms = timed(lambda: plain(args, True))
    got = card_scores[torch.as_tensor(b.pairs[take], device=dev)]
    worst = max(worst, check(got, want, f"on the card plan's launch at Mpad "
                                        f"{mpad} ({len(take)} of its pairs)"))
    sample_ms = time_ms(lambda: hmm_kernel.hmm_score(*args, True), reps=3)
    _, real, n_bytes = hmm_launch(p, b, slice(None), dev)
    bound_ms, bound_by = hmm_bound(real, n_bytes, sm_clock_mhz)
    pair_ms, _ = hmm_bound(real, n_bytes, sm_clock_mhz,
                             HMM_MUFU_PER_CELL_PAIRWISE)
    facts = hmm_kernel.variant_facts(args[2].threads, b.mpad)
    entry = dict(max_abs_err=worst, ms=row[5], plain_ms=plain_ms,
                 plain_pairs=len(take), sample_ms=sample_ms,
                 bound_ms=bound_ms, bound_by=bound_by,
                 bound_ms_pairwise=pair_ms,
                 mufu_per_cell=dict(function=HMM_MUFU_PER_CELL,
                                    pairwise=HMM_MUFU_PER_CELL_PAIRWISE),
                 shape=[len(b.pairs), b.lpad, b.mpad], real_cells=real,
                 padded_cells=len(b.pairs) * b.lpad * b.mpad,
                 threads=facts["threads"], registers=facts["registers"],
                 smem_bytes=facts["smem_bytes"],
                 warps_per_sm=facts["warps_per_sm"],
                 tol=dict(atol=HMM_ATOL, rtol=HMM_RTOL), tol_used=used[0])
    launches_ms = sum(r[5] for r in table)
    launches_bound = sum(r[6] for r in table)
    del p, args, got, want, card_scores, ref_scores
    torch.cuda.empty_cache()
    return dict(entry=entry, checked=dict(
        columns=["lpad", "mpad", "pairs", "checked", "fwd_max_abs_err",
                 "vit_max_abs_err"], rows=checked), plain_by_pack=dict(
        columns=["mpad", "lpad", "pairs", "fwd_ms", "vit_ms"],
        rows=plain_rows), per_launch=dict(
        columns=HMM_LAUNCH_COLUMNS, rows=table,
        ms=round(launches_ms, 4), bound_ms=round(launches_bound, 4),
        bound_share=round(launches_bound / launches_ms, 4)),
        variants=dict(columns=["mpad", "threads", "columns", "registers",
                               "smem_bytes", "warps_per_sm", "ms", "chosen"],
                      rows=variants))


def hmm_card_launches(call) -> int:
    """Launches of the card's plan (`ops/hmm.card_score_plan`) for a
    recorded scorer call: one a pack."""
    import numpy as np
    from pepr_tpu_torch.ops import hmm
    seqs, hmms, pairs = call
    codes_np, lens_np = hmm.pack_sequences(seqs)
    plan = hmm.card_score_plan(lens_np, np.array([h.length for h in hmms]),
                               pairs, codes_np.shape[1])
    return sum(len(b.launches()) for _, _, bs in plan for b in bs)


def hmm_phases(seed: int, dev, sm_clock_mhz: float) -> dict:
    """small_hmm, stage1_hmm and hmm_kernel; returns the HMM kernel's
    entry of the kernels line and the pepr input (pepr_genomes)."""
    import numpy as np
    import torch
    from pepr_tpu_torch.ops import hmm_kernel, sw
    from pepr_tpu_torch.pipeline.stage1 import Stage1Config, run_stage1
    from pepr_tpu_torch.utils.simulate import simulate_genomes

    # -- small_hmm: the card against the CPU's plain path
    t = time.time()
    s_in, s_pool, _ = simulate_genomes(
        np.random.default_rng(seed + 13), n_ingroup=4, n_families=40,
        n_random=8, median_len=100.0, max_len=127, n_long=0)
    cfg = Stage1Config(use_hmm=True, outgroup_count=1,
                       hmm_min_bits=SMALL_HMM_MIN_BITS)
    on_gpu = run_stage1(s_in, s_pool, cfg, device="cuda")
    on_cpu = run_stage1(s_in, s_pool, cfg, device="cpu")
    same = [x.titles for x in on_gpu.hg_sets] == \
        [x.titles for x in on_cpu.hg_sets]
    phase("small_hmm", seconds=round(time.time() - t, 3),
          proteins=[len(g) for g in s_in + s_pool],
          hmm_min_bits=SMALL_HMM_MIN_BITS, groups_gpu=len(on_gpu.hg_sets),
          groups_cpu=len(on_cpu.hg_sets), counts_gpu=on_gpu.counts,
          identical_groups=same, outgroups_gpu=on_gpu.selected_outgroups,
          outgroups_cpu=on_cpu.selected_outgroups)
    if not same or on_gpu.selected_outgroups != on_cpu.selected_outgroups:
        fail("small use_hmm stage-1 run on the card disagrees with the CPU's")
    if s_pool[0].taxon not in on_gpu.selected_outgroups:
        fail("small_hmm: the pool genome was not selected")

    # -- stage1_hmm at the Aquificales shape
    t = time.time()
    ingroup, pool, truth = pepr_genomes(seed)
    data_s = time.time() - t
    cfg = Stage1Config(use_hmm=True, outgroup_count=2)
    torch.cuda.synchronize()
    sw.reset_launch_counts()
    hmm_kernel.reset_launch_counts()
    t = time.time()
    with ScorerRecord() as rec:
        res = run_stage1(ingroup, pool, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = dict(sw.LAUNCHES, **hmm_kernel.LAUNCHES)
    counts = dict(res.counts)
    padded, real = counts.get("hmm_padded_cells", 0), \
        counts.get("hmm_real_cells", 0)
    sizes = np.array([len(x) for x in res.hg_sets])
    phase("stage1_hmm", seconds=round(wall, 3), data_seconds=round(data_s, 3),
          proteins=[len(g) for g in ingroup + pool],
          timings={k: round(v, 3) for k, v in res.timings.items()},
          counts=counts, padded_to_real_cells=padded / max(real, 1),
          group_size_min_p50_p90_max=[int(sizes.min()), float(
              np.percentile(sizes, 50)), float(np.percentile(sizes, 90)),
              int(sizes.max())] if len(sizes) else [],
          selected_outgroups=res.selected_outgroups, launches=launches)
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the stage1_hmm path")
    if pool[0].taxon not in res.selected_outgroups:
        fail(f"stage1_hmm: the pool genome was not selected: "
             f"{res.selected_outgroups}")
    if len(rec.calls) != 1:
        fail(f"stage1_hmm scored {len(rec.calls)} times, expected once")
    if launches["hmm"] != hmm_card_launches(rec.calls[0]):
        fail(f"stage1_hmm made {launches['hmm']} HMM launches, not the "
             f"card plan's {hmm_card_launches(rec.calls[0])}")

    # -- hmm_kernel: the kernel against its plain version on the path's
    # pairs
    t = time.time()
    out = hmm_kernel_phase(rec.calls[0], dev, sm_clock_mhz)
    entry = out["entry"]
    phase("hmm_kernel", seconds=round(time.time() - t, 3),
          buckets_checked=out["checked"],
          plain_by_pack=out["plain_by_pack"], per_launch=out["per_launch"],
          variants=out["variants"], **entry)
    return dict(entry=entry, ingroup=ingroup, pool=pool, truth=truth,
                small_in=s_in, small_pool=s_pool)


def pepr_phase(h: dict, dev, sm_clock_mhz: float, tmp: str):
    """run_pepr with the reference's default track on the pepr_genomes
    input, files written and the checkpoint store kept in `tmp`, the
    seconds in CheckpointStore.save timed; every kernel's launch count is
    reset just before and read just after; then path_checks on its
    stage-2 result.  Returns the launches, path_checks' numbers, the
    result, the configuration, the save tally and the wall seconds."""
    import numpy as np
    import torch
    from pepr_tpu_torch.ops import hmm_kernel, pruning, sw
    from pepr_tpu_torch.pipeline.checkpoint import CheckpointStore
    from pepr_tpu_torch.pipeline.pepr import PeprConfig, run_pepr
    from pepr_tpu_torch.tree import rf_distance
    cfg = PeprConfig.default_track(
        run_name="smoke", out_dir=os.path.join(tmp, "out"),
        checkpoint_dir=os.path.join(tmp, "ckpt"))
    cfg.stage2.support_reps = PEPR_REPS
    save_stats = dict(seconds=0.0, saves=0)
    save = CheckpointStore.save

    def timed_save(self, key, obj):
        t0 = time.time()
        save(self, key, obj)
        save_stats["seconds"] += time.time() - t0
        save_stats["saves"] += 1

    torch.cuda.synchronize()
    for mod in (pruning, sw, hmm_kernel):
        mod.reset_launch_counts()
    CheckpointStore.save = timed_save
    t = time.time()
    try:
        res = run_pepr(cfg, genomes=h["ingroup"], outgroup_pool=h["pool"],
                       device="cuda")
        torch.cuda.synchronize()
    finally:
        CheckpointStore.save = save
    wall = time.time() - t
    launches = dict(pruning.LAUNCHES, **sw.LAUNCHES, **hmm_kernel.LAUNCHES)
    files = sorted(os.path.basename(p) for p in res.output_paths.values()
                   if os.path.isfile(p))
    want = sorted([g.taxon for g in h["ingroup"]] + res.selected_outgroups)
    leaves = sorted(res.tree.leaf_labels())
    sup = [v for v in res.tree.support if v == v]
    checks = path_checks(res.stage2, cfg.stage2.support_reps,
                         cfg.stage2.seed, dev)
    phase("pepr", seconds=round(wall, 3),
          timings={k: round(v, 3) for k, v in res.timings.items()},
          stage1_counts=res.stage1_counts,
          stage2_timings={k: round(v, 3) for k, v in
                          res.stage2.timings.items()},
          config=dict(track="default", full_tree_method=cfg.stage2
                      .full_tree_method, support_reps=cfg.stage2.support_reps,
                      min_taxa_multiplier=cfg.min_taxa_multiplier,
                      refine_cutoff=cfg.refine_cutoff,
                      cuts=PEPR_CUTS),
          families_kept=res.stage2.concat.n_genes,
          trimmed_columns=res.stage2.concat.length,
          refine_rounds=res.refine_rounds, files=files, leaves=leaves,
          selected_outgroups=res.selected_outgroups, supports=sup,
          newick=res.newick,
          rf_vs_generating_tree=rf_distance(res.tree, h["truth"]),
          log_likelihood=res.stage2.log_likelihood, launches=launches,
          **checks)
    if res.refine_rounds < 1:
        fail("pepr: no refinement round ran")
    missing = [sfx for sfx in PEPR_FILES
               if f"smoke{sfx}" not in files]
    if missing:
        fail(f"pepr: output files missing: {missing}")
    if leaves != want:
        fail(f"pepr: the tree's leaves {leaves} are not the genomes {want}")
    if not np.isfinite(res.stage2.log_likelihood):
        fail("pepr: the log-likelihood is not finite")
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the pepr path")
    return launches, checks, res, cfg, save_stats, round(wall, 3)


def resume_view(store, s1, s2) -> dict:
    """What an interrupted small run must reproduce bit for bit: the
    homology hits, the groups, the HMM bits, the alignments, the full
    and decorated trees (Newick with lengths), the supports and the
    LL."""
    from pepr_tpu_torch.tree import to_newick
    hits = store.load("s1_hits")[0]
    return dict(
        hits=[getattr(hits, f) for f in ("query", "target", "raw", "bits",
                                         "evalue", "identity", "length")],
        groups=[s.titles for s in s1.hg_sets],
        outgroups=s1.selected_outgroups,
        hmm_bits=store.load("hmm_scores")[0],
        alignments=[a.mat for a in s2.alignments],
        full_tree=to_newick(s2.full_tree), tree=to_newick(s2.tree),
        supports=[v for v in s2.tree.support if v == v],
        log_likelihood=s2.log_likelihood)


def view_differences(a: dict, b: dict) -> list[str]:
    """The keys of two resume_views that are not identical."""
    import numpy as np

    def same(x, y):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            return np.array_equal(x, y)
        if isinstance(x, list) and isinstance(y, list):
            return len(x) == len(y) and all(same(u, v) for u, v in zip(x, y))
        return x == y

    return [k for k in a if not same(a[k], b[k])]


def small_resume(s_in, s_pool, root: str, dev, reps: int = RESUME_REPS
                 ) -> dict:
    """resume (c): run_stage1(use_hmm=True) and run_stage2 (fast_ml,
    `reps` replicates) on a small input with a store, once whole and
    once under countdowns (`interrupted_runs`) in a second store; at
    the first stop of each of RESUME_STAGES a copy of the store is
    resumed with no deadline.  Every resumed run and the interrupted
    chain's end must equal the whole run (`view_differences`)."""
    import shutil
    from pepr_tpu_torch.models import msa
    from pepr_tpu_torch.pipeline.checkpoint import CheckpointStore
    from pepr_tpu_torch.pipeline.stage1 import Stage1Config, run_stage1
    from pepr_tpu_torch.pipeline.stage2 import Stage2Config, run_stage2
    cfg1 = Stage1Config(use_hmm=True, outgroup_count=1,
                        hmm_min_bits=SMALL_HMM_MIN_BITS)
    cfg2 = Stage2Config(full_tree_method="fast_ml", support_reps=reps)

    def run(where, deadline):
        store = CheckpointStore(where)
        s1 = run_stage1(s_in, s_pool, cfg1, store=store, deadline=deadline,
                        device=dev)
        s2 = run_stage2(s1.hg_sets, cfg2, store=store, deadline=deadline,
                        device=dev)
        return resume_view(store, s1, s2)

    chunk, msa.ALIGN_CHUNK = msa.ALIGN_CHUNK, RESUME_CHUNK
    try:
        t = time.time()
        want = run(os.path.join(root, "whole"), None)
        whole_s = time.time() - t
        chain = os.path.join(root, "chain")
        resumed: dict = {}

        def on_stop(stage):
            kind = next((k for k in RESUME_STAGES if stage.startswith(k)),
                        None)
            if kind is None or kind in resumed:
                return
            where = os.path.join(root, f"resumed{len(resumed)}")
            shutil.copytree(chain, where)
            t0 = time.time()
            diff = view_differences(want, run(where, None))
            resumed[kind] = dict(stage=stage, differ=diff,
                                 seconds=round(time.time() - t0, 3))

        t = time.time()
        got, stages, runs = interrupted_runs(lambda d: run(chain, d), chain,
                                             on_stop)
        chain_s = time.time() - t
    finally:
        msa.ALIGN_CHUNK = chunk
    return dict(whole_seconds=round(whole_s, 3),
                chain_seconds=round(chain_s, 3), runs=runs, stages=stages,
                chain_differ=view_differences(want, got), resumed=resumed,
                missing=[k for k in RESUME_STAGES if k not in resumed])


def rerun_finished(first, cfg, h, out_dir: str) -> dict:
    """resume (b): run_pepr again, the same configuration on the first
    run's finished store, files into `out_dir`; every launch count reset
    just before and read just after (all must stay 0)."""
    import torch
    from dataclasses import replace
    from pepr_tpu_torch.ops import hmm_kernel, pruning, sw
    from pepr_tpu_torch.pipeline.pepr import run_pepr
    from pepr_tpu_torch.tree import to_newick
    torch.cuda.synchronize()
    for mod in (pruning, sw, hmm_kernel):
        mod.reset_launch_counts()
    t = time.time()
    res = run_pepr(replace(cfg, out_dir=out_dir), genomes=h["ingroup"],
                   outgroup_pool=h["pool"], device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = dict(pruning.LAUNCHES, **sw.LAUNCHES, **hmm_kernel.LAUNCHES)

    def read(path):
        with open(path, "rb") as fh:
            return fh.read()

    def supports(r):
        return [v for v in r.tree.support if v == v]

    return dict(seconds=round(wall, 3), launches=launches,
                files={sfx: read(first.output_paths[sfx]) ==
                       read(res.output_paths[sfx]) for sfx in RESUME_FILES},
                same_newick=res.newick == first.newick,
                same_full_tree=to_newick(res.stage2.full_tree) ==
                to_newick(first.stage2.full_tree),
                same_supports=supports(res) == supports(first),
                same_log_likelihood=res.stage2.log_likelihood ==
                first.stage2.log_likelihood,
                refine_rounds=res.refine_rounds)


def resume_phase(first, cfg, h, tmp: str, dev, save_stats: dict,
                 pepr_seconds: float) -> None:
    """The resume line: (a) the pepr run's store (files and bytes by
    store, seconds in CheckpointStore.save), (b) rerun_finished, (c)
    small_resume on the small_hmm input."""
    t = time.time()
    b = rerun_finished(first, cfg, h, os.path.join(tmp, "rerun"))
    c = small_resume(h["small_in"], h["small_pool"],
                     os.path.join(tmp, "small"), dev)
    phase("resume", seconds=round(time.time() - t, 3),
          a=dict(store=store_files(cfg.checkpoint_dir),
                 save_seconds=round(save_stats["seconds"], 6),
                 saves=save_stats["saves"], pepr_seconds=pepr_seconds),
          b=b, c=c)
    if any(b["launches"].values()):
        fail(f"resume: the finished store's re-run launched kernels: "
             f"{b['launches']}")
    if not all(b["files"].values()) or not (
            b["same_newick"] and b["same_full_tree"] and b["same_supports"]
            and b["same_log_likelihood"]):
        fail(f"resume: the finished store's re-run differs: {b}")
    if c["missing"]:
        fail(f"resume: no interruption named {c['missing']}")
    bad = {k: v for k, v in c["resumed"].items() if v["differ"]}
    if bad or c["chain_differ"]:
        fail(f"resume: resumed runs differ from the whole run: {bad}, "
             f"chain {c['chain_differ']}")


# -- stage 2's other options (the stage2_options phase)

def constraint_clades(tree, k: int, sizes=(3, 8)) -> list[list[str]]:
    """The first `k` disjoint clades of `tree` in postorder with
    `sizes[0]`-`sizes[1]` leaves each (leaf labels, sorted)."""
    below: dict[int, list[str]] = {}
    picked: list[list[str]] = []
    used: set[str] = set()
    for node in tree.postorder():
        node = int(node)
        if tree.is_leaf(node):
            below[node] = [tree.labels[node]]
            continue
        below[node] = sorted(x for c in tree.children[node]
                             for x in below[c])
        leaves = below[node]
        if sizes[0] <= len(leaves) <= sizes[1] and not used & set(leaves) \
                and len(picked) < k:
            picked.append(leaves)
            used |= set(leaves)
    return picked


def constraint_tree(taxa: list[str], clades: list[list[str]]):
    """A multifurcating tree over `taxa` whose only bipartitions are
    `clades`."""
    from pepr_tpu_torch.tree import parse_newick
    inside = {x for c in clades for x in c}
    parts = ["(" + ",".join(c) + ")" for c in clades]
    parts += [t for t in taxa if t not in inside]
    return parse_newick("(" + ",".join(parts) + ");")


def option_runs(alignments, nt_sets, truth, dev, reps: int, nt_reps: int,
                max_candidates: int, clade_sizes=(3, 8)) -> dict:
    """A, B and C of the stage2_options phase on `dev` (the CPU in the
    tests' rehearsal); fails on a broken path.  Returns the numbers and
    A's and C's results and models."""
    import numpy as np
    import torch
    from pepr_tpu_torch.data.protein_models import model_names
    from pepr_tpu_torch.models.msa import ALIGN, reset_align_counts
    from pepr_tpu_torch.models.support import support_trees
    from pepr_tpu_torch.models.treebuild import ml_tree, nj_tree
    from pepr_tpu_torch.ops import parsimony
    from pepr_tpu_torch.ops.profile_align import GRAPHS, reset_graph_counts
    from pepr_tpu_torch.pipeline.stage2 import (Stage2Config, run_stage2,
                                                run_stage2_aligned,
                                                substitution_model)
    from pepr_tpu_torch.tree import rf_distance
    from pepr_tpu_torch.tree.bipartition import (bipartitions, compatible,
                                                 taxon_index)
    taxa = sorted(truth.leaf_labels())

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    msgs = _Messages()
    port_log = logging.getLogger("pepr_tpu_torch")
    port_log.setLevel(logging.INFO)
    port_log.addHandler(msgs)
    try:
        # A: congruence filter, matrix evaluation, parsimony_bl, nj supports
        cfg_a = Stage2Config(congruence_filter=True, matrix_evaluation=True,
                             full_tree_method="parsimony_bl",
                             support_method="nj", support_reps=reps)
        parsimony.reset_counts()
        sync()
        t = time.time()
        res_a = run_stage2_aligned(alignments, cfg_a, device=dev)
        sync()
        wall_a = time.time() - t
        fitch = dict(parsimony.TALLY)
        lines_a = list(msgs.lines)
        model_a = substitution_model(res_a.model_name, res_a.gamma_alpha,
                                     res_a.concat.mat)
        matrix_ll = {ln.split()[2]: float(ln.split("LL=")[1])
                     for ln in lines_a if ln.startswith("matrix evaluation:")
                     and "LL=" in ln}
        pars = [ln for ln in lines_a if ln.startswith("parsimony_tree:")]
        a = dict(seconds=round(wall_a, 3),
                 timings={k: round(v, 3) for k, v in res_a.timings.items()},
                 families_in=len(alignments),
                 families_kept=res_a.concat.n_genes,
                 columns=res_a.concat.length, gamma_alpha=res_a.gamma_alpha,
                 matrix_ll=matrix_ll, model_name=res_a.model_name,
                 parsimony=pars, fitch=fitch,
                 rf_vs_generating_tree=rf_distance(res_a.full_tree, truth),
                 supports=[v for v in res_a.tree.support if v == v])
        want_kept = len(alignments) - int(len(alignments)
                                          * cfg_a.congruence_drop)
        if res_a.concat.n_genes != want_kept:
            fail(f"the congruence filter kept {res_a.concat.n_genes} of "
                 f"{len(alignments)} families, expected {want_kept}")
        if sorted(matrix_ll) != sorted(model_names()) or not all(
                np.isfinite(v) for v in matrix_ll.values()):
            fail(f"matrix evaluation scored {matrix_ll}")
        if matrix_ll[res_a.model_name] < max(matrix_ll.values()) - 0.01:
            fail(f"matrix evaluation chose {res_a.model_name}, not the best "
                 f"of {matrix_ll}")
        if len(pars) < 2 or res_a.log_likelihood is not None:
            fail("parsimony_bl did not run its parsimony searches")
        if sorted(res_a.full_tree.leaf_labels()) != taxa:
            fail("A's full tree does not have the dataset's taxa")
        if not a["supports"] or max(a["supports"]) > reps:
            fail(f"A's supports out of range: {a['supports']}")

        # B: on A's concatenation, bootstrap supports, NJ, and a shallow
        # ML search under a constraint with a capped neighbourhood
        cat = res_a.concat
        msgs.lines.clear()
        sync()
        t = time.time()
        boot = support_trees(cat, reps, cfg_a.seed, model=model_a,
                             method="fast_ml", resample="bootstrap_sites",
                             device=dev)
        sync()
        boot_s = time.time() - t
        t = time.time()
        nj = nj_tree(cat.mat, cat.taxa, device=dev)
        sync()
        nj_s = time.time() - t
        clades = constraint_clades(truth, OPTION_CLADES, clade_sizes)
        cons = constraint_tree(taxa, clades)
        t = time.time()
        con, con_ll = ml_tree(cat.mat, cat.taxa, model_a, nni_rounds=2,
                              spr_rounds=0, constraint=cons,
                              max_candidates=max_candidates, device=dev)
        sync()
        con_s = time.time() - t
        idx = taxon_index(taxa)
        full = (1 << len(taxa)) - 1
        cons_bips = bipartitions(cons, idx)
        bad = [b for b in bipartitions(con, idx) for c in cons_bips
               if not compatible(b, c, full)]
        trunc = [ln for ln in msgs.lines if "truncating NNI" in ln]
        b = dict(bootstrap=dict(seconds=round(boot_s, 3), reps=len(boot),
                                rf_vs_generating_tree=[
                                    rf_distance(x, truth) for x in boot]),
                 nj=dict(seconds=round(nj_s, 6),
                         rf_vs_generating_tree=rf_distance(nj, truth)),
                 constrained_ml=dict(
                     seconds=round(con_s, 3), clades=[len(c) for c in clades],
                     log_likelihood=con_ll, incompatible=len(bad),
                     truncation=trunc,
                     rf_vs_generating_tree=rf_distance(con, truth)))
        if len(boot) != reps or any(sorted(x.leaf_labels()) != taxa
                                    for x in boot + [nj, con]):
            fail("B's trees do not have the dataset's taxa")
        if len(clades) != OPTION_CLADES:
            fail(f"found {len(clades)} clades for the constraint")
        if bad:
            fail(f"the constrained ML tree has {len(bad)} bipartitions "
                 "incompatible with the constraint")
        if not trunc:
            fail("max_candidates did not truncate the NNI neighbourhood")
        if not np.isfinite(con_ll):
            fail("the constrained ML tree's LL is not finite")

        # C: the nucleotide path from groups
        cfg_c = Stage2Config(alphabet="nt", full_tree_method="fast_ml",
                             support_reps=nt_reps)
        sync()
        reset_align_counts()
        reset_graph_counts()
        t = time.time()
        res_c = run_stage2(nt_sets, cfg_c, device=dev)
        sync()
        wall_c = time.time() - t
        align_c = dict(ALIGN, **GRAPHS)
        model_c = substitution_model(res_c.model_name, res_c.gamma_alpha,
                                     res_c.concat.mat)
        c = dict(seconds=round(wall_c, 3),
                 timings={k: round(v, 3) for k, v in res_c.timings.items()},
                 align=align_c,
                 families_in=len(nt_sets), families_kept=res_c.concat.n_genes,
                 columns=res_c.concat.length, model_name=res_c.model_name,
                 base_freqs=[float(x) for x in model_c.pi[:4]],
                 gamma_alpha=res_c.gamma_alpha,
                 log_likelihood=res_c.log_likelihood,
                 rf_vs_generating_tree=rf_distance(res_c.full_tree, truth),
                 supports=[v for v in res_c.tree.support if v == v])
        if res_c.model_name != "GTR":
            fail(f"the nucleotide run used {res_c.model_name}, not GTR")
        if sorted(res_c.full_tree.leaf_labels()) != taxa:
            fail("C's full tree does not have the dataset's taxa")
        if not np.isfinite(res_c.log_likelihood):
            fail("C's log-likelihood is not finite")
        if c["rf_vs_generating_tree"] > len(taxa) - 3:
            fail(f"C's tree is far from the generating tree "
                 f"(RF {c['rf_vs_generating_tree']})")
    finally:
        port_log.removeHandler(msgs)
    return dict(a=a, b=b, c=c, res_a=res_a, model_a=model_a, res_c=res_c,
                model_c=model_c, boot=boot, boot_seed=cfg_a.seed)


def bootstrap_block(cat, trees, seed: int, model, dev) -> tuple:
    """replicate_block for B's bootstrap replicates: their multinomial
    column counts (`resample="bootstrap_sites"`, the weights
    support_trees drew for `trees`) as the cotangent; fails unless the
    block is compacted and its counts are integers reaching 2 or more,
    the input jackknife masks never give the kernels."""
    import numpy as np
    from pepr_tpu_torch.models.support import replicate_weights
    w = np.stack([replicate_weights(cat, r, seed, resample="bootstrap_sites")
                  for r in range(len(trees))])
    block = replicate_block(cat, trees, w, model, dev)
    w_r = block[1]
    if block[0].dim() != 3 or float(w_r.max()) < 2 \
            or not bool((w_r == w_r.round()).all()):
        fail("the bootstrap block is not compacted or its weights are not "
             "integer counts above 1")
    return block


def fitch_bound(K: int, L: int, children, code_bytes: int,
                sm_clock_mhz: float):
    """Least time (ms) for the Fitch pass over K topologies of L sites:
    its int32 operations (FITCH_OPS_PER_COMBINE for each child set
    combined into a node's, the edges beyond each node's first child)
    over the int32 rate, or its bytes (codes and children in, K scores
    out) over HBM bandwidth; returns (ms, bound_by)."""
    kids = int((children >= 0).sum())
    combines = kids - children.shape[0]
    t_ops = K * L * combines * FITCH_OPS_PER_COMBINE / (
        INT32_LANES * sm_clock_mhz * 1e6)
    t_bytes = (code_bytes + K * children.size * 4 + K * 8) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def stage2_options_phase(alignments, truth, seed: int, dev,
                         sm_clock_mhz: float) -> dict:
    """The stage2_options phase: option_runs at the data phase's width
    (A and B on the true alignments, C on seeded nucleotide families
    over the generating tree), the pruning launch counts reset just
    before and read just after; the Fitch pass's time on one batch of
    A's NNI candidates beside its bound; then path_checks at A's chosen
    model and at C's GTR model, each on its run's full tree and first
    replicate block, both kernels on B's bootstrap block (integer column
    counts through compaction), and both kernels at A's full tree under
    a model matrix evaluation did not choose.  Returns the checks'
    numbers."""
    import numpy as np
    import torch
    from pepr_tpu_torch.models.treebuild import (FITCH_BATCH,
                                                 _nni_candidates,
                                                 _postorder_fix,
                                                 empirical_aa_freqs)
    from pepr_tpu_torch.ops import pruning
    from pepr_tpu_torch.ops.likelihood import (WagModel, transition_matrices,
                                               tree_to_arrays)
    from pepr_tpu_torch.ops.parsimony import fitch_score_topologies
    from pepr_tpu_torch.pipeline.stage2 import Stage2Config
    rng = np.random.default_rng(seed + 5)
    fams = nt_families(truth, rng.integers(NT_LENGTH[0], NT_LENGTH[1] + 1,
                                           size=NT_FAMILIES), rng)
    nt_sets, _ = unaligned_families(fams, rng)
    t = time.time()
    torch.cuda.synchronize()
    pruning.reset_launch_counts()
    runs = option_runs(alignments, nt_sets, truth, dev, OPTION_REPS,
                       NT_REPS, OPTION_MAX_CANDIDATES)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = dict(pruning.LAUNCHES)
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the stage2_options path")
    # one Fitch batch: A's full tree's NNI candidates at A's width
    cat = runs["res_a"].concat
    n = len(cat.taxa)
    arr = tree_to_arrays(runs["res_a"].full_tree, cat.taxa)
    ch = arr.children
    cands = [_postorder_fix(x, n) for x in _nni_candidates(ch, n)]
    batch = torch.as_tensor(np.stack(cands[:FITCH_BATCH]), device=dev)
    codes = torch.as_tensor(cat.mat, device=dev)
    w = torch.ones(cat.length, device=dev)
    fitch_ms = time_ms(lambda: fitch_score_topologies(codes, batch, w), 3)
    f_bound, f_by = fitch_bound(len(batch), cat.length, ch, cat.mat.size,
                                sm_clock_mhz)
    del codes, batch
    checks = {
        "a": path_checks(runs["res_a"], OPTION_REPS, Stage2Config().seed,
                         dev, model=runs["model_a"]),
        "c": path_checks(runs["res_c"], NT_REPS, Stage2Config().seed, dev,
                         model=runs["model_c"])}
    # B's bootstrap replicates on their compacted codes, their integer
    # column counts as the cotangent
    block = bootstrap_block(cat, runs["boot"], runs["boot_seed"],
                            runs["model_a"], dev)
    checks["b"] = {"kernel_shapes": {"bootstrap_block": block_check(
        *block, torch.as_tensor(runs["model_a"].pi, device=dev),
        cat.length)}}
    del block
    # A's full tree once more under a model matrix evaluation scored but
    # did not choose (WAG-generated data picks WAG), so a non-WAG
    # eigensystem meets the kernels on the card every run
    other = next(m for m in ("BLOSUM62F", "WAGF")
                 if m != runs["res_a"].model_name)
    model_o = WagModel.named(other, alpha=runs["res_a"].gamma_alpha,
                             empirical_freqs=empirical_aa_freqs(cat.mat))
    pi_o = torch.as_tensor(model_o.pi, device=dev)
    blen = torch.as_tensor(arr.blen, device=dev)
    codes = torch.as_tensor(cat.mat, device=dev)
    checks["a"]["kernel_shapes"][f"full_tree_{other}"] = dict(
        trees=1, sites=cat.length, codes="shared", model=other,
        **check_kernels(codes, torch.as_tensor(ch[None], device=dev),
                        transition_matrices(model_o, blen[None])
                        .contiguous(), pi_o,
                        torch.ones((1, cat.length), device=dev)))
    del codes
    phase("stage2_options", seconds=round(wall, 3),
          config=dict(a=dict(congruence_filter=True, matrix_evaluation=True,
                             full_tree_method="parsimony_bl",
                             support_method="nj", support_reps=OPTION_REPS),
                      b=dict(bootstrap_reps=OPTION_REPS,
                             constraint_clades=OPTION_CLADES,
                             nni_rounds=2, spr_rounds=0,
                             max_candidates=OPTION_MAX_CANDIDATES),
                      c=dict(alphabet="nt", families=NT_FAMILIES,
                             lengths=list(NT_LENGTH),
                             full_tree_method="fast_ml",
                             support_reps=NT_REPS)),
          a=runs["a"], b=runs["b"], c=runs["c"], launches=launches,
          fitch_batch=dict(topologies=len(cands[:FITCH_BATCH]),
                           candidates_of_tree=len(cands), sites=cat.length,
                           ms=fitch_ms, bound_ms=f_bound, bound_by=f_by,
                           route="plain PyTorch (no kernel)"),
          checks=checks)
    return checks


# -- the tools (pepr_tpu_torch.tools): tree comparison, the AU test, the
# CLIs, the tree-builder comparison

def tool_trees(truth, full_tree, mat, taxa, seed: int, dev) -> dict:
    """The trees the tools phase scores, by name: the generating tree,
    the stage2 full tree, the NJ tree of `mat` (rows `taxa`), TOOLS_NNI
    NNI neighbours of the generating tree (each fresh edge 0.05) and one
    random topology."""
    import numpy as np
    from pepr_tpu_torch.models.treebuild import (_nni_candidate, _nni_moves,
                                                 nj_tree)
    from pepr_tpu_torch.ops.likelihood import (TreeArrays, arrays_to_tree,
                                               tree_to_arrays)
    from pepr_tpu_torch.utils.simulate import random_tree
    rng = np.random.default_rng(seed + 20)
    arr = tree_to_arrays(truth, taxa)
    moves = _nni_moves(arr.children, len(taxa))
    trees = {"generating": truth, "stage2_full": full_tree,
             "nj": nj_tree(mat, taxa, device=dev)}
    for k, i in enumerate(rng.choice(len(moves), size=TOOLS_NNI,
                                     replace=False)):
        ch, blen = _nni_candidate(arr.children, arr.blen, len(taxa),
                                  [moves[i]])
        trees[f"nni{k + 1}"] = arrays_to_tree(
            TreeArrays(ch, blen, arr.node_of_tree_node, taxa))
    trees["random"] = random_tree(taxa, rng)
    return trees


def au_verdicts(rows, names: list[str], reps: int) -> dict:
    """au_test on the per-site rows (host numpy): the tree with the
    highest total LL must not be rejected (AU >= AU_LEVEL) and the
    random topology must be.  `fitted` counts the trees whose AU came
    from the multiscale fit, strictly between 0 and 1 (a tree that wins
    or loses every replicate takes au_test's saturated 1 or 0)."""
    import numpy as np
    from pepr_tpu_torch.models.au_test import au_test
    t = time.time()
    res = au_test(rows, n_reps=reps)
    secs = time.time() - t
    totals = rows.astype(np.float64).sum(axis=1)
    best = names[int(np.argmax(totals))]
    out = dict(seconds=secs, reps=reps, best=best,
               fitted=int(((res.au > 0) & (res.au < 1)).sum()), by_tree={
        n: dict(total_ll=float(totals[i]), au=float(res.au[i]),
                np_bp=float(res.np_bp[i]), obs_dll=float(res.obs_diff[i]))
        for i, n in enumerate(names)})
    if not out["by_tree"][best]["au"] >= AU_LEVEL:
        fail(f"the AU test rejects the highest-LL tree {best}: {out}")
    if not out["by_tree"]["random"]["au"] < AU_LEVEL:
        fail(f"the AU test does not reject the random topology: {out}")
    return out


def family_au(rows, spans, names: list[str], reps: int) -> dict:
    """au_verdicts on each family's columns of the rows (`spans`: (start,
    stop) column pairs), a gene-by-gene topology test: at a family's
    ~160 columns the trees near the generating one trade wins, so the
    multiscale fit must run for some tree (`fitted` > 0), which the
    full width, where every tree wins or loses every replicate, never
    reaches."""
    t = time.time()
    fams = [au_verdicts(rows[:, a:b], names, reps) for a, b in spans]
    out = dict(seconds=time.time() - t, reps=reps, families=len(fams),
               columns=[int(b - a) for a, b in spans],
               best=[f["best"] for f in fams],
               fitted=sum(f["fitted"] for f in fams),
               au=[{n: round(v["au"], 4) for n, v in f["by_tree"].items()}
                   for f in fams])
    if out["fitted"] == 0:
        fail(f"no family's AU test reached the multiscale fit: {out}")
    return out


def _cli(main, argv) -> tuple[str, float]:
    """(stdout, seconds) of one in-process CLI run, which must exit 0."""
    import contextlib
    import io
    buf = io.StringIO()
    t = time.time()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        fail(f"{main.__module__} {argv} exited {rc}")
    return buf.getvalue(), time.time() - t


def cli_runs(tmp: str, mat, taxa, trees: dict, rows, support_trees,
             genomes, pool, groups, device_args: list[str],
             reps: int) -> dict:
    """The six CLIs, each through its main(argv) on files written to
    `tmp` (`device_args` go to the ones that score trees): their seconds
    and checks, failing the run where one disagrees.  `mat` (rows
    `taxa`) is the alignment `rows`, the per-site LLs of `trees` in
    their order, were scored on; `genomes` and `pool` are written as
    FASTA, `groups` as a set file; `reps` is the AU CLI's -reps."""
    import numpy as np
    from pepr_tpu_torch.io.alignio import (parse_alignment,
                                           write_fasta_alignment,
                                           write_phylip)
    from pepr_tpu_torch.io.fasta import read_fasta, write_fasta
    from pepr_tpu_torch.models.msa import Alignment
    from pepr_tpu_torch.models.treecompare import compare_trees
    from pepr_tpu_torch.tools import (au_test, neighbor_masher,
                                      set_extractor, tree_comparison,
                                      tree_support)
    from pepr_tpu_torch.tree import (decorate_supports, parse_newick,
                                     to_newick)

    def path(name: str) -> str:
        return os.path.join(tmp, name)

    def write(name: str, text: str) -> str:
        with open(path(name), "w") as fh:
            fh.write(text)
        return path(name)

    names = list(trees)
    out = {}
    aln = Alignment("tools", taxa, mat)
    fasta = write("aln.afa", write_fasta_alignment(aln))
    phylip = write("aln.phy", write_phylip(aln))
    for f in (fasta, phylip):
        with open(f) as fh:
            back = parse_alignment(fh.read())
        if back.taxa != taxa or not np.array_equal(back.mat, mat):
            fail(f"{f} does not parse back to the alignment written")
    # tree_comparison: the stage2 full tree against the random topology
    pair = ["stage2_full", "random"]
    texts = [to_newick(trees[n]) + "\n" for n in pair]
    nwk = [write(f"{n}.nwk", x) for n, x in zip(pair, texts)]
    sitelh = path("pair.sitelh")
    text, secs = _cli(tree_comparison.main,
                      nwk + ["-align", fasta, "-sitelh", sitelh]
                      + device_args)
    want = compare_trees(*(parse_newick(x) for x in texts))
    got = au_test.read_sitelh(sitelh)
    want_rows = rows[[names.index(n) for n in pair]].astype(np.float64)
    err = float(np.abs(got - want_rows).max()) \
        if got.shape == want_rows.shape else float("inf")
    out["tree_comparison"] = dict(seconds=secs, rf=want["rf"],
                                  sitelh_max_abs_diff=err)
    if f"rf\t{want['rf']}" not in text.splitlines():
        fail(f"tree_comparison's RF line is not compare_trees' "
             f"({want['rf']}): {text}")
    if not err <= SITELH_TOL:
        fail(f"tree_comparison's .sitelh differs from the per-site rows by "
             f"{err} (shape {got.shape})")
    # au_test from that .sitelh, and from the alignment file and trees
    both = write("pair.nwk", "".join(texts))
    reports = {}
    for how, argv in (("sitelh", ["-sitelh", sitelh]),
                      ("alignment", ["-alignment", phylip, "-trees", both]
                       + device_args)):
        reports[how], secs = _cli(au_test.main,
                                  argv + ["-reps", str(reps)])
        out[f"au_test_{how}"] = dict(seconds=secs)
    if reports["sitelh"] != reports["alignment"]:
        fail(f"au_test -sitelh and -alignment disagree: {reports}")
    out["au_test_report"] = reports["sitelh"].splitlines()
    # tree_support: the stage2 full tree decorated by its replicates
    main_f = write("full.nwk", to_newick(trees["stage2_full"]) + "\n")
    sup_f = write("support.nwk", "".join(to_newick(t) + "\n"
                                         for t in support_trees))
    text, secs = _cli(tree_support.main, [main_f, sup_f])
    want = to_newick(decorate_supports(
        parse_newick(to_newick(trees["stage2_full"])),
        [parse_newick(to_newick(t)) for t in support_trees]))
    out["tree_support"] = dict(seconds=secs, replicates=len(support_trees))
    if text != want + "\n":
        fail("tree_support's tree differs from decorate_supports'")
    # set_extractor: the groups from the genomes' FASTA files
    files = []
    for g in genomes + pool:
        files.append(path(f"{g.name}.faa"))
        write_fasta(files[-1], g)
    set_file = write("groups.txt", "".join("\t".join(g.ids) + "\n"
                                           for g in groups))
    hg = path("hg")
    text, secs = _cli(set_extractor.main, ["-set_file", set_file,
                                           "-genome_file", *files,
                                           "-out_dir", hg])
    made = sorted(os.listdir(hg))
    out["set_extractor"] = dict(seconds=secs, sets=len(made))
    if text != f"wrote {len(groups)} set files to {hg}\n" \
            or len(made) != len(groups):
        fail(f"set_extractor wrote {len(made)} files for {len(groups)} "
             f"groups: {text}")
    for i, g in enumerate(groups):
        back = read_fasta(os.path.join(hg, f"set_{i}.faa"))
        if back.titles != g.titles:
            fail(f"set_{i}.faa does not hold group {i}'s members")
    # neighbor_masher: the first MASH_GENOMES genomes, the pool as the
    # outgroup candidates
    masher = genomes[:MASH_GENOMES]
    text, secs = _cli(neighbor_masher.main,
                      ["-genome_file", *files[:len(masher)],
                       "-outgroup", *files[len(genomes):]])
    lines = text.splitlines()
    want = "selected_outgroups\t" + "\t".join(g.taxon for g in pool)
    d = np.array([[float(x) for x in ln.split("\t")[1:]]
                  for ln in lines[2:]])
    out["neighbor_masher"] = dict(seconds=secs, genomes=len(masher),
                                  selected=lines[0],
                                  distance_range=[float(d.min()),
                                                  float(d.max())])
    if lines[0] != want or d.shape != (len(masher),) * 2 \
            or not np.array_equal(d, d.T) or np.diag(d).any() \
            or not 0 < d[~np.eye(len(d), dtype=bool)].min():
        fail(f"neighbor_masher: {lines[:2]} ... {d.shape}")
    return out


def builder_runs(mat, taxa, dev) -> dict:
    """compare_builders (fast_ml, nj, parsimony_bl) on `mat`, the pruning
    launch counts reset just before and read just after; each method's
    LL against the plain path's on the same tree (FINAL_LL_RTOL).
    Returns its numbers and the trees (`trees`, by method)."""
    import numpy as np
    import torch
    from pepr_tpu_torch.ops import pruning
    from pepr_tpu_torch.ops.likelihood import WagModel
    from pepr_tpu_torch.tools.treebuilder_compare import compare_builders
    from pepr_tpu_torch.tree import parse_newick
    methods = list(TOOLS_METHODS)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    pruning.reset_launch_counts()
    t = time.time()
    res = compare_builders(mat, taxa, methods, device=dev)
    wall = time.time() - t
    launches = dict(pruning.LAUNCHES)
    model = WagModel.create(alpha=res["alpha"])
    pi = torch.as_tensor(model.pi, device=dev)
    codes = torch.as_tensor(mat, device=dev)
    trees = {m: parse_newick(res[m]["tree"]) for m in methods}
    out = dict(seconds=wall, alpha=res["alpha"], rf=res["rf"],
               launches=launches, methods={})
    for m in methods:
        ch, pm = tree_tensors([trees[m]], taxa, model, dev)
        with torch.no_grad():
            plain = float(pruning.site_ll_reference(codes, ch, pm, pi)
                          .double().sum())
        ll = res[m]["log_likelihood"]
        rel = abs(ll - plain) / abs(plain)
        out["methods"][m] = dict(seconds=res[m]["seconds"],
                                 log_likelihood=ll, ll_plain=plain,
                                 ll_rel=rel)
        if not np.isfinite(ll) or not rel <= FINAL_LL_RTOL:
            fail(f"compare_builders' {m} LL {ll} disagrees with the plain "
                 f"path's {plain}")
    return dict(out, trees=trees)


def tools_phase(cat, truth, full_tree, support_trees, s1: dict, seed: int,
                dev, tmp: str) -> dict:
    """The tools phase.  (a) per_site_log_likelihoods of tool_trees over
    the data phase's concatenation in one forward launch (the count
    reset just before and read just after), each row equal to a launch
    of its tree alone, all rows against the plain version and each total
    against a float64 plain one, the launch timed beside its bound;
    (b) au_verdicts on those rows; (c) cli_runs; (d) builder_runs on
    the first TOOLS_COLUMNS columns, then both kernels at its three
    trees' shape.  Prints the tools line; returns the kernel checks."""
    import numpy as np
    import torch
    from pepr_tpu_torch.models.treecompare import (per_site_log_likelihoods,
                                                   tree_batches)
    from pepr_tpu_torch.ops import pruning
    from pepr_tpu_torch.ops.likelihood import WagModel, transition_matrices
    t_phase = time.time()
    taxa = cat.taxa
    # the CLIs' model (WAG+Gamma at alpha 1), so that their .sitelh and
    # reports can be held against these rows
    model = WagModel.create()
    trees = tool_trees(truth, full_tree, cat.mat, taxa, seed, dev)
    names = list(trees)
    # (a)
    torch.cuda.synchronize()
    pruning.reset_launch_counts()
    t = time.time()
    rows = per_site_log_likelihoods(list(trees.values()), cat.mat, taxa,
                                    device="cuda")
    a_secs = time.time() - t
    launches = dict(pruning.LAUNCHES)
    if launches != {"pruning_fwd": 1, "pruning_bwd": 0}:
        fail(f"per_site_log_likelihoods made {launches} launches, not one "
             f"forward launch")
    batches = tree_batches(list(trees.values()), taxa, dev)
    if len(batches) != 1 or rows.dtype != np.float32 \
            or rows.shape != (len(trees), cat.length):
        fail(f"the tools' trees are not one batch or the rows are not "
             f"float32 ({len(batches)}, {rows.dtype}, {rows.shape})")
    _, ch, blen = batches[0]
    pm = transition_matrices(model, blen).contiguous()
    pi = torch.as_tensor(model.pi, device=dev)
    codes = torch.as_tensor(cat.mat, device=dev)
    rows_d = torch.as_tensor(rows, device=dev)
    relaunch = bool(torch.equal(pruning.pruning_fwd(codes, ch, pm, pi),
                                rows_d))
    alone = [bool(torch.equal(pruning.pruning_fwd(
        codes, ch[b:b + 1], pm[b:b + 1], pi)[0], rows_d[b]))
        for b in range(len(trees))]
    if not relaunch or not all(alone):
        fail(f"per-tree rows depend on the batch: relaunch {relaunch}, "
             f"alone {alone}")
    wide = {}
    with torch.no_grad():
        for b, n in enumerate(names):
            w = float(pruning.site_ll_reference(
                codes, ch[b:b + 1], pm[b:b + 1].double(), pi.double()).sum())
            k = float(rows[b].astype(np.float64).sum())
            wide[n] = dict(kernel=k, float64=w, rel=abs(k - w) / abs(w))
            if not wide[n]["rel"] <= FINAL_LL_RTOL:
                fail(f"tree {n}: the kernel's total LL {k} disagrees with "
                     f"the float64 plain one {w}")
    shape = dict(trees=len(trees), sites=cat.length, codes="shared",
                 **check_kernels(codes, ch, pm, pi, None, grad=False))
    del codes, rows_d, pm
    torch.cuda.empty_cache()
    a = dict(seconds=a_secs, trees=names, launches=launches,
             relaunch_identical=relaunch, alone_identical=alone,
             total_ll_vs_float64=wide)
    # (b)
    b = au_verdicts(rows, names, AU_REPS)
    b["families"] = family_au(rows, cat.spans[:AU_FAMILIES], names,
                              AU_FAMILY_REPS)
    # (c)
    t = time.time()
    c = cli_runs(tmp, cat.mat, taxa, trees, rows, support_trees,
                 s1["ingroup"], s1["pool"], s1["groups"], [], AU_CLI_REPS)
    c["seconds"] = time.time() - t
    # (d)
    d = builder_runs(cat.mat[:, :TOOLS_COLUMNS].copy(), taxa, dev)
    for k, n in d["launches"].items():
        if n <= 0:
            fail(f"kernel {k} was not launched by compare_builders")
    model_d = WagModel.create(alpha=d["alpha"])
    batches = tree_batches(list(d.pop("trees").values()), taxa, dev)
    if len(batches) != 1:
        fail("compare_builders' trees are not one batch")
    _, ch, blen = batches[0]
    codes = torch.as_tensor(cat.mat[:, :TOOLS_COLUMNS].copy(), device=dev)
    builders = dict(trees=ch.shape[0], sites=TOOLS_COLUMNS, codes="shared",
                    **check_kernels(codes, ch, transition_matrices(
                        model_d, blen).contiguous(),
                        torch.as_tensor(model_d.pi, device=dev),
                        torch.ones((ch.shape[0], TOOLS_COLUMNS),
                                   device=dev)))
    del codes
    phase("tools", seconds=round(time.time() - t_phase, 3),
          config=dict(au_reps=AU_REPS, au_cli_reps=AU_CLI_REPS,
                      au_families=AU_FAMILIES,
                      au_family_reps=AU_FAMILY_REPS,
                      mash_genomes=MASH_GENOMES,
                      tools_columns=TOOLS_COLUMNS,
                      methods=list(TOOLS_METHODS)),
          a=a, b=b, c=c, d=d,
          kernel_shapes=dict(per_site_export=shape,
                             compare_builders=builders))
    return {"kernel_shapes": {"per_site_export": shape,
                              "compare_builders": builders}}


# what a spawned rank of the distributed phase imports
RANK_IMPORTS = ("numpy", "torch", "torch._dynamo", "torch.distributed",
                "torch.multiprocessing", "pepr_tpu_torch.entry",
                "pepr_tpu_torch.models.support")


def warm_rank_imports(build_dir: str):
    """Start a child that compiles what a spawned rank imports into a
    bytecode cache under `build_dir` (PYTHONPYCACHEPREFIX), while the
    phases before the distributed one run.  On a host that writes no
    bytecode (PYTHONDONTWRITEBYTECODE) each rank would otherwise compile
    torch's sources again, and torch._dynamo's, which the first Adam
    step imports.  The child prints the seconds its imports took.
    Returns (the child, the cache directory)."""
    prefix = os.path.join(build_dir, "pycache")
    env = dict(os.environ, PYTHONPYCACHEPREFIX=prefix)
    env.pop("PYTHONDONTWRITEBYTECODE", None)
    child = subprocess.Popen(
        [sys.executable, "-c", "import time; t = time.time(); import "
         + ", ".join(RANK_IMPORTS) + "; print(time.time() - t)"],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return child, prefix


def small_support_input(seed: int):
    """(c)'s input: DIST_SMALL's taxa and WAG+Gamma(0.5) families of
    80-160 columns over a random tree, concatenated."""
    import numpy as np
    from pepr_tpu_torch.models.concat import concatenate
    from pepr_tpu_torch.models.msa import Alignment
    from pepr_tpu_torch.utils.simulate import random_tree, simulate_families
    rng = np.random.default_rng(seed + 5)
    taxa = [f"d{i:02d}" for i in range(DIST_SMALL["taxa"])]
    fams = simulate_families(random_tree(taxa, rng),
                             rng.integers(80, 160,
                                          size=DIST_SMALL["families"]),
                             rng, alpha=0.5)
    return concatenate([Alignment(n, t, c) for n, t, c in fams], taxa)


def dist_rank(codes, masks, children, rep_blen, model, full, small,
              seed: int, device, t_spawn: float) -> dict:
    """One spawned rank of (b) and (c): sharded_loglik of the full tree
    (`full`: children, blen), sharded_replicate_blopt of the replicates,
    then support_trees_batched on `small`, each timed, with the pruning
    launches and the mesh's all-reduce tally of (b); `start` is the
    seconds from `t_spawn` (the spawn) to the group's first work."""
    start = time.time() - t_spawn
    import numpy as np
    import torch
    import torch.distributed as dist
    from pepr_tpu_torch.models.support import support_trees_batched
    from pepr_tpu_torch.ops import pruning
    from pepr_tpu_torch.parallel import mesh as pm
    from pepr_tpu_torch.tree import to_newick

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    mesh = pm.default_mesh()
    pruning.reset_launch_counts()
    pm.reset_collective_counts()
    t = time.time()
    total = pm.sharded_loglik(mesh, codes, np.ones(codes.shape[1],
                                                   np.float32),
                              *full, model, device=device)
    loglik_s = time.time() - t
    t = time.time()
    blen, ll = pm.sharded_replicate_blopt(mesh, codes, masks, children,
                                          rep_blen, model, steps=DIST_STEPS,
                                          device=device)
    sync()
    fit_s = time.time() - t
    launches = dict(pruning.LAUNCHES)
    collectives = dict(pm.COLLECTIVES)
    t = time.time()
    trees = support_trees_batched(small, DIST_SMALL["reps"], seed,
                                  device=device)
    sync()
    return dict(rank=dist.get_rank(), mesh=dict(mesh.shape),
                coords=dict(mesh.coords), backend=mesh.backend,
                total=total, blen=blen, ll=ll, launches=launches,
                collectives=collectives,
                # the gradient of one Adam step: the row's (R / rows, V)
                # float32 lengths
                step_bytes=-(-len(masks) // mesh.shape["rep"])
                * rep_blen.shape[1] * 4,
                seconds=dict(start=start, loglik=loglik_s, fit=fit_s,
                             support=time.time() - t),
                support=[to_newick(x) for x in trees])


def dist_checks(one: dict, ranks: list[dict]) -> dict:
    """(b) and (c) against (a): `one` holds (a)'s total, blen, ll and
    support Newicks."""
    import numpy as np
    from pepr_tpu_torch.tree import parse_newick, rf_distance
    first = ranks[0]
    rel = [abs(r["total"] - one["total"]) / abs(one["total"])
           for r in ranks]
    if not max(rel) <= DIST_LL_RTOL:
        fail(f"sharded_loglik over the ranks is {max(rel)} from one "
             f"rank's total")
    blen_rel = float(np.max(np.abs(first["blen"] - one["blen"])
                            / np.abs(one["blen"])))
    ll_rel = float(np.max(np.abs(first["ll"] - one["ll"])
                          / np.abs(one["ll"])))
    if not (blen_rel <= DIST_BLEN_RTOL and ll_rel <= DIST_RLL_RTOL):
        fail(f"sharded_replicate_blopt over the ranks disagrees with one "
             f"rank: lengths rel {blen_rel}, LLs rel {ll_rel}")
    same = [r["total"] == first["total"]
            and np.array_equal(r["blen"], first["blen"])
            and np.array_equal(r["ll"], first["ll"])
            and r["support"] == first["support"] for r in ranks]
    if not all(same):
        fail(f"the ranks returned different results: {same}")
    rf = [rf_distance(parse_newick(a), parse_newick(b))
          for a, b in zip(first["support"], one["support"])]
    if len(rf) != len(one["support"]) or any(rf):
        fail(f"support topologies over the ranks differ from one rank's: "
             f"RF {rf}")
    return dict(total_rel=rel, blen_rel=blen_rel, ll_rel=ll_rel,
                identical_across_ranks=same, support_rf=rf)


def distributed_phase(cat, truth, model, seed: int, dev, warm) -> None:
    """The distributed phase (see the module docstring); prints its
    line.  `warm`: warm_rank_imports' child and cache, which the spawned
    ranks read."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from pepr_tpu_torch.entry import dryrun_multi, entry, free_port, run_ranks
    from pepr_tpu_torch.models.support import (jackknife_gene_masks,
                                               support_trees_batched)
    from pepr_tpu_torch.models.treebuild import nj_start_tree
    from pepr_tpu_torch.ops.likelihood import (WagModel, loglik,
                                               tree_to_arrays)
    from pepr_tpu_torch.parallel import mesh as pm
    from pepr_tpu_torch.parallel.replicates import replicate_blopt
    from pepr_tpu_torch.pipeline.stage2 import Stage2Config
    from pepr_tpu_torch.tree import to_newick
    t_phase = time.time()
    masks = jackknife_gene_masks(cat, DIST_REPS, Stage2Config().seed)
    arrs = [tree_to_arrays(nj_start_tree(cat.mat, cat.taxa, m, device=dev),
                           cat.taxa) for m in masks]
    ch = np.stack([a.children for a in arrs])
    bl = np.stack([a.blen for a in arrs])
    t_arr = tree_to_arrays(truth, cat.taxa)
    full = (t_arr.children, t_arr.blen)
    ones = np.ones(cat.length, np.float32)
    small = small_support_input(seed)

    def timed_sync(fn):
        torch.cuda.synchronize()
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t

    # (a) one NCCL rank in this process
    pm.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                              device="cuda")
    try:
        probe = torch.ones(1, device=dev)
        dist.all_reduce(probe)
        mesh = pm.default_mesh()
        if dist.get_backend() != "nccl" or float(probe[0]) != 1.0 \
                or mesh.shape != {"rep": 1, "site": 1}:
            fail(f"one NCCL rank: backend {dist.get_backend()}, mesh "
                 f"{mesh.shape}, all_reduce {float(probe[0])}")
        total = pm.sharded_loglik(mesh, cat.mat, ones, *full, model,
                                  device=dev)
        want = loglik(cat.mat, *full, model, device=dev)
        (b1, ll1), fit_s = timed_sync(lambda: pm.sharded_replicate_blopt(
            mesh, cat.mat, masks, ch, bl, model, steps=DIST_STEPS,
            device=dev))
        (b0, ll0), plain_s = timed_sync(lambda: replicate_blopt(
            cat.mat, masks, ch, bl, model, steps=DIST_STEPS, device=dev))
        support1, support_s = timed_sync(lambda: [
            to_newick(x) for x in support_trees_batched(
                small, DIST_SMALL["reps"], seed, device=dev)])
    finally:
        pm.shutdown_distributed()
    a = dict(backend="nccl", mesh=mesh.shape, total=total,
             loglik_identical=total == want,
             fit_identical=bool(np.array_equal(b1, b0)
                                and np.array_equal(ll1, ll0)),
             seconds=dict(sharded_fit=fit_s, replicate_blopt=plain_s,
                          small_support=support_s))
    if not (a["loglik_identical"] and a["fit_identical"]):
        fail(f"one NCCL rank is not the one-process path bit for bit: {a}")
    # (b) and (c): the ranks share the card over Gloo, each starting from
    # the bytecode cache
    child, prefix = warm
    out, err = child.communicate(timeout=DIST_TIMEOUT)
    if child.returncode != 0:
        fail(f"importing a rank's modules failed:\n{err[-2000:]}")
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    t = time.time()
    ranks = run_ranks(DIST_RANKS, dist_rank,
                      (cat.mat, masks, ch, bl, model, full, small, seed,
                       None, t), backend="gloo", timeout=DIST_TIMEOUT)
    bc_s = time.time() - t
    checks = dist_checks(dict(total=total, blen=b1, ll=ll1,
                              support=support1), ranks)
    for r in ranks:
        if r["launches"]["pruning_fwd"] <= 0 \
                or r["launches"]["pruning_bwd"] != DIST_STEPS:
            fail(f"rank {r['rank']} made {r['launches']} pruning launches, "
                 f"not {DIST_STEPS} gradients")
    b = dict(ranks=DIST_RANKS, backend=ranks[0]["backend"],
             tensors="cuda", mesh=ranks[0]["mesh"], seconds=bc_s,
             # a rank's imports compiled from source, beside the ranks'
             # start from the cache (per_rank's `start`)
             uncached_imports_s=float(out.split()[-1]),
             per_rank=[dict(rank=r["rank"], coords=r["coords"],
                            seconds=r["seconds"], launches=r["launches"],
                            all_reduce=r["collectives"],
                            step_bytes=r["step_bytes"]) for r in ranks],
             **{k: v for k, v in checks.items() if k != "support_rf"})
    c = dict(taxa=len(small.taxa), families=small.n_genes,
             columns=small.length, reps=DIST_SMALL["reps"],
             support_rf=checks["support_rf"])
    # (d) the dry run and entry() on the card
    t = time.time()
    dry = dryrun_multi(DIST_RANKS, backend="gloo")
    dry_s = time.time() - t
    os.environ.pop("PYTHONPYCACHEPREFIX")
    fn, ex = entry()
    with torch.no_grad():
        e_total = float(fn(*ex))
    e_want = loglik(ex[0].cpu().numpy(), ex[1].cpu().numpy(),
                    ex[2].cpu().numpy(), WagModel.create(), device=dev)
    d = dict(dryrun_seconds=dry_s, dryrun_mesh=dry[0]["mesh"],
             dryrun_total=dry[0]["total"], entry_total=e_total,
             entry_equals_loglik=e_total == e_want)
    if not d["entry_equals_loglik"]:
        fail(f"entry()'s total {e_total} is not loglik's {e_want}")
    phase("distributed", seconds=round(time.time() - t_phase, 3),
          config=dict(ranks=DIST_RANKS, reps=DIST_REPS, steps=DIST_STEPS,
                      columns=cat.length, small=DIST_SMALL),
          a=a, b=b, c=c, d=d)


# -- real_data: the reference's example runs through stage 2

def load_realdata(run: str, root: str = REALDATA) -> tuple:
    """The exported families of a reference run as the port's
    Alignments, and the JAX run's results (its .json)."""
    import numpy as np
    from pepr_tpu_torch.models.msa import Alignment
    with np.load(os.path.join(root, f"{run}.npz")) as d:
        a = {k: d[k] for k in d.files}
    with open(os.path.join(root, f"{run}.json")) as fh:
        meta = json.load(fh)
    ro, off = a["row_offsets"], a["offsets"]
    alns = []
    for f, name in enumerate(a["names"]):
        r0, r1 = int(ro[f]), int(ro[f + 1])
        alns.append(Alignment(
            str(name), [str(t) for t in a["taxa"][r0:r1]],
            a["codes"][off[f]:off[f + 1]].reshape(r1 - r0,
                                                  int(a["widths"][f])),
            titles=[str(t) for t in a["titles"][r0:r1]]))
    return alns, meta


def real_config(meta: dict, reps: int, **kw):
    """The JAX run's stage-2 configuration with `reps` replicates and
    the fields of `kw`."""
    from pepr_tpu_torch.pipeline.stage2 import Stage2Config
    fields = dict(meta["stage2"], support_reps=reps)
    fields.update(kw)
    return Stage2Config(**fields)


def split_agreement(tree, ref, min_len: float) -> dict:
    """`tree`'s splits against `ref`'s: the RF over all splits, and
    `rf_long`: the splits of `ref` at least `min_len` long that `tree`
    lacks plus the splits of `tree` incompatible with one of them (0:
    `tree` refines `ref` with its shorter branches collapsed)."""
    from pepr_tpu_torch.tree.basic import unroot
    from pepr_tpu_torch.tree.bipartition import (bipartitions, canonical,
                                                 compatible, node_leafsets,
                                                 taxon_index)
    taxa = sorted(ref.leaf_labels())
    index = taxon_index(taxa)
    full = (1 << len(taxa)) - 1
    u = unroot(ref)
    masks = node_leafsets(u, index)
    lengths = {}
    for node in range(u.n_nodes):
        size = bin(masks[node]).count("1")
        if node != u.root and 1 < size < len(taxa) - 1:
            lengths[canonical(masks[node], full)] = float(u.blen[node])
    have = bipartitions(tree, index)
    long = {b for b, v in lengths.items() if v >= min_len}
    clash = {b for b in have if any(not compatible(b, j, full)
                                    for j in long)}
    return dict(rf=len(have ^ set(lengths)),
                rf_long=len(long - have) + len(clash), splits=len(lengths),
                long_splits=len(long), min_len=min_len,
                short_lengths=sorted(v for v in lengths.values()
                                     if v < min_len))


def real_data_compare(res, meta: dict, reps: int, dev,
                      refit_steps: int | None = None,
                      ll_rtol: float | None = REAL_LL_RTOL) -> dict:
    """A run_stage2_aligned result on a reference run's families against
    the JAX run (`meta`): the Gamma shapes; the full trees' splits
    (split_agreement) and the RF to FastTree's tree; the port's tree and
    the JAX tree under the port's likelihood at the port's Gamma shape
    (the JAX tree at its own lengths and refitted by the port's Adam
    for `refit_steps`, default the run's bl_steps; `ll_rtol` None for a
    run whose full-tree method is not the JAX run's); the first `reps`
    replicates against the JAX run's, topology by topology, and the
    supports both sets give the JAX tree's splits.  Fails if the port's
    tree neither keeps every long split nor scores at least as high, if
    the Gamma shape is more than REAL_ALPHA_ATOL away or the LL more
    than REAL_LL_RTOL, or if a replicate's topology or a support differs
    from the JAX run's."""
    import numpy as np
    from pepr_tpu_torch.models.treebuild import optimize_branch_lengths
    from pepr_tpu_torch.ops.likelihood import (WagModel, loglik,
                                               tree_to_arrays)
    from pepr_tpu_torch.tree import parse_newick, rf_distance
    from pepr_tpu_torch.tree.bipartition import (bipartition_counts,
                                                 bipartitions, taxon_index)
    cat = res.concat
    jax_tree = parse_newick(meta["full_tree"]["newick"])
    fasttree = parse_newick(meta["oracle"]["fasttree_newick"])
    model = WagModel.create(alpha=res.gamma_alpha)

    def ll(tree, blen=None):
        arr = tree_to_arrays(tree, cat.taxa)
        return loglik(cat.mat, arr.children,
                      arr.blen if blen is None else blen, model, device=dev)

    jarr = tree_to_arrays(jax_tree, cat.taxa)
    if refit_steps is None:
        refit_steps = meta["stage2"]["bl_steps"]
    blen, _ = optimize_branch_lengths(cat.mat, jarr, model,
                                      steps=refit_steps, device=dev)
    lls = dict(port=ll(res.full_tree), port_search=res.log_likelihood,
               jax_tree_jax_lengths=ll(jax_tree),
               jax_tree_refit=ll(jax_tree, blen), refit_steps=refit_steps,
               jax_run=meta["full_tree"]["log_likelihood"])
    lls["port_minus_jax_refit"] = lls["port"] - lls["jax_tree_refit"]
    splits = split_agreement(res.full_tree, jax_tree, REAL_SPLIT_MIN)
    out = dict(
        families=len(res.alignments), taxa=len(cat.taxa),
        columns=cat.length,
        gamma_alpha=dict(port=res.gamma_alpha, jax=meta["gamma_alpha"],
                         diff=res.gamma_alpha - meta["gamma_alpha"]),
        full_tree=dict(splits, rf_to_fasttree=rf_distance(res.full_tree,
                                                          fasttree),
                       jax_rf_to_fasttree=rf_distance(jax_tree, fasttree)),
        log_likelihood=lls,
        raxml=dict(jax_tree=meta["oracle"]["raxml_ll_ours"],
                   fasttree=meta["oracle"]["raxml_ll_fasttree"]))
    if reps:
        jreps = [parse_newick(x) for x in meta["support_trees"][:reps]]
        prf = [rf_distance(a, b) for a, b in zip(res.support_trees, jreps)]
        index = taxon_index(sorted(cat.taxa))
        pc = bipartition_counts(res.support_trees[:reps], index)
        jc = bipartition_counts(jreps, index)
        jall = bipartition_counts([parse_newick(x)
                                   for x in meta["support_trees"]], index)
        sup = [[pc.get(b, 0), jc.get(b, 0), jall.get(b, 0)]
               for b in sorted(bipartitions(jax_tree, index))]
        out["replicates"] = dict(
            n=reps, jax_n=len(meta["support_trees"]),
            identical_topologies=sum(d == 0 for d in prf),
            rf_histogram={str(k): prf.count(k) for k in sorted(set(prf))},
            supports_on_jax_splits=dict(
                columns=["port_n", "jax_n", "jax_all"], rows=sup),
            max_support_diff=max(abs(a - b) for a, b, _ in sup))
    if not np.isfinite(lls["port"]) or sorted(
            res.full_tree.leaf_labels()) != sorted(cat.taxa):
        fail(f"real data {meta['run']}: the full tree's LL is not finite or "
             "its leaves are not the taxa")
    if splits["rf_long"] and lls["port"] < lls["jax_tree_refit"]:
        fail(f"real data {meta['run']}: the port's tree loses a JAX split "
             f"of >= {REAL_SPLIT_MIN} and scores below the JAX tree: "
             f"{splits}, {lls}")
    if not abs(res.gamma_alpha - meta["gamma_alpha"]) <= REAL_ALPHA_ATOL:
        fail(f"real data {meta['run']}: Gamma shape {res.gamma_alpha} is "
             f"more than {REAL_ALPHA_ATOL} from the JAX run's "
             f"{meta['gamma_alpha']}")
    if ll_rtol is not None and not abs(lls["port"] - lls["jax_run"]) <= \
            ll_rtol * abs(lls["jax_run"]):
        fail(f"real data {meta['run']}: LL {lls['port']} is more than "
             f"{ll_rtol} (relative) from the JAX run's {lls['jax_run']}")
    if reps and (out["replicates"]["identical_topologies"] != reps
                 or out["replicates"]["max_support_diff"] != 0):
        fail(f"real data {meta['run']}: the replicates are not the JAX "
             f"run's: {out['replicates']}")
    return out


def real_data_phase(dev) -> dict:
    """Each of REAL_RUNS through run_stage2_aligned on the card, the
    pruning launch counts reset just before and read just after (both
    kernels must launch), then real_data_compare and path_checks (the
    full tree, and the first replicate block where there are
    replicates).  Prints the real_data line; returns each run's
    path_checks."""
    import torch
    from pepr_tpu_torch.ops import pruning
    from pepr_tpu_torch.parallel.replicates import BLOCK_REPS
    from pepr_tpu_torch.pipeline.stage2 import run_stage2_aligned
    if dict(REAL_RUNS)["aqu"] != BLOCK_REPS:
        fail(f"real_data's aqu replicates are not one block ({BLOCK_REPS})")
    t0 = time.time()
    runs, checks = {}, {}
    for run, reps in REAL_RUNS:
        t = time.time()
        alns, meta = load_realdata(run)
        load_s = time.time() - t
        cfg = real_config(meta, reps)
        torch.cuda.synchronize()
        pruning.reset_launch_counts()
        t = time.time()
        res = run_stage2_aligned(alns, cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.time() - t
        launches = dict(pruning.LAUNCHES)
        for k, n in launches.items():
            if n <= 0:
                fail(f"kernel {k} was not launched on the real_data path "
                     f"({run})")
        t = time.time()
        cmp = real_data_compare(res, meta, reps, dev)
        cmp_s = time.time() - t
        t = time.time()
        checks[run] = path_checks(res, reps, cfg.seed, dev)
        seconds = dict(load=load_s, stage2=wall, compare=cmp_s,
                       path_checks=time.time() - t, **res.timings)
        runs[run] = dict(
            cmp, support_reps=reps, launches=launches,
            seconds={k: round(v, 3) for k, v in seconds.items()},
            **checks[run])
        del res
        torch.cuda.empty_cache()
    phase("real_data", seconds=round(time.time() - t0, 3), runs=runs)
    return checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import numpy as np

    from pepr_tpu_torch import native
    from pepr_tpu_torch.device import resolve_device
    from pepr_tpu_torch.models.concat import concatenate
    from pepr_tpu_torch.models.msa import (ALIGN, Alignment,
                                           reset_align_counts)
    from pepr_tpu_torch.models.support import jackknife_gene_masks
    from pepr_tpu_torch.models.treebuild import (SCORE_BATCH, _postorder_fix,
                                                 _remap_blen, _spr_candidates)
    from pepr_tpu_torch.ops import (_cuda, hmm_kernel, profile_align,
                                    pruning, sw)
    from pepr_tpu_torch.ops.likelihood import (WagModel, transition_matrices,
                                               tree_to_arrays)
    from pepr_tpu_torch.ops.profile_align import (GRAPHS, _Plan,
                                                  nw_profile_batch,
                                                  release_plans,
                                                  reset_graph_counts)
    from pepr_tpu_torch.parallel.replicates import BLOCK_REPS, replicate_codes
    from pepr_tpu_torch.pipeline.stage2 import (Stage2Config, run_stage2,
                                                run_stage2_aligned)
    from pepr_tpu_torch.tree import rf_distance
    from pepr_tpu_torch.tree.bipartition import bipartitions, taxon_index
    from pepr_tpu_torch.utils.simulate import random_tree, simulate_families

    # -- device
    smi = smi_line()
    sm_clock = float(smi_line("clocks.max.sm").split()[0])
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    nvcc_ver = subprocess.run([_cuda.find_nvcc(), "--version"],
                              capture_output=True, text=True, timeout=60,
                              check=True).stdout.strip().splitlines()[-1]
    phase("device", nvidia_smi=smi, max_sm_clock_mhz=sm_clock, name=name,
          capability=list(cap), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc_ver)
    if cap[0] != 9:
        fail(f"needs a Hopper card (capability 9.x), got {cap}")
    dev = resolve_device("cuda")
    warm = warm_rank_imports(_cuda.BUILD_DIR)

    # -- build: every source, one nvcc each, side by side; then the
    # native host library with g++
    t = time.time()
    logs = _cuda.build(force=True)
    pruning.library()
    sw.library()
    hmm_kernel.library()
    cuda_s = time.time() - t
    t = time.time()
    native.build(force=True)
    native.library()
    native_s = time.time() - t
    phase("build", seconds=round(cuda_s + native_s, 3),
          cuda_seconds=round(cuda_s, 3), ptxas={
              n: [ln.strip() for ln in lg.splitlines()
                  if "entry function" in ln or "registers" in ln
                  or "spill" in ln]
              for n, lg in logs.items()},
          native=dict(route="host C++, " + " ".join(
                          (native.COMPILER, *native.FLAGS)),
                      source="pepr_tpu_torch/native/fastio.cpp",
                      library=native.lib_path(),
                      seconds=round(native_s, 3)))

    sw_entry, s1 = stage1_phases(args.seed, dev, sm_clock)
    h = hmm_phases(args.seed, dev, sm_clock)

    # -- data
    rng = np.random.default_rng(args.seed)
    taxa = [f"taxon{i:02d}" for i in range(N_TAXA)]
    truth = random_tree(taxa, rng)
    fams = simulate_families(truth, family_lengths(rng), rng, alpha=0.5,
                             absent=0.1)
    alignments = [Alignment(n, t_, c) for n, t_, c in fams]
    cat = concatenate(alignments, taxa)
    # the same families unaligned, for run_stage2 (deletions from their
    # own generator, so the kernels' inputs stay as they were)
    sets, true_gapped = unaligned_families(
        fams, np.random.default_rng(args.seed + 2))
    residues = sum(int(x.total_residues()) for x in sets)
    phase("data", taxa=N_TAXA, families=len(alignments), columns=cat.length,
          unaligned_residues=residues,
          deleted_residues=int(sum(c.size for _, _, c in fams)) - residues)
    if cat.length != N_COLUMNS:
        fail(f"dataset has {cat.length} columns, expected {N_COLUMNS}")

    # -- kernels: each against its plain version at the slice shape, at
    # the shapes run_stage2_aligned gives them on the true alignments
    # (kept so the numbers stay comparable across PRs), and at the largest
    # tree; the stage2 and pepr phases check them again at the shapes
    # their own runs give them (path_checks)
    model = WagModel.create(alpha=0.5)
    pi = torch.as_tensor(model.pi, device=dev)

    shapes = {}
    # slice: 4 trees x 8,192 columns over shared codes, 1% set to X
    mat = cat.mat[:, :KERNEL_SITES].copy()
    mat[rng.random(mat.shape) < 0.01] = 22
    ch, pm = tree_tensors([truth] + [random_tree(taxa, rng)
                                     for _ in range(KERNEL_TREES - 1)],
                          taxa, model, dev)
    ct = torch.as_tensor(rng.random((KERNEL_TREES, KERNEL_SITES))
                         .astype(np.float32), device=dev)
    codes_s = torch.as_tensor(mat, device=dev)
    # one untimed call first: the plain path's first calls pay for the
    # libraries' set-up
    pruning.site_ll_grad_reference(codes_s, ch, pm, pi, ct)
    shapes["slice"] = dict(
        trees=KERNEL_TREES, sites=KERNEL_SITES, codes="shared",
        **check_kernels(codes_s, ch, pm, pi, ct))
    # full tree: branch-length fitting and LL evaluations of one tree
    codes_full = torch.as_tensor(cat.mat, device=dev)
    ch, pm = tree_tensors([truth], taxa, model, dev)
    shapes["full_tree"] = dict(
        trees=1, sites=cat.length, codes="shared",
        **check_kernels(codes_full, ch, pm, pi,
                        torch.ones((1, cat.length), device=dev)))
    # a block of jackknife replicates, each on its compacted codes with
    # its weights as the cotangent (as in replicate_blopt)
    masks = jackknife_gene_masks(cat, SUPPORT_REPS, Stage2Config().seed)
    codes_r, w_r = replicate_codes(cat.mat, masks[:BLOCK_REPS], dev)
    if codes_r.dim() != 3:
        fail("jackknife replicates did not get compacted codes")
    n_rep = codes_r.shape[0]
    ch, pm = tree_tensors([random_tree(taxa, rng) for _ in range(n_rep)],
                          taxa, model, dev)
    shapes["replicate_block"] = dict(
        trees=n_rep, sites=codes_r.shape[-1], codes="per-replicate",
        **check_kernels(codes_r, ch, pm, pi, w_r, reps=3))
    del codes_r, w_r
    # one batch of SPR candidates of the generating tree (forward only:
    # candidates are scored, not fitted)
    t = time.time()
    truth_arr = tree_to_arrays(truth, taxa)
    spr = _spr_candidates(truth_arr.children, N_TAXA)
    spr_ch = [_postorder_fix(c, N_TAXA) for c in spr[:SCORE_BATCH]]
    spr_bl = [_remap_blen(truth_arr.children, c, truth_arr.blen, N_TAXA)
              for c in spr_ch]
    spr_host_s = time.time() - t
    ch = torch.as_tensor(np.stack(spr_ch), device=dev)
    pm = transition_matrices(model, torch.as_tensor(
        np.stack(spr_bl), device=dev)).contiguous()
    n_spr = len(spr_ch)
    shapes["spr_batch"] = dict(
        trees=n_spr, sites=cat.length, codes="shared",
        spr_candidates_of_tree=len(spr), host_s=round(spr_host_s, 3),
        **check_kernels(codes_full, ch, pm, pi, None, grad=False,
                        plain_trees=range(0, n_spr,
                                          max(1, n_spr // PLAIN_SPR_TREES)),
                        reps=3))
    # the largest tree the kernels take (8,191 nodes), through the spill
    # tiers, on random codes
    big_taxa = [f"big{i:04d}" for i in range(MAX_TREE_TAXA)]
    ch, pm = tree_tensors([random_tree(big_taxa, rng)], big_taxa, model, dev)
    big = rng.integers(0, 20, size=(MAX_TREE_TAXA, MAX_TREE_SITES))
    big[rng.random(big.shape) < 0.1] = 23
    shapes["max_tree"] = dict(
        trees=1, sites=MAX_TREE_SITES, codes="shared",
        taxa=MAX_TREE_TAXA, nodes=MAX_TREE_TAXA + ch.shape[1],
        **check_kernels(torch.as_tensor(big.astype(np.int8), device=dev), ch,
                        pm, pi, torch.as_tensor(
                            rng.random((1, MAX_TREE_SITES)).astype(
                                np.float32), device=dev), reps=2))
    del ch, pm, ct, codes_full, codes_s
    torch.cuda.empty_cache()
    phase("kernels", cats=len(model.rates), shapes=shapes)

    # -- small: the card path against the CPU's plain path
    srng = np.random.default_rng(args.seed + 1)
    stree = random_tree([f"s{i}" for i in range(8)], srng)
    small = [Alignment(n, t_, c) for n, t_, c in
             simulate_families(stree, srng.integers(60, 120, size=8), srng)]
    scfg = Stage2Config(full_tree_method="fast_ml", support_reps=3)
    on_gpu = run_stage2_aligned(small, scfg, device="cuda")
    on_cpu = run_stage2_aligned(small, scfg, device="cpu")
    s_rf = rf_distance(on_gpu.tree, on_cpu.tree)
    s_sup = sorted(v for v in on_gpu.tree.support if v == v)
    c_sup = sorted(v for v in on_cpu.tree.support if v == v)
    s_rel = abs(on_gpu.log_likelihood - on_cpu.log_likelihood) \
        / abs(on_cpu.log_likelihood)
    phase("small", rf_gpu_vs_cpu=s_rf, ll_gpu=on_gpu.log_likelihood,
          ll_cpu=on_cpu.log_likelihood, ll_rel=s_rel,
          supports_gpu=s_sup, supports_cpu=c_sup)
    if s_rf != 0 or s_sup != c_sup or not s_rel <= 1e-4:
        fail("small stage-2 run on the card disagrees with the CPU's")

    # -- small_align: the profile-profile DP on the card against the CPU
    t = time.time()
    arng = np.random.default_rng(args.seed + 3)

    def both(p1, l1, p2, l2):
        host = [torch.as_tensor(x) for x in (p1, p2, l1, l2)]
        s_c, p_c = nw_profile_batch(*host)
        s_g, p_g = nw_profile_batch(*(x.to(dev) for x in host))
        return s_c, p_c, s_g.cpu(), p_g.cpu()

    dyadic, dy_inputs = [], []
    for L1, L2 in ((128, 128), (128, 256), (256, 256)):
        dy_inputs.append((*dyadic_profiles(arng, ALIGN_CHECK_BATCH, L1),
                          *dyadic_profiles(arng, ALIGN_CHECK_BATCH, L2)))
        s_c, p_c, s_g, p_g = both(*dy_inputs[-1])
        same = torch.equal(s_g, s_c) and torch.equal(p_g, p_c)
        dyadic.append([L1, L2, ALIGN_CHECK_BATCH, same])
        if not same:
            fail(f"nw_profile_batch on the card disagrees with the CPU on "
                 f"dyadic profiles at ({L1}, {L2})")
    # the plan cache: release_plans gives back the memory its plans'
    # buffers hold; then, with the cache's share at 0, every new shape
    # evicts the cached plan (while its call may still be queued) and is
    # captured again when it returns, with results still identical
    cached = list(profile_align._PLANS.values())
    cache = dict(plans=len(cached),
                 buffer_bytes=sum(p.nbytes - p.pool_bytes for p in cached),
                 graph_pool_bytes=sum(p.pool_bytes for p in cached))
    del cached
    allocated = torch.cuda.memory_allocated(dev)
    release_plans()
    cache["freed_bytes"] = allocated - torch.cuda.memory_allocated(dev)
    if profile_align._PLANS or cache["freed_bytes"] < cache["buffer_bytes"]:
        fail(f"release_plans did not give back the plans' memory: {cache}")
    share = profile_align.PLAN_CACHE_SHARE
    profile_align.PLAN_CACHE_SHARE = 0.0
    reset_graph_counts()
    try:
        for _ in range(2):
            for arrs in dy_inputs:
                s_c, p_c, s_g, p_g = both(*arrs)
                if not (torch.equal(s_g, s_c) and torch.equal(p_g, p_c)):
                    fail("nw_profile_batch disagrees with the CPU when its "
                         "plans are evicted between calls")
    finally:
        profile_align.PLAN_CACHE_SHARE = share
    cache.update(evicting_run=dict(GRAPHS))
    if GRAPHS["evicted"] != 2 * len(dy_inputs) - 1:
        fail(f"the plan cache evicted {GRAPHS['evicted']} plans, expected "
             f"{2 * len(dy_inputs) - 1}")
    release_plans()
    # the step loop at (ALIGN_CHECK_BATCH, 256, 256): an eager run, its
    # capture as a CUDA graph and a replay, each per DP step
    plan = _Plan(ALIGN_CHECK_BATCH, 256, 256, dev)
    plan.steps()  # warm-up
    step_ms = {}
    for what, fn in (("eager", plan.steps), ("capture", plan.capture),
                     ("replay", lambda: plan.graph.replay())):
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        step_ms[what] = 1e3 * (time.time() - t0) / plan.D
    del plan
    wave = []
    for (L1, L2), arrs in sorted(last_merge_wave(true_gapped).items()):
        s_c, p_c, s_g, p_g = both(*arrs)
        wave.append([L1, L2, len(s_c), int((p_g != p_c).sum()), p_c.numel(),
                     int((s_g != s_c).sum()),
                     float((s_g - s_c).abs().max())])
    small_sets = three_sequence_sets(np.random.default_rng(args.seed + 4))
    on_gpu = run_stage2(small_sets, Stage2Config(**SMALL_S2), device="cuda")
    on_cpu = run_stage2(small_sets, Stage2Config(**SMALL_S2), device="cpu")
    same_aln = len(on_gpu.alignments) == len(on_cpu.alignments) and all(
        np.array_equal(a.mat, b.mat)
        for a, b in zip(on_gpu.alignments, on_cpu.alignments))
    a_rf = rf_distance(on_gpu.tree, on_cpu.tree)
    a_sup = [sorted(v for v in r.tree.support if v == v)
             for r in (on_gpu, on_cpu)]
    a_rel = abs(on_gpu.log_likelihood - on_cpu.log_likelihood) \
        / abs(on_cpu.log_likelihood)
    phase("small_align", seconds=round(time.time() - t, 3),
          dyadic=dict(columns=["L1", "L2", "pairs", "identical"],
                      rows=dyadic),
          step_ms_at_256=step_ms, plan_cache=cache,
          last_wave=dict(columns=["L1", "L2", "pairs", "pointers_differ",
                                  "pointers", "scores_differ",
                                  "score_max_abs_diff"], rows=wave),
          stage2_families=len(small_sets),
          identical_alignments=same_aln, rf_gpu_vs_cpu=a_rf,
          ll_gpu=on_gpu.log_likelihood, ll_cpu=on_cpu.log_likelihood,
          ll_rel=a_rel, supports_gpu=a_sup[0], supports_cpu=a_sup[1])
    if not same_aln or a_rf != 0 or a_sup[0] != a_sup[1] \
            or not a_rel <= 1e-4:
        fail("small run_stage2 on the card disagrees with the CPU's")

    # -- stage2 at full width and default depth, from unaligned families
    cfg = Stage2Config(full_tree_method="ml", support_reps=STAGE2_REPS)
    phase("stage2_start", config=dict(
        full_tree_method="ml", nni_rounds=cfg.nni_rounds,
        bl_steps=cfg.bl_steps, spr_rounds=2, support_reps=cfg.support_reps,
        support_bl_steps=cfg.support_bl_steps,
        cuts=CUTS))
    msgs = _Messages()
    port_log = logging.getLogger("pepr_tpu_torch")
    port_log.setLevel(logging.INFO)
    port_log.addHandler(msgs)
    torch.cuda.synchronize()
    pruning.reset_launch_counts()
    reset_align_counts()
    reset_graph_counts()
    t = time.time()
    res = run_stage2(sets, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = dict(pruning.LAUNCHES)
    planning = dict(pruning.PLANNING)
    align = dict(ALIGN, **GRAPHS)
    port_log.removeHandler(msgs)
    search = [m for m in msgs.lines if m.startswith(("ml_tree", "support"))]
    spr_sweeps = [m for m in search if m.startswith("ml_tree: SPR sweep")]
    rf = rf_distance(res.full_tree, truth)
    sup = [v for v in res.tree.support if v == v]
    plans_left = len(profile_align._PLANS)
    checks = path_checks(res, STAGE2_REPS, cfg.seed, dev)
    phase("stage2", seconds=round(wall, 3), timings=res.timings,
          align=align, families_in=len(sets),
          families_kept=res.concat.n_genes, trimmed_columns=res.concat.length,
          gamma_alpha=res.gamma_alpha, log_likelihood=res.log_likelihood,
          plans_left_after_align=plans_left, rf_vs_generating_tree=rf,
          n_internal_edges=len(bipartitions(res.full_tree,
                                            taxon_index(taxa))),
          supports=sup, launches=launches, planning=planning,
          search=search, **checks)
    if not np.isfinite(res.log_likelihood):
        fail("the log-likelihood is not finite")
    if plans_left:
        fail(f"run_stage2 left {plans_left} DP plans cached after alignment")
    if sorted(res.full_tree.leaf_labels()) != sorted(taxa):
        fail("full tree does not have the dataset's taxa")
    if rf > N_TAXA - 3:
        fail(f"full tree is far from the generating tree (RF {rf})")
    if not sup or min(sup) < 0 or max(sup) > STAGE2_REPS:
        fail(f"supports out of range: {sup}")
    if not spr_sweeps:
        fail("the full-tree search made no SPR sweep")
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the main path")

    s2_trees = (res.full_tree, res.support_trees)
    del res

    # -- stage2_options: stage 2's other options at the same width
    o_checks = stage2_options_phase(alignments, truth, args.seed, dev,
                                    sm_clock)

    # -- real_data: the reference's Aquificales and Erysipelotrichi
    # families through stage 2, against the JAX run's results
    r_checks = real_data_phase(dev)

    # -- tools: per-site LLs of competing trees, the AU test, the six
    # CLIs and the tree-builder comparison
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        t_checks = tools_phase(cat, truth, *s2_trees, s1, args.seed, dev,
                               tmp)
    del s1, s2_trees

    # -- distributed: the mesh at one NCCL rank, four Gloo ranks sharing
    # the card, supports through the mesh, the dry run and entry()
    distributed_phase(cat, truth, model, args.seed, dev, warm)

    # -- pepr: the reference's default run, genomes to the output files,
    # with a checkpoint store; resume: that store re-run, and a small
    # run interrupted and resumed
    with tempfile.TemporaryDirectory() as tmp:
        p_launches, p_checks, first, p_cfg, save_stats, p_wall = \
            pepr_phase(h, dev, sm_clock, tmp)
        resume_phase(first, p_cfg, h, tmp, dev, save_stats, p_wall)
        del first

    # -- profile: device time by kernel over a shallower stage-2 run
    from torch.profiler import ProfilerActivity, profile
    pcfg = Stage2Config(full_tree_method="fast_ml", support_reps=PROFILE_REPS)
    t = time.time()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_stage2_aligned(alignments, pcfg, device="cuda")
        torch.cuda.synchronize()
    phase("profile", config=dict(full_tree_method="fast_ml",
                                 support_reps=PROFILE_REPS),
          **device_time(prof, time.time() - t))

    # the kernels' numbers at the full tree's shape; errors are the
    # largest over every shape checked
    every = list(shapes.values()) + [
        v for c in (checks, p_checks, o_checks["a"], o_checks["b"],
                    o_checks["c"], t_checks, *r_checks.values())
        for v in c["kernel_shapes"].values()]

    def entry(k):
        at = shapes["full_tree"][k]
        errs = [v[k] for v in every if k in v]
        return dict(
            max_abs_err=max(e["max_abs_err"] for e in errs),
            max_rel_err=max(e["max_rel_err"] for e in errs), tol=at["tol"],
            ms=at["ms"], plain_ms=at["plain_ms"], bound_ms=at["bound_ms"],
            bound_by=at["bound_by"], shape="full_tree")

    # launches: the pepr run's (the reference's default run, the main
    # path); no PyTorch call computes any of these functions: no library
    # time
    kernels = [
        dict(name=k, route="cuda", source="pepr_tpu_torch/csrc/pruning.cu",
             replaces=rep, launches=p_launches[k], **entry(k),
             library_ms=None)
        for k, rep in (
            ("pruning_fwd", "pepr_tpu/ops/pallas_pruning.py:113"),
            ("pruning_bwd", "pepr_tpu/ops/pallas_pruning_grad.py:118"))]
    kernels.append(dict(name="sw", route="cuda",
                        source="pepr_tpu_torch/csrc/sw.cu",
                        replaces="pepr_tpu/ops/pallas_sw.py:64",
                        **dict(sw_entry, launches=p_launches["sw"]),
                        library_ms=None))
    kernels.append(dict(name="hmm", route="cuda",
                        source="pepr_tpu_torch/csrc/hmm.cu",
                        replaces="pepr_tpu/ops/hmm.py:206",
                        note="not a TPU kernel (XLA scan in the reference)",
                        launches=p_launches["hmm"], **h["entry"],
                        library_ms=None))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
