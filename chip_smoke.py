"""Drive the port's stage-1 and stage-2 paths once on one NVIDIA H100
and check them.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line with the elapsed seconds:
  device   nvidia-smi name, power limit and max SM clock, capability (9.x
           required), torch and nvcc versions
  build    nvcc builds every pepr_tpu_torch/csrc/*.cu for sm_90a, one
           process per source side by side, into the git-ignored
           pepr_tpu_torch/_build/; ptxas registers and spills per kernel
  data_stage1   seeded genomes at the shape of the Aquificales example:
           11 ingroup genomes and 1 outgroup-pool genome of ~1,140
           proteins (~1,300 WAG families, lengths lognormal around 306,
           3 families of 2,100-2,600 residues, 100 random proteins each)
  sw_kernel  the SW kernel against its plain PyTorch version on the card:
           up to 256 real pairs of the stage-1 pair list from every
           length bucket (BLOSUM62 11/1), the planted ties of
           planted_tie_pairs (two top cells either side of a strip or
           lane boundary of the kernel's walk, or in one row; query
           lengths 255-257 and 511-513) and one bucket of planted ACGT
           pairs under blastn 5/2; all five outputs must be equal (the
           plain version's time on each bucket's pairs is printed); the
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
           families in >= 2 ingroup genomes recovered as clean groups
  profile_stage1  torch.profiler's device time by kernel over a second
           full stage-1 run, so the stage1 time carries no profiler
  data     the seeded 53-taxon dataset: 405 WAG+Gamma(0.5) families of
           100-250 columns, 64,433 concatenated columns, ~10% of the
           taxa absent from each family
  kernels  each kernel against its plain PyTorch version on the card,
           with times over repeated launches, at the slice shape (4
           trees x 8,192 sites), at the shapes run_stage2_aligned gives
           the kernels on the true alignments: the full tree (1 x 64,433
           sites), a block of jackknife replicates on their compacted
           per-replicate codes, and a batch of SPR candidates scored
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
  stage2   run_stage2 at full width and the pipeline's default depth
           (`ml` full tree, SUPPORT_REPS jackknife replicates) from the
           405 families unaligned, each sequence with 0-3 seeded
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
           replicates)
  genomes_to_tree  the stage1 phase's homolog groups through run_stage2,
           its config derived from the genome count as the pipeline
           derives it (fast_ml, G2T_REPS replicates): the tree's leaves
           must be the 11 ingroup genomes and the selected outgroup;
           RF against the generating tree; path_checks as in stage2
  profile  torch.profiler's device time by kernel over a shallower
           stage-2 run from the true alignments (run_stage2_aligned,
           fast_ml, PROFILE_REPS replicates), so the stage2 time above
           carries no profiler overhead
Then one JSON line with every kernel's numbers, the nvidia-smi line,
and the result line.  Any failure ends the run with a non-zero exit;
without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import logging
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
SW_CHECK_PAIRS = 256  # pairs per bucket held against the plain version
RECOVERY_FLOOR = 0.5  # a broken path recovers far fewer families

N_TAXA = 53
N_FAMILIES = 405
N_COLUMNS = 64433
KERNEL_SITES = 8192
KERNEL_TREES = 4
SUPPORT_REPS = 100  # the pipeline's default
PROFILE_REPS = 8
MAX_TREE_TAXA = 4096  # a rooted tree of 8,191 nodes: the kernels' limit
MAX_TREE_SITES = 256
# stage 2 from unaligned families: per sequence 0-3 deleted stretches of
# 1-8 residues (the simulator makes no indels)
DELETIONS = (0, 3)
DELETION_LEN = (1, 8)
ALIGN_CHECK_BATCH = 32  # profile pairs per bucket in small_align
G2T_REPS = 8  # jackknife replicates of genomes_to_tree
MIN_TAXA_MULTIPLIER = 0.8  # the pipeline's default (PeprConfig)
PLAIN_SPR_TREES = 32  # SPR candidates of the batch held against the plain
# version (one every SCORE_BATCH / PLAIN_SPR_TREES)
PLAIN_REP_TREES = 8  # replicates of a path's block held against the plain
# version
FINAL_LL_RTOL = 1e-5  # a path's final LL, kernel against the plain path
FWD_RTOL = 1e-5  # per-site LL, elementwise (plus 1e-5 absolute)
BWD_RTOL = 1e-4  # gradient, max |diff| over max |ref| (summation order)


def phase(label: str, **info) -> None:
    print(json.dumps({"phase": label,
                      "elapsed_s": round(time.time() - T0, 3), **info}),
          flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


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


def three_sequence_sets(rng, n_families: int = 12):
    """`n_families` homolog groups of 3 sequences each, drawn from 6 taxa
    and evolved down one random tree, with seeded deletions."""
    from pepr_tpu_torch.utils.simulate import random_tree, simulate_families
    taxa = [f"T{i}" for i in range(6)]
    tree = random_tree(taxa, rng, scale=0.1)
    fams = simulate_families(tree, rng.integers(80, 160, size=n_families),
                             rng, alpha=0.5, absent=0.5, min_taxa=3)
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


def genomes_to_tree_config(n_genomes: int, n_selected: int, reps: int):
    """Stage 2's config as the pipeline derives it from the genome count
    (`pepr_tpu/pipeline/pepr.py:140-148` with PeprConfig's defaults), at
    the `fast_ml` method and `reps` replicates."""
    from pepr_tpu_torch.pipeline.stage2 import Stage2Config
    min_taxa = max(int(n_genomes * MIN_TAXA_MULTIPLIER), 3)
    return Stage2Config(min_taxa=min_taxa, max_taxa=n_genomes + n_selected,
                        full_tree_method="fast_ml", support_reps=reps)


def genomes_to_tree(s1: dict, dev, reps: int = G2T_REPS) -> tuple:
    """Stage 1's homolog groups through run_stage2: (result, the leaves
    the tree should have, RF against the generating tree)."""
    from pepr_tpu_torch.pipeline.stage2 import run_stage2
    from pepr_tpu_torch.tree import rf_distance
    cfg = genomes_to_tree_config(len(s1["ingroup"]), len(s1["selected"]),
                                 reps)
    res = run_stage2(s1["hg_sets"], cfg, device=dev)
    want = sorted([g.taxon for g in s1["ingroup"]] + list(s1["selected"]))
    return res, want, rf_distance(res.tree, s1["truth"])


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
                  reps=5):
    """Both wrappers (the gradient only if `grad`) against their plain
    versions on the same card tensors, tree by tree for the plain side
    (`plain_trees`: the trees held against it, default all); returns
    {kernel: numbers} and fails the run beyond tolerance, on spill counts
    that disagree, or on two gradient launches that differ in any bit."""
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
        del g_k
        if not ok:
            fail(f"pruning_bwd disagrees with its plain version: "
                 f"{out['pruning_bwd']}")
        if not same:
            fail("two pruning_bwd launches on the same inputs differ")
    for k, v in out.items():
        v["bound_ms"], v["bound_by"] = bounds[k]
    torch.cuda.empty_cache()
    return out


def path_checks(res, reps: int, seed: int, dev) -> dict:
    """The kernels at the shapes a run_stage2 run gave them, each against
    its plain version (check_kernels): the run's full tree over its
    trimmed concatenation, and the first block of its jackknife
    replicates (its own support trees) on their compacted codes, under
    the run's Gamma shape; and the full tree's LL by the kernel against
    the plain path.  Called after the run's launch counts are read."""
    import numpy as np
    import torch
    from pepr_tpu_torch.models.support import jackknife_gene_masks
    from pepr_tpu_torch.ops import pruning
    from pepr_tpu_torch.ops.likelihood import (WagModel, loglik,
                                               transition_matrices,
                                               tree_to_arrays)
    from pepr_tpu_torch.parallel.replicates import BLOCK_REPS, replicate_codes
    cat = res.concat
    model = WagModel.create(alpha=res.gamma_alpha)
    pi = torch.as_tensor(model.pi, device=dev)

    def batch(trees):
        arrs = [tree_to_arrays(tr, cat.taxa) for tr in trees]
        ch = torch.as_tensor(np.stack([a.children for a in arrs]),
                             device=dev)
        blen = torch.as_tensor(np.stack([a.blen for a in arrs]), device=dev)
        return arrs, ch, transition_matrices(model, blen).contiguous()

    arrs, ch, pm = batch([res.full_tree])
    codes = torch.as_tensor(cat.mat, device=dev)
    ll_kernel = loglik(cat.mat, arrs[0].children, arrs[0].blen, model,
                       device=dev)
    with torch.no_grad():
        ll_plain = float(pruning.site_ll_reference(codes, ch, pm, pi)
                         .double().sum())
    ll_rel = abs(ll_kernel - ll_plain) / abs(ll_plain)
    if not np.isfinite(ll_kernel) or not ll_rel <= FINAL_LL_RTOL:
        fail(f"final log-likelihood {ll_kernel} is not finite or disagrees "
             f"with the plain path's {ll_plain}")
    shapes = {"full_tree": dict(
        trees=1, sites=cat.length, codes="shared",
        **check_kernels(codes, ch, pm, pi,
                        torch.ones((1, cat.length), device=dev)))}
    del codes
    masks = jackknife_gene_masks(cat, reps, seed)
    codes_r, w_r = replicate_codes(cat.mat, masks[:BLOCK_REPS], dev)
    n_rep = w_r.shape[0]
    _, ch, pm = batch(res.support_trees[:n_rep])
    shapes["replicate_block"] = dict(
        trees=n_rep, sites=codes_r.shape[-1],
        codes="per-replicate" if codes_r.dim() == 3 else "shared",
        **check_kernels(codes_r, ch, pm, pi, w_r, reps=3, plain_trees=range(
            0, n_rep, max(1, n_rep // PLAIN_REP_TREES))))
    del codes_r, w_r, ch, pm
    torch.cuda.empty_cache()
    return dict(final_ll_kernel=ll_kernel, final_ll_plain=ll_plain,
                final_ll_rel=ll_rel, kernel_shapes=shapes)


def device_time(prof, wall: float) -> dict:
    """Device time by kernel name from a torch.profiler run, and the
    device's busy share of the wall time."""
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


def stage1_phases(seed: int, dev, sm_clock_mhz: float) -> dict:
    """The stage-1 path: data_stage1, sw_kernel, small_stage1, stage1 and
    profile_stage1; returns the SW kernel's entry of the kernels line
    (`entry`) and what genomes_to_tree takes on: the stage1 phase's
    homolog groups and selected outgroups, the ingroup genomes and the
    generating tree."""
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
    ingroup, pool, truth = stage1_genomes(seed)
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

    checked, n_embedded = [], 0
    for (blq, blt), idx in buckets.items():
        take = idx[np.linspace(0, len(idx) - 1,
                               min(len(idx), SW_CHECK_PAIRS)).astype(int)]
        q, tt = gather(take, blq, blt)
        got = sw.sw_align(q, tt, sub)
        want, plain_ms = timed(lambda: sw_align_batch(q, tt, sub))
        compare(got, want, f"bucket ({blq}, {blt})")
        # PAD tails: the same pairs in a larger bucket, all five outputs
        # identical
        qe, te = embedded(q, tt)
        if qe.shape != q.shape or te.shape != tt.shape:
            compare(sw.sw_align(qe, te, sub), got,
                    f"bucket ({blq}, {blt}) embedded in {tuple(qe.shape[1:])}"
                    f" x {tuple(te.shape[1:])}")
            n_embedded += 1
        checked.append([blq, blt, len(idx), len(take), plain_ms])
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
              columns=["blq", "blt", "pairs", "checked", "plain_ms"],
              rows=checked),
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

    # -- stage1 at full size
    cfg = Stage1Config(use_hmm=False, outgroup_count=2)
    torch.cuda.synchronize()
    sw.reset_launch_counts()
    t = time.time()
    res = run_stage1(ingroup, pool, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = sw.LAUNCHES["sw"]
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
          recovered_share=rec / max(elig, 1))
    if launches <= 0:
        fail("the SW kernel was not launched on the stage-1 path")
    if pool[0].taxon not in res.selected_outgroups:
        fail(f"the pool genome was not selected: {res.selected_outgroups}")
    if rec < RECOVERY_FLOOR * elig:
        fail(f"only {rec} of {elig} families recovered")
    entry["launches"] = launches

    # -- profile_stage1: device time by kernel over a second full run
    from torch.profiler import ProfilerActivity, profile
    t = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_stage1(ingroup, pool, cfg, device="cuda")
        torch.cuda.synchronize()
    phase("profile_stage1", **device_time(prof, time.time() - t))
    return dict(entry=entry, hg_sets=res.hg_sets,
                selected=res.selected_outgroups, ingroup=ingroup, truth=truth)


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

    from pepr_tpu_torch.device import resolve_device
    from pepr_tpu_torch.models.concat import concatenate
    from pepr_tpu_torch.models.msa import (ALIGN, Alignment,
                                           reset_align_counts)
    from pepr_tpu_torch.models.support import jackknife_gene_masks
    from pepr_tpu_torch.models.treebuild import (SCORE_BATCH, _postorder_fix,
                                                 _remap_blen, _spr_candidates)
    from pepr_tpu_torch.ops import _cuda, profile_align, pruning, sw
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

    # -- build: every source, one nvcc each, side by side
    t = time.time()
    logs = _cuda.build(force=True)
    pruning.library()
    sw.library()
    phase("build", seconds=round(time.time() - t, 3), ptxas={
        n: [ln.strip() for ln in lg.splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln]
        for n, lg in logs.items()})

    s1 = stage1_phases(args.seed, dev, sm_clock)

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
    # tree; the stage2 and genomes_to_tree phases check them again at the
    # shapes their own runs give them (path_checks)
    model = WagModel.create(alpha=0.5)
    pi = torch.as_tensor(model.pi, device=dev)

    def tree_batch(trs, names=taxa):
        arrs = [tree_to_arrays(tr, names) for tr in trs]
        ch = torch.as_tensor(np.stack([a.children for a in arrs]),
                             device=dev)
        blen = torch.as_tensor(np.stack([a.blen for a in arrs]), device=dev)
        return ch, transition_matrices(model, blen).contiguous()

    shapes = {}
    # slice: 4 trees x 8,192 columns over shared codes, 1% set to X
    mat = cat.mat[:, :KERNEL_SITES].copy()
    mat[rng.random(mat.shape) < 0.01] = 22
    ch, pm = tree_batch([truth] + [random_tree(taxa, rng)
                                   for _ in range(KERNEL_TREES - 1)])
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
    ch, pm = tree_batch([truth])
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
    ch, pm = tree_batch([random_tree(taxa, rng) for _ in range(n_rep)])
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
    ch, pm = tree_batch([random_tree(big_taxa, rng)], big_taxa)
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
    cfg = Stage2Config(full_tree_method="ml", support_reps=SUPPORT_REPS)
    phase("stage2_start", config=dict(
        full_tree_method="ml", nni_rounds=cfg.nni_rounds,
        bl_steps=cfg.bl_steps, spr_rounds=2, support_reps=cfg.support_reps,
        support_bl_steps=cfg.support_bl_steps))
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
    checks = path_checks(res, SUPPORT_REPS, cfg.seed, dev)
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
    if not sup or min(sup) < 0 or max(sup) > SUPPORT_REPS:
        fail(f"supports out of range: {sup}")
    if not spr_sweeps:
        fail("the full-tree search made no SPR sweep")
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the main path")

    # -- genomes_to_tree: stage 1's homolog groups through run_stage2
    del res
    torch.cuda.synchronize()
    pruning.reset_launch_counts()
    reset_align_counts()
    reset_graph_counts()
    t = time.time()
    g_res, g_want, g_rf = genomes_to_tree(s1, "cuda")
    torch.cuda.synchronize()
    g_wall = time.time() - t
    g_launches = dict(pruning.LAUNCHES)
    g_align = dict(ALIGN, **GRAPHS)
    g_cfg = genomes_to_tree_config(len(s1["ingroup"]), len(s1["selected"]),
                                   G2T_REPS)
    g_sup = [v for v in g_res.tree.support if v == v]
    g_checks = path_checks(g_res, g_cfg.support_reps, g_cfg.seed, dev)
    phase("genomes_to_tree", seconds=round(g_wall, 3),
          timings=g_res.timings, align=g_align,
          config=dict(min_taxa=g_cfg.min_taxa, max_taxa=g_cfg.max_taxa,
                      full_tree_method=g_cfg.full_tree_method,
                      support_reps=g_cfg.support_reps),
          groups_in=len(s1["hg_sets"]), families_kept=g_res.concat.n_genes,
          trimmed_columns=g_res.concat.length,
          leaves=sorted(g_res.tree.leaf_labels()),
          log_likelihood=g_res.log_likelihood, gamma_alpha=g_res.gamma_alpha,
          rf_vs_generating_tree=g_rf, supports=g_sup, launches=g_launches,
          **g_checks)
    if sorted(g_res.tree.leaf_labels()) != g_want:
        fail(f"genomes_to_tree: the tree's leaves are not the {len(g_want)} "
             f"genomes {g_want}")
    if not np.isfinite(g_res.log_likelihood):
        fail("genomes_to_tree: the log-likelihood is not finite")
    for k, n in g_launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the genomes_to_tree path")
    del g_res

    # -- profile: device time by kernel over a shallower stage-2 run
    from torch.profiler import ProfilerActivity, profile
    pcfg = Stage2Config(full_tree_method="fast_ml", support_reps=PROFILE_REPS)
    t = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_stage2_aligned(alignments, pcfg, device="cuda")
        torch.cuda.synchronize()
    phase("profile", config=dict(full_tree_method="fast_ml",
                                 support_reps=PROFILE_REPS),
          **device_time(prof, time.time() - t))

    # the kernels' numbers at the full tree's shape; errors are the
    # largest over every shape checked
    every = list(shapes.values()) + [
        v for c in (checks, g_checks) for v in c["kernel_shapes"].values()]

    def entry(k):
        at = shapes["full_tree"][k]
        errs = [v[k] for v in every if k in v]
        return dict(
            max_abs_err=max(e["max_abs_err"] for e in errs),
            max_rel_err=max(e["max_rel_err"] for e in errs), tol=at["tol"],
            ms=at["ms"], plain_ms=at["plain_ms"], bound_ms=at["bound_ms"],
            bound_by=at["bound_by"], shape="full_tree")

    kernels = [
        dict(name=k, route="cuda", source="pepr_tpu_torch/csrc/pruning.cu",
             replaces=rep, launches=launches[k], **entry(k),
             library_ms=None)
        for k, rep in (
            ("pruning_fwd", "pepr_tpu/ops/pallas_pruning.py:113"),
            ("pruning_bwd", "pepr_tpu/ops/pallas_pruning_grad.py:118"))]
    # no PyTorch call computes Smith-Waterman: no library time
    kernels.append(dict(name="sw", route="cuda",
                        source="pepr_tpu_torch/csrc/sw.cu",
                        replaces="pepr_tpu/ops/pallas_sw.py:64",
                        **s1["entry"], library_ms=None))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
