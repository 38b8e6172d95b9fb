"""Compare two checkouts of the port on one H100, in turns.

    python3 chip_turns.py --old DIR [--new DIR] [--out FILE]
    python3 chip_turns.py --sw-buckets DIR
    python3 chip_turns.py --hmm --old DIR [--new DIR] [--out FILE]
    python3 chip_turns.py --hmm-pairs FILE
    python3 chip_turns.py --hmm-buckets DIR --pairs FILE

Each checkout (the root of a tree holding `chip_smoke.py` and
`pepr_tpu_torch/`, for example an earlier commit unpacked with `git
archive`) runs its own `chip_smoke.py` in a process of its own, in the
order old, new, new, old, so that both are measured on the same card
under the same conditions.  From each run it keeps the wall time, the
kernels phase (each pruning kernel's milliseconds, bound and plain time
at the slice, full-tree, replicate-block and SPR-batch shapes), the
stage2 phase (its seconds and launch counts), the profile phase, and
the sw_kernel, stage1 and profile_stage1 phases.  After each run, a
second process times that checkout's SW kernel on every bucket of the
stage-1 pair list, cut into launches as the main path cuts them
(`chip_smoke.sw_bucket_table` of this tree, with `pepr_tpu_torch`
imported from the checkout: `--sw-buckets DIR`, which prints that table
as one JSON line).  Prints one JSON line per turn, then a summary line,
and writes all of it to FILE (default chip_turns.json in the working
directory).  Exits non-zero if a run fails.

`--hmm` compares the two checkouts' HMM kernels alone, on the pairs the
HMM enhancer scores in chip_smoke.py's stage1_hmm phase: `--hmm-pairs
FILE` runs this tree's stage-1 pipeline (use_hmm=True) on that phase's
input up to the scorer and pickles its (sequences, profiles, pairs);
then, in turns old, new, new, old, a process of its own for each runs
`--hmm-buckets DIR --pairs FILE`, which times DIR's kernel on every
launch of DIR's own plan (its chip_smoke.py's per-launch or per-bucket
table), the first launch of the reference bucket with the most padded
cells (the largest launch), and DIR's `profile_score_pairs` on all the
pairs end to end, twice, and prints one JSON line.  The summary gives
each turn's totals beside the MUFU bound of the pairs' real cells.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

KERNELS = ("pruning_fwd", "pruning_bwd")
SHAPES = ("slice", "full_tree", "replicate_block", "spr_batch")
RUN_TIMEOUT_S = 900
HERE = os.path.dirname(os.path.abspath(__file__))


def json_lines(text: str) -> list:
    out = []
    for line in text.splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            continue
    return out


def run_checkout(root: str) -> dict:
    """Run `root`'s chip_smoke.py; returns its wall time and phases."""
    t = time.time()
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root,
                          capture_output=True, text=True,
                          timeout=RUN_TIMEOUT_S)
    wall = time.time() - t
    objs = json_lines(proc.stdout)
    phases = {o["phase"]: o for o in objs
              if isinstance(o, dict) and "phase" in o}
    last = objs[-1] if objs else None
    if proc.returncode != 0 or not (isinstance(last, dict) and last.get("ok")):
        raise SystemExit(f"chip_turns: chip_smoke.py in {root} failed "
                         f"(exit {proc.returncode}):\n{proc.stderr[-4000:]}")
    return dict(wall_s=wall, phases=phases)


def run_buckets(root: str) -> dict:
    """This script's --sw-buckets mode on `root`, in a process of its
    own; returns the table."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--sw-buckets", os.path.abspath(root)], cwd=root,
                          capture_output=True, text=True,
                          timeout=RUN_TIMEOUT_S)
    objs = json_lines(proc.stdout)
    if proc.returncode != 0 or not objs:
        raise SystemExit(f"chip_turns: the SW bucket table of {root} failed "
                         f"(exit {proc.returncode}):\n{proc.stderr[-4000:]}")
    return objs[-1]


def sw_buckets_of(root: str, seed: int = 0) -> dict:
    """The per-bucket table of `root`'s SW kernel (see the module doc)."""
    sys.path.insert(0, root)
    import torch

    from pepr_tpu_torch.ops import sw
    from pepr_tpu_torch.ops.smith_waterman import kernel_matrix
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if not torch.cuda.is_available():
        raise SystemExit("chip_turns: no CUDA device")
    dev = torch.device("cuda")
    sm_clock = float(smoke.smi_line("clocks.max.sm").split()[0])
    ingroup, _ = smoke.stage1_genomes(seed)
    _, ulens, eff_q, eff_t, buckets, codes = smoke.stage1_pair_list(ingroup,
                                                                    dev)
    table = smoke.sw_bucket_table(ulens, eff_q, eff_t, buckets, codes,
                                  sw.integer_sub(kernel_matrix(), dev), dev,
                                  sm_clock)
    return dict(checkout=root, package=os.path.dirname(sw.__file__),
                card=smoke.smi_line(), **table)


def load_smoke(root: str):
    """`root`'s chip_smoke.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


class _Recorded(Exception):
    pass


def hmm_pairs(path: str, seed: int = 0) -> dict:
    """This tree's stage1_hmm input run on the card up to the HMM scorer;
    pickles its (sequences, profiles as field dicts, pairs) to `path`."""
    import dataclasses
    import torch
    from pepr_tpu_torch.models import hmm_enhancer
    from pepr_tpu_torch.pipeline.stage1 import Stage1Config, run_stage1
    smoke = load_smoke(HERE)
    if not torch.cuda.is_available():
        raise SystemExit("chip_turns: no CUDA device")
    ingroup, pool, _ = smoke.pepr_genomes(seed)
    got = {}

    def record(seqs, hmms, pairs, **kw):
        got.update(seqs=list(seqs), pairs=list(pairs),
                   hmms=[dataclasses.asdict(h) for h in hmms])
        raise _Recorded

    orig = hmm_enhancer.profile_score_pairs
    hmm_enhancer.profile_score_pairs = record
    t = time.time()
    try:
        run_stage1(ingroup, pool, Stage1Config(use_hmm=True,
                                               outgroup_count=2),
                   device="cuda")
    except _Recorded:
        pass
    finally:
        hmm_enhancer.profile_score_pairs = orig
    if not got:
        raise SystemExit("chip_turns: stage 1 never reached the HMM scorer")
    with open(path, "wb") as fh:
        pickle.dump(got, fh, protocol=4)
    return dict(pairs=len(got["pairs"]), profiles=len(got["hmms"]),
                sequences=len(got["seqs"]), seconds=round(time.time() - t, 3))


def hmm_buckets_of(root: str, pairs_path: str) -> dict:
    """`root`'s HMM kernel on the pickled pairs (see the module doc)."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from pepr_tpu_torch.ops import hmm, hmm_kernel
    smoke = load_smoke(root)
    if not torch.cuda.is_available():
        raise SystemExit("chip_turns: no CUDA device")
    dev = torch.device("cuda")
    sm_clock = float(smoke.smi_line("clocks.max.sm").split()[0])
    with open(pairs_path, "rb") as fh:
        got = pickle.load(fh)
    call = (got["seqs"], [hmm.ProfileHMM(**d) for d in got["hmms"]],
            got["pairs"])
    hmm_kernel.library()
    p = smoke.hmm_packs(call, dev)
    if hasattr(smoke, "hmm_launch_table"):  # one launch a pack
        rows, _ = smoke.hmm_launch_table(p, dev, sm_clock)
        columns = smoke.HMM_LAUNCH_COLUMNS
    else:  # the reference's buckets
        rows = smoke.hmm_bucket_table(p, dev, sm_clock)
        columns = ["lpad", "mpad", "pairs", "launches", "real_cells",
                   "padded_cells", "ms", "bound_ms", "bound_share"]
    ms = [r[columns.index("ms")] for r in rows]
    buckets = [b for _, q in sorted(p["packs"].items())
               for b in (q["buckets"] if isinstance(q, dict) else q[2])]
    b = max(buckets, key=lambda x: len(x.pairs) * x.lpad * x.mpad)
    args, real, _ = smoke.hmm_launch(p, b, b.launches()[0], dev)
    largest_ms = smoke.time_ms(lambda: hmm_kernel.hmm_score(*args, True),
                               reps=3)
    del p, args
    scorer_s, counts = [], {}
    for _ in range(2):
        hmm_kernel.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.time()
        hmm.profile_score_pairs(*call, device="cuda", counts=counts)
        torch.cuda.synchronize()
        scorer_s.append(round(time.time() - t, 4))
    return dict(checkout=root, package=os.path.dirname(hmm.__file__),
                card=smoke.smi_line(), sm_clock_mhz=sm_clock,
                columns=columns, rows=rows, launches=len(rows),
                ms=round(float(np.sum(ms)), 4), largest_launch=dict(
                    shape=[min(b.eff, len(b.pairs)), b.lpad, b.mpad],
                    real_cells=real, ms=largest_ms),
                scorer_s=scorer_s, scorer_launches=dict(hmm_kernel.LAUNCHES),
                real_cells=counts["real_cells"],
                padded_cells=counts["padded_cells"])


def run_mode(root: str, *flags: str) -> dict:
    """This script with `flags` in a process of its own, in `root`;
    returns its last JSON line."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           *flags], cwd=root, capture_output=True, text=True,
                          timeout=RUN_TIMEOUT_S)
    objs = json_lines(proc.stdout)
    if proc.returncode != 0 or not objs:
        raise SystemExit(f"chip_turns: {' '.join(flags)} in {root} failed "
                         f"(exit {proc.returncode}):\n{proc.stderr[-4000:]}")
    return objs[-1]


def hmm_turns(args, smi: str) -> int:
    """The --hmm comparison: pairs once, then old, new, new, old."""
    tmp = tempfile.mkdtemp(prefix="hmm_pairs_")
    try:
        pairs_path = os.path.abspath(args.pairs or os.path.join(tmp, "pairs.pkl"))
        made = {"pairs_file": pairs_path} if args.pairs else run_mode(
            HERE, "--hmm-pairs", pairs_path)
        print(json.dumps(dict(hmm_pairs=made)), flush=True)
        turns = []
        for label in ("old", "new", "new", "old"):
            root = os.path.abspath(getattr(args, label))
            res = run_mode(root, "--hmm-buckets", root, "--pairs", pairs_path)
            turn = dict(turn=len(turns) + 1, label=label, **res)
            print(json.dumps(turn), flush=True)
            turns.append(turn)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    smoke = load_smoke(HERE)
    real, clock = turns[0]["real_cells"], turns[0]["sm_clock_mhz"]
    bounds = {n: smoke.hmm_bound(real, 0, clock, n)[0]
              for n in (smoke.HMM_MUFU_PER_CELL,
                        smoke.HMM_MUFU_PER_CELL_PAIRWISE)}
    summary = dict(
        card=smi, order=[t["label"] for t in turns], pairs=made,
        real_cells=real, padded_cells=turns[0]["padded_cells"],
        launches=[t["launches"] for t in turns],
        ms=[t["ms"] for t in turns],
        largest_launch_ms=[t["largest_launch"]["ms"] for t in turns],
        scorer_s=[t["scorer_s"] for t in turns],
        bound_ms={f"mufu_{n}": round(v, 4) for n, v in bounds.items()},
        share={f"mufu_{n}": [round(v / t["ms"], 4) for t in turns]
               for n, v in bounds.items()})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(dict(summary=summary, turns=turns), fh, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


def kernel_times(phases: dict) -> dict:
    """{shape: {kernel: {ms, bound_ms, plain_ms}}} of the kernels phase."""
    out = {}
    for shape in SHAPES:
        at = phases["kernels"]["shapes"][shape]
        out[shape] = {k: {f: at[k][f] for f in ("ms", "bound_ms", "plain_ms")}
                      for k in KERNELS if k in at}
    return out


def sw_device_s(profile: dict):
    """The SW kernel's device seconds and calls in a profile_stage1 line,
    summed over its template instances."""
    rows = [r for r in profile.get("top", []) if "sw_kernel" in r["name"]]
    if not rows:
        return None, None
    return (round(sum(r["seconds"] for r in rows), 4),
            sum(r["calls"] for r in rows))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", help="root of the old checkout")
    ap.add_argument("--new", default=HERE,
                    help="root of the new checkout (default: this one)")
    ap.add_argument("--out", default="chip_turns.json")
    ap.add_argument("--sw-buckets", metavar="DIR",
                    help="print the per-bucket SW table of DIR's kernel")
    ap.add_argument("--hmm", action="store_true",
                    help="compare the checkouts' HMM kernels alone")
    ap.add_argument("--hmm-pairs", metavar="FILE",
                    help="pickle the stage1_hmm scorer's input to FILE")
    ap.add_argument("--hmm-buckets", metavar="DIR",
                    help="time DIR's HMM kernel on the pairs of --pairs")
    ap.add_argument("--pairs", metavar="FILE",
                    help="the pickle of --hmm-pairs (made anew if not "
                    "given with --hmm)")
    args = ap.parse_args(argv)
    if args.sw_buckets:
        print(json.dumps(sw_buckets_of(args.sw_buckets)), flush=True)
        return 0
    if args.hmm_pairs:
        print(json.dumps(hmm_pairs(args.hmm_pairs)), flush=True)
        return 0
    if args.hmm_buckets:
        if not args.pairs:
            ap.error("--hmm-buckets needs --pairs")
        print(json.dumps(hmm_buckets_of(args.hmm_buckets, args.pairs)),
              flush=True)
        return 0
    if not args.old:
        ap.error("--old is required")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    if args.hmm:
        return hmm_turns(args, smi)
    turns = []
    for label in ("old", "new", "new", "old"):
        res = run_checkout(getattr(args, label))
        ph = res["phases"]
        swk = {k: v for k, v in ph["sw_kernel"].items()
               if k not in ("buckets_checked", "per_bucket")}
        turn = dict(turn=len(turns) + 1, checkout=label,
                    wall_s=round(res["wall_s"], 3),
                    stage2_s=ph["stage2"]["seconds"],
                    stage2_timings=ph["stage2"]["timings"],
                    stage2_launches=ph["stage2"]["launches"],
                    stage2_planning=ph["stage2"].get("planning"),
                    profile=ph.get("profile"), kernels=kernel_times(ph),
                    sw_kernel=swk, stage1=ph["stage1"],
                    profile_stage1=ph["profile_stage1"],
                    sw_buckets=run_buckets(getattr(args, label)))
        print(json.dumps(turn), flush=True)
        turns.append(turn)
    summary = dict(
        card=smi, order=[t["checkout"] for t in turns],
        wall_s=[t["wall_s"] for t in turns],
        stage2_s=[t["stage2_s"] for t in turns],
        kernels={s: {k: [t["kernels"][s][k]["ms"] for t in turns]
                     for k in KERNELS if k in turns[0]["kernels"][s]}
                 for s in SHAPES},
        sw_dominant_ms=[t["sw_kernel"]["ms"] for t in turns],
        sw_dominant_bound_ms=[t["sw_kernel"]["bound_ms"] for t in turns],
        sw_buckets_ms=[t["sw_buckets"]["ms"] for t in turns],
        sw_buckets_bound_ms=[t["sw_buckets"]["bound_ms"] for t in turns],
        stage1_s=[t["stage1"]["seconds"] for t in turns],
        stage1_sw_s=[t["stage1"]["timings"]["sw"] for t in turns],
        sw_kernel_device_s=[sw_device_s(t["profile_stage1"])
                            for t in turns])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(dict(summary=summary, turns=turns), fh, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
