"""Compare two checkouts of the port on one H100, in turns.

    python3 chip_turns.py --old DIR [--new DIR] [--out FILE]
    python3 chip_turns.py --sw-buckets DIR

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
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
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
    args = ap.parse_args(argv)
    if args.sw_buckets:
        print(json.dumps(sw_buckets_of(args.sw_buckets)), flush=True)
        return 0
    if not args.old:
        ap.error("--old is required")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
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
