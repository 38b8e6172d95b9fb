"""Compare two checkouts of the port on one H100, in turns.

    python3 pruning_turns.py --old DIR [--new DIR] [--out FILE]

Each checkout (the root of a tree holding `chip_smoke.py` and
`pepr_tpu_torch/`, for example an earlier commit unpacked with `git
archive`) runs its own `chip_smoke.py` in a process of its own, in the
order old, new, new, old, so that both are measured on the same card
under the same conditions.  From each run it keeps the wall time, the
kernels phase (each pruning kernel's milliseconds, bound and plain time
at the slice, full-tree, replicate-block and SPR-batch shapes), the
stage2 phase (its seconds and launch counts) and the profile phase.
Prints one JSON line per turn, then a summary line, and writes all of it
to FILE (default pruning_turns.json in the working directory).  Exits
non-zero if a run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

KERNELS = ("pruning_fwd", "pruning_bwd")
SHAPES = ("slice", "full_tree", "replicate_block", "spr_batch")
RUN_TIMEOUT_S = 900


def run_checkout(root: str) -> dict:
    """Run `root`'s chip_smoke.py; returns its wall time and phases."""
    t = time.time()
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root,
                          capture_output=True, text=True,
                          timeout=RUN_TIMEOUT_S)
    wall = time.time() - t
    phases, last = {}, None
    for line in proc.stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and "phase" in obj:
            phases[obj["phase"]] = obj
        last = obj
    if proc.returncode != 0 or not (isinstance(last, dict) and last.get("ok")):
        raise SystemExit(f"pruning_turns: chip_smoke.py in {root} failed "
                         f"(exit {proc.returncode}):\n{proc.stderr[-4000:]}")
    return dict(wall_s=wall, phases=phases)


def kernel_times(phases: dict) -> dict:
    """{shape: {kernel: {ms, bound_ms, plain_ms}}} of the kernels phase."""
    out = {}
    for shape in SHAPES:
        at = phases["kernels"]["shapes"][shape]
        out[shape] = {k: {f: at[k][f] for f in ("ms", "bound_ms", "plain_ms")}
                      for k in KERNELS if k in at}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, help="root of the old checkout")
    ap.add_argument("--new", default=os.path.dirname(os.path.abspath(
        __file__)), help="root of the new checkout (default: this one)")
    ap.add_argument("--out", default="pruning_turns.json")
    args = ap.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    turns = []
    for label in ("old", "new", "new", "old"):
        res = run_checkout(getattr(args, label))
        ph = res["phases"]
        turn = dict(turn=len(turns) + 1, checkout=label,
                    wall_s=round(res["wall_s"], 3),
                    stage2_s=ph["stage2"]["seconds"],
                    stage2_timings=ph["stage2"]["timings"],
                    stage2_launches=ph["stage2"]["launches"],
                    stage2_planning=ph["stage2"].get("planning"),
                    profile=ph.get("profile"), kernels=kernel_times(ph))
        print(json.dumps(turn), flush=True)
        turns.append(turn)
    summary = dict(card=smi, order=[t["checkout"] for t in turns],
                   wall_s=[t["wall_s"] for t in turns],
                   stage2_s=[t["stage2_s"] for t in turns],
                   kernels={s: {k: [t["kernels"][s][k]["ms"] for t in turns]
                                for k in KERNELS
                                if k in turns[0]["kernels"][s]}
                            for s in SHAPES})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(dict(summary=summary, turns=turns), fh, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
