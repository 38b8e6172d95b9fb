"""Time variants of the profile DP kernel against each other on one H100,
and read where a step's cycles go.

    python3 dp_variants.py [--seed 0] [--out FILE]

`csrc/profile_dp.cu` builds two kernels (`redesign`): the shared
kernel for buckets of at most SHARED_ROWS rows (rows spread over a
block's warps, as many as keep every block of the call resident, up to
16; the strip boundaries in a shared-memory ring, each warp's column
scores staged in shared memory by cp.async) and the global kernel for
longer ones (the first design: the fewest strips of up to MAX_ROWS rows
a lane on up to 8 warps, the boundaries through a global buffer, scores
through L1); both walk the path in the same launch.  -D flags build the
others: `first` the global kernel at every bucket, `unstaged` the shared
kernel with scores through L1, `w8` the shared kernel on at most 8
warps, and `ring8` boundary slots of 8 columns (4 slots).  This script builds
each with one nvcc, side by side, into the git-ignored
pepr_tpu_torch/_build/variants/, points the wrapper at each library in
turn and times it on the shapes of chip_smoke.py's small_align phase
(`dp_shapes`: k/4 profiles at the 128 and 256 buckets, float profiles
at (256, 512) and (512, 256), a nucleotide batch of 8 pairs at 8,192 x
8,192), k/4 profiles at the 1,024 and 2,048 buckets, and the stage-2
input's last merge wave, each on the column scores made once.  Every variant's
scores, grid pointers and paths must equal the plain DP's and the plain
walk's.  The variants are timed in one order and then in the reverse
order.

Stamped builds (-DSTAMP: clock64() at each step of block 0's first
strip, and at the DP's and the walk's ends) of `first` and `redesign`,
each also with a part of the work dropped (-DABLATE: 1 the score loads,
2 the pointer stores, 4 the boundary hand-over, 8 the walk; their
results are wrong and not checked), give per shape the median cycles of
a step, the DP's and the walk's cycles, and their ms: what a step waits
on.  Prints one JSON line per shape, then the nvidia-smi line, and
writes all of it to FILE (default dp_variants.json).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

# name: nvcc -D flags; the first is the design the source builds
VARIANTS = {
    "redesign": (),
    "first": ("-DSHARED_ROWS=0",),
    "unstaged": ("-DSTAGE_ROWS=0",),
    "w8": ("-DSHARED_WARPS=8",),
    "ring8": ("-DRING_COLS=8", "-DRING_SLOTS=4"),
}
ABLATIONS = {"": 0, "-scores": 1, "-stores": 2, "-boundary": 4, "-walk": 8}
STAMPED = {f"{base}+stamp{tag}": VARIANTS[base] + ("-DSTAMP",) + (
    (f"-DABLATE={bits}",) if bits else ())
    for base in ("first", "redesign") for tag, bits in ABLATIONS.items()}
STAMP_MAX = 32768


def build_variants(pa, _cuda, variants: dict) -> dict:
    """{name: (library path, ptxas lines)}, one nvcc per variant."""
    out_dir = os.path.join(_cuda.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _cuda.find_nvcc()
    procs = {}
    for name, flags in variants.items():
        path = os.path.join(out_dir, f"libpepr_profile_dp_{name}.so")
        cmd = _cuda.nvcc_command(nvcc, pa.SOURCE, path) + list(flags)
        procs[name] = (path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        built[name] = (path, [ln.strip() for ln in log.splitlines()
                              if "registers" in ln or "spill" in ln])
    return built


def use_variant(pa, path: str) -> None:
    """Point the wrapper at a variant's library."""
    lib = ctypes.CDLL(path)
    for name, args in pa.ARGTYPES.items():
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = pa.RESTYPES[name]
    pa._lib = lib


def dp_shapes(smoke, seed: int) -> list:
    """(name, (p1, l1, p2, l2), core or None, gaps) of small_align's
    shapes, seeded, and the stage-2 input's last merge wave (chip_smoke's
    data phase at --seed)."""
    import numpy as np
    from pepr_tpu_torch.data.nt_scores import (NT_GAP_EXTEND, NT_GAP_OPEN,
                                               nt_core)
    from pepr_tpu_torch.utils.simulate import random_tree, simulate_families
    rng = np.random.default_rng(seed + 3)
    b = smoke.ALIGN_CHECK_BATCH
    out = [(f"dyadic_{L}", (*smoke.dyadic_profiles(rng, b, L),
                            *smoke.dyadic_profiles(rng, b, L)), None,
            (11.0, 1.0)) for L in (128, 256)]
    out += [(f"float_{L1}_{L2}", (*smoke.float_profiles(rng, b, L1),
                                  *smoke.float_profiles(rng, b, L2)), None,
             (11.0, 1.0)) for L1, L2 in ((256, 512), (512, 256))]
    out.append(("nucleotide_8", smoke.nt_profile_pairs(
        rng, smoke.ALIGN_NT_BATCH, 8192), nt_core(),
        (float(NT_GAP_OPEN), float(NT_GAP_EXTEND))))
    out += [(f"dyadic_{L}", (*smoke.dyadic_profiles(rng, B, L),
                             *smoke.dyadic_profiles(rng, B, L)), None,
             (11.0, 1.0)) for L, B in ((1024, b), (2048, 8))]
    drng = np.random.default_rng(seed)
    taxa = [f"taxon{i:02d}" for i in range(smoke.N_TAXA)]
    fams = simulate_families(random_tree(taxa, drng),
                             smoke.family_lengths(drng), drng, alpha=0.5,
                             absent=0.1)
    _, true_gapped = smoke.unaligned_families(
        fams, np.random.default_rng(seed + 2))
    for (L1, L2), arrs in sorted(smoke.last_merge_wave(true_gapped).items()):
        out.append((f"last_wave_{L1}_{L2}", arrs, None, (11.0, 1.0)))
    return out


def launch_plan(pa, B: int, L1: int) -> dict:
    """The loaded library's plan for B pairs of the bucket L1."""
    out = (ctypes.c_int * 4)()
    rc = pa.library().profile_dp_plan(B, L1, out)
    if rc != 0:
        raise SystemExit(f"profile_dp_plan failed: CUDA error {rc}")
    return dict(zip(("shared", "warps", "stage_rows", "smem_bytes"), out))


def stamps(pa) -> dict:
    """Block 0's first strip as the last launch of a stamped build ran
    it: its steps, their median and mean cycles, the DP's and the walk's
    cycles."""
    import numpy as np
    buf = (ctypes.c_longlong * STAMP_MAX)()
    if pa.library().profile_dp_stamps(buf, STAMP_MAX) != STAMP_MAX:
        raise SystemExit("not a stamped build")
    a = np.frombuffer(buf, dtype=np.int64)
    n = int(a[-4])
    steps = np.diff(a[:n])
    return dict(steps=n, step_cycles_median=float(np.median(steps)),
                step_cycles_mean=float(steps.mean()),
                dp_cycles=int(a[-2] - a[-3]), walk_cycles=int(a[-1] - a[-2]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="dp_variants.json")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("dp_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as smoke
    from pepr_tpu_torch.ops import _cuda
    from pepr_tpu_torch.ops import profile_align as pa

    dev = torch.device("cuda")
    built = build_variants(pa, _cuda, dict(VARIANTS, **STAMPED))
    lines = [dict(variant=v, flags=list(dict(VARIANTS, **STAMPED)[v]),
                  ptxas=log) for v, (_, log) in built.items()]
    for v in VARIANTS:
        use_variant(pa, built[v][0])
        lines.append(dict(variant=v, registers={
            k: pa.library().profile_dp_num_regs(int(k == "shared"))
            for k in ("shared", "global")}))
    for ln in lines:
        print(json.dumps(ln), flush=True)
    for name, (p1, l1, p2, l2), core, gaps in dp_shapes(smoke, args.seed):
        core_t = torch.as_tensor(pa.blosum_core() if core is None else core,
                                 dtype=torch.float32, device=dev)
        s = pa.column_scores(torch.as_tensor(p1, device=dev),
                             torch.as_tensor(p2, device=dev), core_t)
        n1, n2 = (torch.as_tensor(np.asarray(x), dtype=torch.int32,
                                  device=dev) for x in (l1, l2))
        costs = pa.gap_costs(gaps[0], gaps[1], 0.5)
        (s_p, p_p), plain_ms = smoke.timed(
            lambda: pa.profile_dp_plain(s, n1, n2, *costs))
        grid = pa.on_grid(l1, l2, s.shape[1], s.shape[2], dev)
        q_p, n_p = pa.traceback_paths(p_p.cpu(), l1, l2)
        Lp = s.shape[1] + s.shape[2]
        keep = torch.arange(Lp)[None, :] >= Lp - n_p[:, None].long()
        bound, by = smoke.dp_bound(l1, l2, n_p.numpy())
        reps = 3 if s.shape[1] > 1024 else 10
        ms, plans = {}, {}
        for v in list(VARIANTS) + list(VARIANTS)[::-1]:
            use_variant(pa, built[v][0])
            plans[v] = launch_plan(pa, *s.shape[:2])
            s_k, p_k, q_k, n_k = pa.profile_dp(s, n1, n2, *costs)
            same = torch.equal(s_k.view(torch.int32), s_p.view(torch.int32)) \
                and not ((p_k != p_p) & grid).any() \
                and torch.equal(n_k.cpu(), n_p) \
                and torch.equal(q_k.cpu()[keep], q_p[keep])
            del p_k
            if not same:
                raise SystemExit(f"variant {v} disagrees with the plain "
                                 f"version at {name}")
            ms.setdefault(v, []).append(smoke.time_ms(
                lambda: pa.profile_dp(s, n1, n2, *costs), reps))
        stamped = {}
        for v in STAMPED:
            use_variant(pa, built[v][0])
            stamped[v] = dict(ms=smoke.time_ms(
                lambda: pa.profile_dp(s, n1, n2, *costs), reps))
            pa.profile_dp(s, n1, n2, *costs)
            torch.cuda.synchronize()
            stamped[v].update(stamps(pa))
        line = dict(shape=name, size=list(s.shape),
                    cells=pa.grid_cells(l1, l2), moves=int(n_p.sum()),
                    bound_ms=bound, bound_by=by, plain_ms=plain_ms,
                    ms_in_turns=ms, plans=plans, stamped=stamped)
        lines.append(line)
        print(json.dumps(line), flush=True)
        del s, s_p, p_p, grid
        torch.cuda.empty_cache()
    smi = smoke.smi_line()
    print(smi, flush=True)
    with open(args.out, "w") as fh:
        json.dump(dict(lines=lines, nvidia_smi=smi), fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
