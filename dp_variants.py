"""Time variants of the profile DP kernel against each other on one H100.

    python3 dp_variants.py [--seed 0] [--out FILE]

`csrc/profile_dp.cu` builds one variant: a block of at most MAX_WARPS
warps a pair, each walking a strip of 32 R rows (R <= MAX_ROWS).  This
script builds the source once per (MAX_WARPS, MAX_ROWS) with -D, one
nvcc each, side by side, into the git-ignored
pepr_tpu_torch/_build/variants/, points the wrapper at each library in
turn and times it on the shapes of chip_smoke.py's small_align phase
(`dp_shapes`: k/4 profiles at the 128 and 256 buckets, float profiles
at (256, 512) and (512, 256), nucleotide batches of 8 and of 3 pairs at
8,192 x 8,192), each on the column scores made once.  Every variant's
scores and grid pointers must equal the plain version's (timed once a
shape).  All variants are timed in one order and then in the reverse
order.  Prints one JSON line per shape and pass, then the nvidia-smi
line, and writes all of it to FILE (default dp_variants.json).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

# (MAX_WARPS, MAX_ROWS); the first is the variant the source builds
VARIANTS = ((8, 8), (1, 8), (2, 8), (4, 8), (16, 8), (8, 4))


def build_variants(pa, _cuda) -> dict:
    """{variant: (library path, ptxas lines)}, one nvcc per variant."""
    out_dir = os.path.join(_cuda.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _cuda.find_nvcc()
    procs = {}
    for v in VARIANTS:
        path = os.path.join(out_dir,
                            "libpepr_profile_dp_w{}r{}.so".format(*v))
        cmd = _cuda.nvcc_command(nvcc, pa.SOURCE, path) + [
            f"-DMAX_WARPS={v[0]}", f"-DMAX_ROWS={v[1]}"]
        procs[v] = (path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for v, (path, proc) in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {v}:\n{log}")
        built[v] = (path, [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln])
    return built


def use_variant(pa, path: str, v: tuple) -> None:
    """Point the wrapper at a variant's library."""
    lib = ctypes.CDLL(path)
    for name, args in pa.ARGTYPES.items():
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = pa.RESTYPES[name]
    if (lib.profile_dp_max_warps(), lib.profile_dp_max_rows()) != v:
        raise SystemExit(f"{path} is not the variant {v}")
    pa._lib = lib


def dp_shapes(smoke, seed: int) -> list:
    """(name, (p1, l1, p2, l2), core or None, gaps) of small_align's
    shapes, seeded."""
    import numpy as np
    from pepr_tpu_torch.data.nt_scores import (NT_GAP_EXTEND, NT_GAP_OPEN,
                                               nt_core)
    rng = np.random.default_rng(seed)
    b = smoke.ALIGN_CHECK_BATCH
    out = [(f"dyadic_{L}", (*smoke.dyadic_profiles(rng, b, L),
                            *smoke.dyadic_profiles(rng, b, L)), None,
            (11.0, 1.0)) for L in (128, 256)]
    out += [(f"float_{L1}_{L2}", (*smoke.float_profiles(rng, b, L1),
                                  *smoke.float_profiles(rng, b, L2)), None,
             (11.0, 1.0)) for L1, L2 in ((256, 512), (512, 256))]
    nt_gaps = (float(NT_GAP_OPEN), float(NT_GAP_EXTEND))
    out += [(f"nucleotide_{B}", smoke.nt_profile_pairs(rng, B, 8192),
             nt_core(), nt_gaps) for B in (smoke.ALIGN_NT_BATCH, 3)]
    return out


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
    built = build_variants(pa, _cuda)
    lines = [dict(variant=list(v), ptxas=log)
             for v, (_, log) in built.items()]
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
        bound, by = smoke.dp_bound(l1, l2)
        ms = {}
        order = list(VARIANTS) + list(VARIANTS)[::-1]
        for v in order:
            use_variant(pa, built[v][0], v)
            s_k, p_k = pa.profile_dp(s, n1, n2, *costs)
            if not (torch.equal(s_k.view(torch.int32), s_p.view(torch.int32))
                    and not ((p_k != p_p) & grid).any()):
                raise SystemExit(f"variant {v} disagrees with the plain "
                                 f"version at {name}")
            reps = 3 if s.shape[1] > 1024 else 10
            ms.setdefault(str(list(v)), []).append(smoke.time_ms(
                lambda: pa.profile_dp(s, n1, n2, *costs), reps))
        line = dict(shape=name, size=list(s.shape),
                    cells=pa.grid_cells(l1, l2), bound_ms=bound,
                    bound_by=by, plain_ms=plain_ms,
                    ms_in_turns=ms)
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
