"""Time variants of the pruning kernels against each other on one H100.

    python3 pruning_variants.py [--seed 0] [--out FILE]

`csrc/pruning.cu` builds one variant: R sites per lane and W warps per
Gamma category (its SITES_PER_LANE and WARPS_PER_CAT), with the
wrapper's slot plan sized for one block per SM.  This script builds the
source once per (R, W) with -D, one nvcc each, side by side, into the
git-ignored pepr_tpu_torch/_build/variants/, and for each (R, W, blocks
per SM) it points the wrapper at that library and plan size and times
both wrappers (median of CUDA-event times) at two shapes of the main
path: the full tree (1 x 64,433 sites of chip_smoke.py's seeded 53-taxon
data) and a block of 64 jackknife replicates on their compacted codes.
Each variant's full-tree outputs are held against the plain versions
with chip_smoke.py's tolerances, and its spill-tier counts against the
plan.  All variants are timed in one order and then in the reverse
order.  Prints one JSON line per variant and pass, then the nvidia-smi
line, and writes all of it to FILE (default pruning_variants.json).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

# (R sites per lane, W warps per category, blocks per SM the plan is
# sized for); the first is the variant the source builds
VARIANTS = ((2, 2, 1), (1, 2, 1), (2, 1, 1), (2, 1, 2), (1, 1, 2),
            (1, 4, 1), (2, 4, 1))
SMEM_PER_SM = 233472  # H100: 228 KB per SM, 1 KB of it kept per block
REPS = 5


def build_variants(pruning, _cuda) -> dict:
    """{(R, W): (library path, ptxas lines)}, one nvcc per variant."""
    out_dir = os.path.join(_cuda.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _cuda.find_nvcc()
    procs = {}
    for R, W in sorted({(r, w) for r, w, _ in VARIANTS}):
        path = os.path.join(out_dir, f"libpepr_pruning_r{R}w{W}.so")
        cmd = _cuda.nvcc_command(nvcc, pruning.SOURCE, path) + [
            f"-DSITES_PER_LANE={R}", f"-DWARPS_PER_CAT={W}"]
        procs[(R, W)] = (path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for key, (path, proc) in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for (R, W) = {key}:\n{log}")
        built[key] = (path, [ln.strip() for ln in log.splitlines()
                             if "registers" in ln or "spill" in ln])
    return built


def use_variant(pruning, path: str, R: int, W: int, per_sm: int) -> None:
    """Point the wrapper at a variant's library, tile and plan size."""
    pruning.SITES_PER_LANE, pruning.WARPS_PER_CAT = R, W
    pruning.SITE_TILE = pruning.WARP * W * R
    pruning.REC_FLOATS = pruning.MAX_CATS * (pruning.N_AA + 1) \
        * pruning.SITE_TILE
    pruning.UREC_FLOATS = pruning.MAX_CATS * pruning.N_AA * pruning.SITE_TILE
    pruning.SMEM_PER_BLOCK = min(232448, SMEM_PER_SM // per_sm - 1024)
    pruning._PLANS.clear()
    pruning._OCCUPANCY.clear()
    lib = ctypes.CDLL(path)
    for name, args in pruning.ARGTYPES.items():
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = pruning.RESTYPES[name]
    if lib.pruning_site_tile() != pruning.SITE_TILE:
        raise SystemExit(f"{path} has another site tile than ({R}, {W})")
    pruning._lib = lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="pruning_variants.json")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("pruning_variants: no CUDA device", file=sys.stderr)
        return 2

    import chip_smoke as cs
    from pepr_tpu_torch.device import resolve_device
    from pepr_tpu_torch.models.concat import concatenate
    from pepr_tpu_torch.models.msa import Alignment
    from pepr_tpu_torch.models.support import jackknife_gene_masks
    from pepr_tpu_torch.ops import _cuda, pruning
    from pepr_tpu_torch.ops.likelihood import (WagModel, transition_matrices,
                                               tree_to_arrays)
    from pepr_tpu_torch.parallel.replicates import BLOCK_REPS, replicate_codes
    from pepr_tpu_torch.pipeline.stage2 import Stage2Config
    from pepr_tpu_torch.utils.simulate import random_tree, simulate_families

    t0 = time.time()
    smi = cs.smi_line()
    built = build_variants(pruning, _cuda)
    print(json.dumps({"build_s": round(time.time() - t0, 3), "ptxas": {
        f"r{r}w{w}": v[1] for (r, w), v in built.items()}}), flush=True)

    dev = resolve_device("cuda")
    rng = np.random.default_rng(args.seed)
    taxa = [f"taxon{i:02d}" for i in range(cs.N_TAXA)]
    truth = random_tree(taxa, rng)
    fams = simulate_families(truth, cs.family_lengths(rng), rng, alpha=0.5,
                             absent=0.1)
    cat = concatenate([Alignment(n, t_, c) for n, t_, c in fams], taxa)
    model = WagModel.create(alpha=0.5)
    pi = torch.as_tensor(model.pi, device=dev)

    def tree_batch(trs):
        arrs = [tree_to_arrays(tr, taxa) for tr in trs]
        ch = torch.as_tensor(np.stack([a.children for a in arrs]),
                             device=dev)
        blen = torch.as_tensor(np.stack([a.blen for a in arrs]), device=dev)
        return ch, transition_matrices(model, blen).contiguous()

    codes_full = torch.as_tensor(cat.mat, device=dev)
    ch_f, pm_f = tree_batch([truth])
    ct_f = torch.ones((1, cat.length), device=dev)
    masks = jackknife_gene_masks(cat, cs.SUPPORT_REPS, Stage2Config().seed)
    codes_r, w_r = replicate_codes(cat.mat, masks[:BLOCK_REPS], dev)
    ch_r, pm_r = tree_batch([random_tree(taxa, rng)
                             for _ in range(codes_r.shape[0])])
    with torch.no_grad():
        ll_ref = pruning.site_ll_reference(codes_full, ch_f, pm_f, pi)
        g_ref = pruning.site_ll_grad_reference(codes_full, ch_f, pm_f, pi,
                                               ct_f)
    shapes = {"full_tree": (codes_full, ch_f, pm_f, ct_f),
              "replicate_block": (codes_r, ch_r, pm_r, w_r)}

    results = []
    for pass_no, order in enumerate((VARIANTS, VARIANTS[::-1])):
        for R, W, per_sm in order:
            row = dict(R=R, W=W, planned_blocks_per_sm=per_sm, run=pass_no)
            use_variant(pruning, built[(R, W)][0], R, W, per_sm)
            try:
                ll = pruning.pruning_fwd(codes_full, ch_f, pm_f, pi)
                g = pruning.pruning_bwd(codes_full, ch_f, pm_f, pi, ct_f)
                torch.cuda.synchronize()
                d = (ll - ll_ref).abs()
                row.update(
                    fwd_max_rel_err=float((d / (ll_ref.abs() + 1.0)).max()),
                    bwd_max_rel_err=float((g - g_ref).abs().max()
                                          / g_ref.abs().max()))
                ok = bool((d <= cs.FWD_RTOL * ll_ref.abs() + 1e-5).all()) \
                    and row["bwd_max_rel_err"] <= cs.BWD_RTOL
                for k in ("pruning_fwd", "pruning_bwd"):
                    facts = cs.launch_facts(k)
                    row[k] = dict(registers=facts["registers"],
                                  blocks_per_sm=facts["blocks_per_sm"],
                                  smem_bytes=facts["smem_bytes"],
                                  slots=facts["slots"])
                for name, (c, ch, pm, ct) in shapes.items():
                    reps = REPS if name == "full_tree" else 3
                    row[name] = dict(
                        fwd_ms=cs.time_ms(lambda: pruning.pruning_fwd(
                            c, ch, pm, pi), reps),
                        bwd_ms=cs.time_ms(lambda: pruning.pruning_bwd(
                            c, ch, pm, pi, ct), reps))
                row["agrees"] = ok
            except (RuntimeError, SystemExit) as err:
                row["error"] = str(err)[:300]
            torch.cuda.empty_cache()
            print(json.dumps(row), flush=True)
            results.append(row)
    print(smi, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(dict(card=smi, variants=results), fh, indent=1)
    bad = [r for r in results if r.get("agrees") is False]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
