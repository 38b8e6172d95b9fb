"""Time variants of the Smith-Waterman kernel against each other on one
H100.

    python3 sw_variants.py [--seed 0] [--out FILE]

`csrc/sw.cu` builds one variant: at most MAX_ROWS query rows a lane,
SUB_COPIES copies of the substitution table in shared memory and
MIN_BLOCKS resident blocks per SM asked of ptxas.  This script builds
the source once per (MAX_ROWS, SUB_COPIES, MIN_BLOCKS) with -D, one nvcc
each, side by side, into the git-ignored pepr_tpu_torch/_build/variants/,
points the wrapper at each library in turn and times it on every bucket
of chip_smoke.py's stage-1 pair list, cut into launches as the main path
cuts them (`chip_smoke.sw_bucket_table`).  Each variant's five outputs
on every pair must equal those of the variant the source builds (which
chip_smoke.py holds against the plain version).  All variants are timed
in one order and then in the reverse order.  Prints one JSON line per
variant and pass, then the nvidia-smi line, and writes all of it to
FILE (default sw_variants.json).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

# (MAX_ROWS, SUB_COPIES, MIN_BLOCKS); the first is the variant the
# source builds
VARIANTS = ((8, 16, 2), (4, 16, 2), (6, 16, 2), (12, 16, 1), (16, 16, 1),
            (8, 8, 3), (4, 8, 3))
KEYS = ("score", "matches", "length", "q_end", "t_end")


def build_variants(sw, _cuda) -> dict:
    """{variant: (library path, ptxas lines)}, one nvcc per variant."""
    out_dir = os.path.join(_cuda.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _cuda.find_nvcc()
    procs = {}
    for v in VARIANTS:
        path = os.path.join(out_dir, "libpepr_sw_r{}c{}b{}.so".format(*v))
        cmd = _cuda.nvcc_command(nvcc, sw.SOURCE, path) + [
            f"-DMAX_ROWS={v[0]}", f"-DSUB_COPIES={v[1]}",
            f"-DMIN_BLOCKS={v[2]}"]
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


def use_variant(sw, path: str, max_rows: int) -> None:
    """Point the wrapper at a variant's library."""
    lib = ctypes.CDLL(path)
    for name, args in sw.ARGTYPES.items():
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = sw.RESTYPES[name]
    if lib.sw_max_rows() != max_rows:
        raise SystemExit(f"{path} holds another MAX_ROWS than {max_rows}")
    sw.MAX_ROWS = max_rows
    sw._lib = lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="sw_variants.json")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("sw_variants: no CUDA device", file=sys.stderr)
        return 2

    import chip_smoke as cs
    from pepr_tpu_torch.models.homology import batch_pairs, by_real_cells
    from pepr_tpu_torch.ops import _cuda, sw
    from pepr_tpu_torch.ops.smith_waterman import kernel_matrix

    t0 = time.time()
    smi = cs.smi_line()
    sm_clock = float(cs.smi_line("clocks.max.sm").split()[0])
    built = build_variants(sw, _cuda)
    print(json.dumps({"build_s": round(time.time() - t0, 3), "ptxas": {
        "r{}c{}b{}".format(*v): b[1] for v, b in built.items()}}),
          flush=True)

    dev = torch.device("cuda")
    ingroup, _ = cs.stage1_genomes(args.seed)
    _, ulens, eff_q, eff_t, buckets, codes = cs.stage1_pair_list(ingroup,
                                                                 dev)
    sub = sw.integer_sub(kernel_matrix(), dev)
    lens_all, qi_all, ti_all = (torch.as_tensor(x, device=dev)
                                for x in (ulens, eff_q, eff_t))

    def outputs() -> list:
        """Every launch's five outputs, as the main path cuts them."""
        out = []
        for (blq, blt), idx in buckets.items():
            idx = by_real_cells(lens_all, qi_all, ti_all,
                                torch.as_tensor(idx, device=dev))
            step = batch_pairs(blq, blt, dev)
            for s0 in range(0, len(idx), step):
                sel = idx[s0:s0 + step]
                res = sw.sw_align(codes[qi_all[sel], :blq],
                                  codes[ti_all[sel], :blt], sub)
                out.append(torch.stack([res[k].to(torch.float32)
                                        for k in KEYS]))
        return out

    use_variant(sw, built[VARIANTS[0]][0], VARIANTS[0][0])
    want = outputs()
    results = []
    for pass_no, order in enumerate((VARIANTS, VARIANTS[::-1])):
        for v in order:
            row = dict(max_rows=v[0], sub_copies=v[1], min_blocks=v[2],
                       run=pass_no)
            use_variant(sw, built[v][0], v[0])
            row.update(registers=sw._lib.sw_num_regs(),
                       blocks_per_sm=sw._lib.sw_blocks_per_sm(),
                       ptxas=built[v][1])
            got = outputs()
            row["agrees"] = all(torch.equal(a, b) for a, b in zip(got, want))
            table = cs.sw_bucket_table(ulens, eff_q, eff_t, buckets, codes,
                                       sub, dev, sm_clock)
            row.update(ms=table["ms"], bound_ms=table["bound_ms"],
                       bound_share=table["bound_share"],
                       per_bucket_ms=[[r[0], r[1], r[6]]
                                      for r in table["rows"]])
            torch.cuda.empty_cache()
            print(json.dumps(row), flush=True)
            results.append(row)
    print(smi, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(dict(card=smi, variants=results), fh, indent=1)
    return 0 if all(r["agrees"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
