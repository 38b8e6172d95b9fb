"""Export the reference's real example runs to a JAX-free form under
realdata/, for the port's tests and chip_smoke.py's real_data phase.

    JAX_PLATFORMS=cpu python tests/torch_realdata_export.py

For each run (aqu: 12 Aquificales taxa; ery: 12 Erysipelotrichi taxa)
it reads the JAX run's checkpoint store `conformance/<run>_ckpt/` (its
pickles hold pepr_tpu classes, so this script imports pepr_tpu) and
`conformance/oracle/`, and writes

- `realdata/<run>.npz` (np.savez_compressed, read with numpy alone):
  `names` (F,) family names; `widths` (F,) columns per family;
  `row_offsets` (F+1,) and `offsets` (F+1,) each family's first row
  and first code; `codes` every family's int8 matrix, row-major, one
  after another; `taxa` and `titles` (R,) one per row;
- `realdata/<run>.json`: the stage-2 configuration of the JAX run
  (`PeprConfig.default_track()`'s), its full tree (Newick and LL), its
  Gamma shape, its 100 jackknife replicates' Newicks in order, and the
  oracle files (raxml LLs, the FastTree Newick, RF to it).

Not collected by pytest (no test_ prefix); tests/test_torch_realdata.py
re-exports in memory and holds the files to it bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = ("aqu", "ery")
OUT = os.path.join(ROOT, "realdata")


def _load(run: str, key: str):
    with open(os.path.join(ROOT, "conformance", f"{run}_ckpt", f"{key}.pkl"),
              "rb") as fh:
        return pickle.load(fh)


def export(run: str) -> tuple[dict, dict]:
    """(arrays of the .npz, the .json's object) of one run."""
    sys.path.insert(0, ROOT)
    from pepr_tpu.pipeline.pepr import PeprConfig
    alns = _load(run, "alignments")
    rows = np.array([a.mat.shape[0] for a in alns], np.int64)
    widths = np.array([a.mat.shape[1] for a in alns], np.int64)
    arrays = dict(
        names=np.array([a.name for a in alns]),
        widths=widths,
        row_offsets=np.concatenate([[0], np.cumsum(rows)]).astype(np.int64),
        offsets=np.concatenate([[0], np.cumsum(rows * widths)])
        .astype(np.int64),
        codes=np.concatenate([np.asarray(a.mat, np.int8).ravel()
                              for a in alns]),
        taxa=np.array([t for a in alns for t in a.taxa]),
        titles=np.array([t for a in alns for t in a.titles]))
    newick, ll = _load(run, "full_tree")
    stage2 = dataclasses.asdict(PeprConfig.default_track().stage2)
    n_support = len([f for f in os.listdir(os.path.join(
        ROOT, "conformance", f"{run}_ckpt")) if f.startswith("support_0")])
    with open(os.path.join(ROOT, "conformance", "oracle",
                           f"{run}_oracle.json")) as fh:
        oracle = json.load(fh)
    with open(os.path.join(ROOT, "conformance", "oracle",
                           f"{run}_fasttree.nwk")) as fh:
        oracle["fasttree_newick"] = fh.read().strip()
    meta = dict(
        run=run, source=f"conformance/{run}_ckpt",
        taxa=len({t for a in alns for t in a.taxa}), families=len(alns),
        columns=int(widths.sum()), stage2=stage2,
        full_tree=dict(newick=newick, log_likelihood=float(ll)),
        gamma_alpha=float(_load(run, "gamma_alpha")),
        support_trees=[_load(run, f"support_{r:04d}")
                       for r in range(n_support)],
        oracle=oracle)
    return arrays, meta


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    for run in RUNS:
        arrays, meta = export(run)
        np.savez_compressed(os.path.join(OUT, f"{run}.npz"), **arrays)
        with open(os.path.join(OUT, f"{run}.json"), "w") as fh:
            json.dump(meta, fh, indent=1)
            fh.write("\n")
        print(run, meta["families"], meta["columns"],
              os.path.getsize(os.path.join(OUT, f"{run}.npz")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
