"""Blast8-format hit table export/import.

The reference exchanges homology results as blast8 tabular files
(BlatRunner `-out=blast8`, 12 columns; consumed again via
`-homology_search_method <file>`, PhyloPipeline.java:340-356).  The
same round-trip is supported here so precomputed searches can be
reused and external blast results injected.
"""

from __future__ import annotations

import numpy as np

from pepr_tpu_torch.models.homology import HitTable, ProteinUniverse


def write_blast8(path: str, universe: ProteinUniverse,
                 hits: HitTable) -> None:
    """query, target, %id, length, mismatches, gapopen, qstart, qend,
    tstart, tend, evalue, bitscore.  Coordinate columns carry the
    best-cell endpoints; start columns are end-length+1 (gap-free
    approximation — downstream consumers use only ids and col 11/12,
    PhyloPipeline.filterHitPairFile:989-1024)."""
    ids = universe.ids
    with open(path, "w") as fh:
        for k in range(len(hits.query)):
            q, t = int(hits.query[k]), int(hits.target[k])
            length = int(hits.length[k])
            matches = int(round(hits.identity[k] * length / 100.0))
            qe = length
            fh.write("\t".join([
                ids[q], ids[t], f"{hits.identity[k]:.2f}", str(length),
                str(length - matches), "0", "1", str(qe), "1", str(qe),
                f"{hits.evalue[k]:.2g}", f"{hits.bits[k]:.1f}",
            ]) + "\n")


def read_blast8(path: str, universe: ProteinUniverse) -> HitTable:
    """Load a blast8 file back into a HitTable (ids resolved against
    the universe; unknown ids are skipped)."""
    index: dict[str, int] = {}
    for i, pid in enumerate(universe.ids):
        index.setdefault(pid, i)
    q, t, bits, ev, ident, length = [], [], [], [], [], []
    with open(path) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if len(f) < 12:
                continue
            qi = index.get(f[0])
            ti = index.get(f[1])
            if qi is None or ti is None:
                continue
            q.append(qi)
            t.append(ti)
            ident.append(float(f[2]))
            length.append(float(f[3]))
            ev.append(float(f[10]))
            bits.append(float(f[11]))
    bits_arr = np.array(bits)
    return HitTable(np.array(q, dtype=np.int64),
                    np.array(t, dtype=np.int64),
                    bits_arr.astype(np.float32), bits_arr,
                    np.array(ev), np.array(ident), np.array(length))
