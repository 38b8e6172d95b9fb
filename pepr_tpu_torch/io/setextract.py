"""Homolog-set extraction from set-definition files.

Parity with util/SequenceSetExtractor.java:141-392: a set file has one
set per line (tab-separated sequence IDs — MCL output format); each set
becomes a `.faa` file with the member sequences pulled from the genome
files via an ID -> (genome, index) map.  A copy of
`pepr_tpu/io/setextract.py` on the port's FASTA I/O."""

from __future__ import annotations

import os

from pepr_tpu_torch.io.fasta import SequenceSet, write_fasta


def parse_set_file(path: str) -> list[list[str]]:
    sets: list[list[str]] = []
    with open(path) as fh:
        for line in fh:
            ids = [t for t in line.strip().split("\t") if t]
            if ids:
                sets.append(ids)
    return sets


def extract_sets(set_ids: list[list[str]], genomes: list[SequenceSet],
                 prefix: str = "set") -> list[SequenceSet]:
    id_map: dict[str, tuple[int, int]] = {}
    for gi, g in enumerate(genomes):
        for li, pid in enumerate(g.ids):
            id_map.setdefault(pid, (gi, li))
    out: list[SequenceSet] = []
    for si, ids in enumerate(set_ids):
        titles, seqs = [], []
        for pid in ids:
            loc = id_map.get(pid)
            if loc is None:
                continue
            gi, li = loc
            titles.append(genomes[gi].titles[li])
            seqs.append(genomes[gi].seqs[li])
        out.append(SequenceSet(f"{prefix}_{si}", titles, seqs))
    return out


def write_set_files(sets: list[SequenceSet], out_dir: str) -> list[str]:
    """Materialize per-set .faa files (the hg_<run>/ directory of the
    reference, PhyloPipeline.java:398-431)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for s in sets:
        p = os.path.join(out_dir, f"{s.name}.faa")
        write_fasta(p, s)
        paths.append(p)
    return paths
