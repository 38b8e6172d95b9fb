"""Sequence set extraction CLI (SequenceSetExtractor.java:78 main role;
PyTorch port of `pepr_tpu/tools/set_extractor.py`).

Usage: python -m pepr_tpu_torch.tools.set_extractor -set_file sets.txt \
    -genome_file a.faa b.faa -out_dir hg_run"""

from __future__ import annotations

import sys

from pepr_tpu_torch.io.fasta import read_fasta
from pepr_tpu_torch.io.setextract import (extract_sets, parse_set_file,
                                          write_set_files)
from pepr_tpu_torch.utils.cli import RunProperties, expand_paths


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    rp = RunProperties(argv)
    set_file = rp.get("set_file")
    genome_files = expand_paths(rp.values("genome_file"))
    out_dir = rp.get("out_dir", "sets_out")
    if not set_file or not genome_files:
        print(__doc__)
        return 2
    genomes = [read_fasta(p) for p in genome_files]
    sets = extract_sets(parse_set_file(set_file), genomes)
    paths = write_set_files(sets, out_dir)
    print(f"wrote {len(paths)} set files to {out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
