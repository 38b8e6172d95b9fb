"""MinHash distance / NJ tree CLI (util/NeighborMasher.java:102 role;
PyTorch port of `pepr_tpu/tools/neighbor_masher.py`, host numpy).

Usage: python -m pepr_tpu_torch.tools.neighbor_masher -genome_file *.faa
           [-outgroup og/*.faa -outgroup_count 2] [-tree]"""

from __future__ import annotations

import sys

from pepr_tpu_torch.io.fasta import read_fasta
from pepr_tpu_torch.models.neighbor_masher import (
    distance_matrix, mash_nj_tree, select_outgroups_by_distance)
from pepr_tpu_torch.tree import to_newick
from pepr_tpu_torch.utils.cli import RunProperties, expand_paths


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    rp = RunProperties(argv)
    genome_files = expand_paths(rp.values("genome_file"))
    if not genome_files:
        print(__doc__)
        return 2
    genomes = [read_fasta(p) for p in genome_files]
    og_files = expand_paths(rp.values("outgroup"))
    if og_files:
        pool = [read_fasta(p) for p in og_files]
        picked = select_outgroups_by_distance(
            genomes, pool, count=rp.get_int("outgroup_count", 2))
        print("selected_outgroups\t" + "\t".join(picked))
    if rp.get_bool("tree", default=not og_files):
        print(to_newick(mash_nj_tree(genomes)))
    else:
        d, _ = distance_matrix(genomes)
        names = [g.taxon for g in genomes]
        print("\t" + "\t".join(names))
        for i, n in enumerate(names):
            print(n + "\t" + "\t".join(f"{x:.4f}" for x in d[i]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
