"""Concatenation of per-gene alignments over the taxon union.

Reference behavior: MSAConcatenator.concatenate (MSAConcatenator.java:
78-189): output rows are the union of taxa across gene alignments;
genes missing a taxon are filled with '?'; per-gene column spans are
tracked (ConcatenatedSequenceAlignment.java:28-41) and drive gene-wise
jackknife subsetting and the `.hs` gene x taxon membership matrix
(PhylogenomicPipeline2.java:1320-1371).

Port of `pepr_tpu/models/concat.py`; the Fitch step counts are not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pepr_tpu_torch.alphabet import GAP
from pepr_tpu_torch.models.msa import Alignment


@dataclass
class ConcatenatedAlignment:
    taxa: list[str]
    mat: np.ndarray  # (n_taxa, L) int8
    gene_names: list[str]
    spans: np.ndarray  # (n_genes, 2) start/stop columns (stop exclusive)
    presence: np.ndarray  # (n_genes, n_taxa) bool

    @property
    def length(self) -> int:
        return self.mat.shape[1]

    @property
    def n_genes(self) -> int:
        return len(self.gene_names)

    def gene_column_mask(self, gene_indices) -> np.ndarray:
        """Boolean column mask covering the given genes — the jackknife
        subset selector (site-weight form for the likelihood kernel)."""
        mask = np.zeros(self.length, dtype=bool)
        for g in gene_indices:
            a, b = self.spans[g]
            mask[a:b] = True
        return mask

    def subset_matrix(self, gene_indices) -> np.ndarray:
        return self.mat[:, self.gene_column_mask(gene_indices)]

    def hs_matrix_text(self) -> str:
        """Gene x taxon 0/1 membership table (`<run>.hs` output)."""
        lines = ["\t" + "\t".join(self.taxa)]
        for g, name in enumerate(self.gene_names):
            row = "\t".join("1" if self.presence[g, t] else "0"
                            for t in range(len(self.taxa)))
            lines.append(f"{name}\t{row}")
        return "\n".join(lines) + "\n"


def concatenate(alignments: list[Alignment],
                taxa: list[str] | None = None) -> ConcatenatedAlignment:
    """Concatenate gene alignments over the union (or given list) of
    taxa, '?'-filling missing genes.  When an alignment contains a taxon
    more than once, the first row wins (the reference keys rows by taxon
    and overwrites none)."""
    if taxa is None:
        seen: dict[str, None] = {}
        for a in alignments:
            for t in a.taxa:
                seen.setdefault(t, None)
        taxa = list(seen)
    t_index = {t: i for i, t in enumerate(taxa)}
    total = sum(a.length for a in alignments)
    mat = np.full((len(taxa), total), GAP, dtype=np.int8)
    spans = np.zeros((len(alignments), 2), dtype=np.int64)
    presence = np.zeros((len(alignments), len(taxa)), dtype=bool)
    col = 0
    for g, a in enumerate(alignments):
        spans[g] = (col, col + a.length)
        filled: set[int] = set()
        for row, taxon in enumerate(a.taxa):
            ti = t_index.get(taxon)
            if ti is None or ti in filled:
                continue
            mat[ti, col:col + a.length] = a.mat[row]
            presence[g, ti] = True
            filled.add(ti)
        col += a.length
    return ConcatenatedAlignment(list(taxa), mat,
                                 [a.name for a in alignments], spans,
                                 presence)
