"""Concatenation of per-gene alignments over the taxon union.

Reference behavior: MSAConcatenator.concatenate (MSAConcatenator.java:
78-189): output rows are the union of taxa across gene alignments;
genes missing a taxon are filled with '?'; per-gene column spans are
tracked (ConcatenatedSequenceAlignment.java:28-41) and drive gene-wise
jackknife subsetting and the `.hs` gene x taxon membership matrix
(PhylogenomicPipeline2.java:1320-1371).

Port of `pepr_tpu/models/concat.py`, with its Fitch step counts and
per-gene randomization thresholds.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pepr_tpu_torch.alphabet import GAP, N_AA
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


# -- parsimony-step randomization thresholds -------------------------------
# ConcatenatedSequenceAlignment.java:141-425 parity.  The reference's
# per-gene randomization machinery: a gene's observed parsimony steps
# are compared against a null distribution built by drawing the same
# number of columns from OTHER genes; the threshold is the (1-alpha)
# quantile of the replicate step sums.  (Dormant in the reference's
# main path — setStepsPerSite has no caller — but part of the public
# component surface.)

def minimum_steps_per_site(mat: np.ndarray) -> np.ndarray:
    """(L,) minimum possible parsimony steps per column: number of
    distinct residue states minus one (the column-bipartition count
    role of SequenceAlignment.getMinimumStepsPerSite; gap/ambiguity
    codes are not states)."""
    counts = np.zeros(mat.shape[1], dtype=np.int64)
    for a in range(N_AA):
        counts += (mat == a).any(axis=0)
    return np.maximum(counts - 1, 0)


def steps_per_site(cat: "ConcatenatedAlignment", children: np.ndarray,
                   device=None) -> np.ndarray:
    """(L,) Fitch parsimony steps per column on a given topology
    (kernel-array `children` postorder form) — the producer for the
    reference's setStepsPerSite slot."""
    import torch

    from pepr_tpu_torch.device import resolve_device
    from pepr_tpu_torch.ops.parsimony import fitch_sites
    dev = resolve_device(device)
    steps = fitch_sites(torch.as_tensor(cat.mat, device=dev),
                        torch.as_tensor(np.asarray(children, np.int64),
                                        device=dev))
    return steps.cpu().numpy().astype(np.int64)


def steps_beyond_minimum_per_site(cat: "ConcatenatedAlignment",
                                  children: np.ndarray,
                                  device=None) -> np.ndarray:
    """steps - minimum steps per column
    (ConcatenatedSequenceAlignment.java:128-143)."""
    return steps_per_site(cat, children, device) \
        - minimum_steps_per_site(cat.mat)


def threshold_steps_for_gene(cat: "ConcatenatedAlignment",
                             steps: np.ndarray, gene_idx: int,
                             reps: int = 100, alpha: float = 0.05,
                             seed: int = 0,
                             gene_mask: np.ndarray | None = None) -> int:
    """(1-alpha)-quantile null threshold for one gene's step sum
    (ConcatenatedSequenceAlignment.java:141-176 / 244-307).

    `steps` is any per-site step vector (raw or beyond-minimum).
    Without `gene_mask`, replicates draw the gene's column count from
    all OTHER columns without replacement (:151-167).  With a
    `gene_mask` (True = gene's columns excluded from the pool), the
    masked variant is used: sampling WITH replacement from the
    unmasked pool, returning -1 when fewer than 3x the gene's length
    remain (:262-305)."""
    rng = np.random.default_rng([seed, gene_idx])
    a, b = cat.spans[gene_idx]
    gene_len = int(b - a)
    excluded = np.zeros(cat.length, dtype=bool)
    excluded[a:b] = True
    if gene_mask is not None:
        for g in np.nonzero(np.asarray(gene_mask, bool))[0]:
            ga, gb = cat.spans[g]
            excluded[ga:gb] = True
        pool = steps[~excluded]
        if len(pool) < 3 * gene_len:
            return -1
        rep_steps = pool[rng.integers(0, len(pool),
                                      size=(reps, gene_len))].sum(axis=1)
    else:
        pool = steps[~excluded]
        rep_steps = np.array([
            rng.choice(pool, size=min(gene_len, len(pool)),
                       replace=False).sum()
            for _ in range(reps)])
    rep_steps.sort()
    return int(rep_steps[reps - int(np.ceil(reps * alpha))])
