"""Alignment container (the `Alignment` dataclass of
`pepr_tpu/models/msa.py`).  The progressive MSA itself is not ported
yet."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Alignment:
    """An MSA with taxon names per row (SequenceAlignment.java role)."""
    name: str
    taxa: list[str]
    mat: np.ndarray  # (n, L) int8 with GAP
    titles: list[str] | None = None

    @property
    def n_seqs(self) -> int:
        return self.mat.shape[0]

    @property
    def length(self) -> int:
        return self.mat.shape[1]
