"""Protein substitution-model registry for matrix evaluation (the
port's own copy of `pepr_tpu/data/protein_models.py`, which the port
may not import).

The reference's matrix-evaluation mode scores a parsimony tree under a
list of candidate RAxML matrices and picks the best
(PhylogenomicPipeline2.java:252-295, 1390-1451).  The package carries
the models it can construct from public data without copying tables out
of binaries:

- WAG / WAGF: Whelan & Goldman 2001 exchangeabilities (data/wag.py),
  with model ("") or empirical ("F") frequencies.
- BLOSUM62 / BLOSUM62F: the substitution model implied by the BLOSUM62
  log-odds matrix.  BLOSUM62 entries are rounded half-bit log-odds
  s_ij = 2*log2(q_ij / (p_i p_j)), so the exchangeabilities are
  2**(s_ij/2) and the implied equilibrium frequencies are the fixed
  point of the target-frequency marginals.  (Values therefore differ
  slightly from RAxML's PROTGAMMABLOSUM62 table, which uses the
  unrounded published estimates — a conscious divergence.)

The registry is open: `register_model` accepts any exchangeability
matrix + frequencies, so published tables (LG, JTT, ...) can be dropped
in as data without code changes.
"""

from __future__ import annotations

import numpy as np

from pepr_tpu_torch.data.blosum62 import BLOSUM62
from pepr_tpu_torch.data.wag import WAG_FREQS, WAG_RATES

_REGISTRY: dict[str, tuple[np.ndarray, np.ndarray]] = {}


def register_model(name: str, rates: np.ndarray, freqs: np.ndarray):
    """rates: (20, 20) symmetric exchangeabilities (diagonal ignored);
    freqs: (20,) equilibrium frequencies summing to 1."""
    r = np.asarray(rates, np.float64)
    f = np.asarray(freqs, np.float64)
    _REGISTRY[name] = (r, f / f.sum())


def _blosum62_implied() -> tuple[np.ndarray, np.ndarray]:
    s = BLOSUM62[:20, :20].astype(np.float64)
    exch = 2.0 ** (s / 2.0)
    np.fill_diagonal(exch, 0.0)
    # implied frequencies: q_ij = p_i p_j f_ij with marginals
    # sum_j q_ij = p_i requires F p proportional to the ones vector,
    # a linear solve (f_ij = 2^(s_ij/2) including the diagonal)
    full = 2.0 ** (s / 2.0)
    p = np.linalg.solve(full, np.ones(20))
    p = np.maximum(p, 1e-4)
    p = p / p.sum()
    return exch, p


register_model("WAG", WAG_RATES, WAG_FREQS)
_b62_rates, _b62_freqs = _blosum62_implied()
register_model("BLOSUM62", _b62_rates, _b62_freqs)


def model_names(include_f: bool = True) -> list[str]:
    names = []
    for base in _REGISTRY:
        names.append(base)
        if include_f:
            names.append(base + "F")
    return names


def resolve_model(name: str, empirical_freqs: np.ndarray | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Name -> (rates, freqs).  A trailing 'F' uses empirical
    frequencies (observed in the alignment), the RAxML '...F' matrix
    convention."""
    base = name
    freqs_override = None
    if name not in _REGISTRY and name.endswith("F"):
        base = name[:-1]
        if empirical_freqs is None:
            raise ValueError(f"{name} needs empirical frequencies")
        freqs_override = empirical_freqs
    if base not in _REGISTRY:
        raise KeyError(f"unknown substitution model {name!r}; "
                       f"registered: {sorted(_REGISTRY)}")
    rates, freqs = _REGISTRY[base]
    if freqs_override is not None:
        freqs = np.asarray(freqs_override, np.float64)
        freqs = np.maximum(freqs, 1e-6)
        freqs = freqs / freqs.sum()
    return rates, freqs


def eigensystem(rates: np.ndarray, pi: np.ndarray):
    """Symmetrized eigendecomposition of the reversible rate matrix
    Q = S diag(pi), normalized to one expected substitution per unit
    branch length (same construction as data/wag.py)."""
    pi = np.asarray(pi, np.float64)
    q = rates * pi[None, :]
    np.fill_diagonal(q, 0.0)
    np.fill_diagonal(q, -q.sum(axis=1))
    mu = -(pi * np.diag(q)).sum()
    q = q / mu
    d = np.sqrt(pi)
    b = d[:, None] * q / d[None, :]
    b = (b + b.T) / 2.0
    eig, v = np.linalg.eigh(b)
    return eig, v / d[:, None], v.T * d[None, :]
