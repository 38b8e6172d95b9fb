"""Approximately-unbiased (AU) topology test — native CONSEL replacement.

The reference drives the external CONSEL binaries for topology tests
(TreeComparison.java:812-885: raxml `-f g` per-site log-likelihoods ->
`makermt --puzzle` multiscale bootstrap -> `consel` -> `catpv`), which
are not bundled.  This module implements the same statistic natively:
Shimodaira's approximately-unbiased test via multiscale bootstrap
(Shimodaira 2002, Syst. Biol. 51:492-508), on the per-site
log-likelihood matrix our ML engine already exports
(`treecompare.per_site_log_likelihoods` = raxml `-f g`).

Method: for scale factors r in [0.5, 1.4], draw B multinomial
bootstrap replicates of size round(r*L) over sites, count how often
each tree is the likelihood winner (BP_t(r)), then fit the signed
distance / curvature model  BP(r) = Phi(-(d*sqrt(r) + c/sqrt(r)))  by
weighted least squares on the probit scale; the AU p-value is
Phi(-(d - c)).  Also reports the plain bootstrap proportion (NP/BP at
r=1), matching catpv's main columns.

A copy of `pepr_tpu/models/au_test.py`: host numpy, the same draws from
`np.random.default_rng(seed)`, so the p-values equal the JAX package's
for the same site log-likelihoods.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

DEFAULT_SCALES = (0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.1, 1.2, 1.3, 1.4)


def _phi(x):
    from math import erf
    x = np.asarray(x, dtype=np.float64)
    return 0.5 * (1.0 + np.vectorize(erf)(x / np.sqrt(2.0)))


def _phi_inv(p):
    # Acklam-style rational approximation is overkill; scipy-free
    # inverse via binary search on the monotone _phi (vectorized).
    p = np.asarray(p, dtype=np.float64)
    lo = np.full_like(p, -10.0)
    hi = np.full_like(p, 10.0)
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        below = _phi(mid) < p
        lo = np.where(below, mid, lo)
        hi = np.where(below, hi, mid)
    return 0.5 * (lo + hi)


@dataclass
class AuResult:
    au: np.ndarray  # (T,) AU p-values
    np_bp: np.ndarray  # (T,) plain bootstrap proportions at r=1
    obs_diff: np.ndarray  # (T,) LL(best) - LL(tree) on the full data
    d: np.ndarray
    c: np.ndarray


def au_test(sitelh: np.ndarray, n_reps: int = 2000,
            scales=DEFAULT_SCALES, seed: int = 1234) -> AuResult:
    """AU test over trees.

    sitelh: (T, L) per-site log-likelihoods (one row per candidate
    topology, the `-f g` export).  Returns AU p-values per tree.
    """
    sitelh = np.asarray(sitelh, dtype=np.float64)
    T, L = sitelh.shape
    rng = np.random.default_rng(seed)
    scales = np.asarray(scales, dtype=np.float64)
    bp = np.zeros((len(scales), T))
    for si, r in enumerate(scales):
        n = max(int(round(r * L)), 1)
        # multinomial site weights: counts (B, L) with total n
        counts = rng.multinomial(n, np.full(L, 1.0 / L), size=n_reps)
        tot = counts @ sitelh.T  # (B, T) replicate log-likelihoods
        # winner per replicate (scaled back to per-site means is
        # monotone-equivalent)
        win = np.argmax(tot, axis=1)
        for t in range(T):
            bp[si, t] = np.mean(win == t)
    # WLS fit of probit(1 - BP) = d*sqrt(r) + c/sqrt(r) per tree
    au = np.zeros(T)
    dd = np.zeros(T)
    cc = np.zeros(T)
    eps = 0.5 / n_reps
    for t in range(T):
        # saturated cases degenerate the two-parameter fit (z constant
        # across scales): a tree that wins (loses) every replicate at
        # every scale is simply not rejected (rejected)
        if (bp[:, t] >= 1.0 - 2 * eps).all():
            dd[t], cc[t], au[t] = -5.0, 0.0, 1.0
            continue
        if (bp[:, t] <= 2 * eps).all():
            dd[t], cc[t], au[t] = 5.0, 0.0, 0.0
            continue
        p = np.clip(bp[:, t], eps, 1.0 - eps)
        z = _phi_inv(1.0 - p)  # = -(probit of BP)
        x1 = np.sqrt(scales)
        x2 = 1.0 / np.sqrt(scales)
        # weights: inverse variance of the probit-transformed BP
        dens = np.exp(-0.5 * z ** 2) / np.sqrt(2 * np.pi)
        w = (dens ** 2) * n_reps / np.maximum(p * (1 - p), 1e-12)
        X = np.stack([x1, x2], axis=1)
        # inverse-variance WLS: scale design/response by sqrt(w) so the
        # objective is sum w_i r_i^2 (not w_i^2 r_i^2)
        sw = np.sqrt(w)
        beta, *_ = np.linalg.lstsq(sw[:, None] * X, sw * z, rcond=None)
        d, c = beta
        dd[t], cc[t] = d, c
        au[t] = float(_phi(-(d - c)))
    full = sitelh.sum(axis=1)
    # NP column = BP at the scale closest to r=1 (exact when present)
    np_idx = int(np.argmin(np.abs(scales - 1.0)))
    return AuResult(au=au, np_bp=bp[np_idx],
                    obs_diff=full.max() - full, d=dd, c=cc)


def au_report(result: AuResult, names=None) -> str:
    """catpv-style text table, best tree first."""
    T = len(result.au)
    names = names or [f"tree{i + 1}" for i in range(T)]
    order = np.argsort(result.obs_diff)
    lines = ["# rank  item     obs_dLL      au      np"]
    for rank, t in enumerate(order, 1):
        lines.append(f"  {rank:4d}  {names[t]:8s} {result.obs_diff[t]:9.2f}"
                     f"  {result.au[t]:6.3f}  {result.np_bp[t]:6.3f}")
    return "\n".join(lines)
