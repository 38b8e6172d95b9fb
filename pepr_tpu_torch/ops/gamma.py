"""Discrete Gamma rate categories (Yang 1994) on the host.

Gives the C category rates (mean of each quantile slice of a
Gamma(alpha, 1/alpha) distribution, mean 1) used by the WAG+Gamma
likelihood kernel — the reference's PROTGAMMAWAG / FastTree -gamma
models use 4 categories (RAxMLRunner.java:46, FastTreeRunner.java:67-77).
No scipy dependency: regularized incomplete gamma via series/continued
fraction, quantiles via bisection.
"""

from __future__ import annotations

import math

import numpy as np


def _gammainc_lower(a: float, x: float) -> float:
    """Regularized lower incomplete gamma P(a, x)."""
    if x <= 0:
        return 0.0
    if x < a + 1:
        # series
        term = 1.0 / a
        total = term
        n = a
        for _ in range(500):
            n += 1
            term *= x / n
            total += term
            if abs(term) < abs(total) * 1e-15:
                break
        return total * math.exp(-x + a * math.log(x) - math.lgamma(a))
    # continued fraction for Q(a, x)
    tiny = 1e-300
    b = x + 1 - a
    c = 1 / tiny
    d = 1 / b
    h = d
    for i in range(1, 500):
        an = -i * (i - a)
        b += 2
        d = an * d + b
        if abs(d) < tiny:
            d = tiny
        c = b + an / c
        if abs(c) < tiny:
            c = tiny
        d = 1 / d
        delta = d * c
        h *= delta
        if abs(delta - 1) < 1e-15:
            break
    q = h * math.exp(-x + a * math.log(x) - math.lgamma(a))
    return 1.0 - q


def _gamma_quantile(a: float, p: float) -> float:
    lo, hi = 0.0, max(10.0 * a, 20.0)
    while _gammainc_lower(a, hi) < p:
        hi *= 2
        if hi > 1e8:
            break
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if _gammainc_lower(a, mid) < p:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def discrete_gamma_rates(alpha: float, n_cats: int = 4) -> np.ndarray:
    """Mean-of-quantile-slice rates for Gamma(alpha, beta=alpha)
    (mean 1); returned rates average exactly 1."""
    if not np.isfinite(alpha) or alpha <= 0:
        return np.ones(n_cats)
    # quantile boundaries of Gamma(alpha, 1)
    bounds = [0.0] + [_gamma_quantile(alpha, (i + 1) / n_cats)
                      for i in range(n_cats - 1)] + [np.inf]
    rates = np.zeros(n_cats)
    for c in range(n_cats):
        lo, hi = bounds[c], bounds[c + 1]
        # mean of slice: integral x f(x) dx over [lo,hi] / (1/n_cats)
        # = alpha * (P(alpha+1, hi) - P(alpha+1, lo)) / (1/n_cats) / alpha
        p_hi = 1.0 if np.isinf(hi) else _gammainc_lower(alpha + 1, hi)
        p_lo = _gammainc_lower(alpha + 1, lo)
        rates[c] = (p_hi - p_lo) * n_cats
    # rates currently for Gamma(alpha, scale=1) normalized by mean alpha
    rates = rates * 1.0  # mean-of-slices of mean-1 distribution
    rates /= rates.mean()
    return rates
