"""Statistics utilities (StatisticsUtilities parity,
pepr/stats/StatisticsUtilities.java): mean, sd, z-scores, two-sample
t-test, 1-D k-means, and R^2 — thin, tested numpy wrappers kept so the
component inventory's statistics surface exists in one place (a copy of
`pepr_tpu/utils/stats.py`, which imports nothing of JAX)."""

from __future__ import annotations

import numpy as np


def mean(x) -> float:
    return float(np.mean(np.asarray(x, dtype=np.float64)))


def standard_deviation(x) -> float:
    """Sample standard deviation (n-1 denominator,
    StatisticsUtilities.java:831)."""
    a = np.asarray(x, dtype=np.float64)
    return float(a.std(ddof=1)) if len(a) > 1 else 0.0


def z_scores(x) -> np.ndarray:
    a = np.asarray(x, dtype=np.float64)
    sd = standard_deviation(a)
    if sd == 0:
        return np.zeros_like(a)
    return (a - a.mean()) / sd


def t_statistic(a, b) -> float:
    """Welch two-sample t statistic (StatisticsUtilities.java:960)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    va = a.var(ddof=1) / len(a) if len(a) > 1 else 0.0
    vb = b.var(ddof=1) / len(b) if len(b) > 1 else 0.0
    denom = np.sqrt(va + vb)
    return float((a.mean() - b.mean()) / denom) if denom else 0.0


def kmeans_1d(x, k: int, iters: int = 100, seed: int = 0):
    """1-D k-means (StatisticsUtilities.java:374-475).  Returns
    (centers sorted ascending, assignment indices)."""
    a = np.asarray(x, dtype=np.float64)
    rng = np.random.default_rng(seed)
    centers = np.sort(rng.choice(a, size=min(k, len(a)), replace=False))
    for _ in range(iters):
        assign = np.argmin(np.abs(a[:, None] - centers[None, :]), axis=1)
        new = centers.copy()
        for c in range(len(centers)):
            members = a[assign == c]
            if len(members):
                new[c] = members.mean()
        if np.allclose(new, centers):
            break
        centers = np.sort(new)
    assign = np.argmin(np.abs(a[:, None] - centers[None, :]), axis=1)
    return centers, assign


def r_squared(x, y) -> float:
    """Coefficient of determination of the least-squares line
    (StatisticsUtilities.java:22)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if len(x) < 2:
        return 0.0
    r = np.corrcoef(x, y)[0, 1]
    return float(r * r)


def max_index(x) -> int:
    """Index of the maximum (StatisticsUtilities.java:927-938)."""
    return int(np.argmax(np.asarray(x)))


def histogram(x, bins: int = 10):
    """Simple distribution summary (StatisticsUtilities.java:998-1017)."""
    counts, edges = np.histogram(np.asarray(x, dtype=np.float64),
                                 bins=bins)
    return counts, edges
