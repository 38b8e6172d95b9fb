"""WAG amino-acid substitution model (Whelan & Goldman 2001, public data).

Exchangeability rates (lower triangle, PAML wag.dat form) and equilibrium
frequencies, in ARNDCQEGHILKMFPSTWYV order.  Values were cross-verified
byte-exact against the doubles embedded in the reference's bundled
binaries (raxmlHPC stores the rates x100; FastTree_WAG stores these
frequencies), which are the models the reference pipeline uses
(RAxMLRunner.java:46 PROTGAMMALGF default overridden to PROTGAMMAWAG at
PhyloPipeline.java:1224-1225; README:46-48 FastTree modified for WAG).
"""

from __future__ import annotations

import numpy as np

_WAG_LOWER = """
0.551571
0.509848 0.635346
0.738998 0.147304 5.429420
1.027040 0.528191 0.265256 0.0302949
0.908598 3.035500 1.543640 0.616783 0.0988179
1.582850 0.439157 0.947198 6.174160 0.021352 5.469470
1.416720 0.584665 1.125560 0.865584 0.306674 0.330052 0.567717
0.316954 2.137150 3.956290 0.930676 0.248972 4.294110 0.570025 0.249410
0.193335 0.186979 0.554236 0.039437 0.170135 0.113917 0.127395 0.0304501 0.138190
0.397915 0.497671 0.131528 0.0848047 0.384287 0.869489 0.154263 0.0613037 0.499462 3.170970
0.906265 5.351420 3.012010 0.479855 0.0740339 3.894900 2.584430 0.373558 0.890432 0.323832 0.257555
0.893496 0.683162 0.198221 0.103754 0.390482 1.545260 0.315124 0.174100 0.404141 4.257460 4.854020 0.934276
0.210494 0.102711 0.0961621 0.0467304 0.398020 0.0999208 0.0811339 0.049931 0.679371 1.059470 2.115170 0.088836 1.190630
1.438550 0.679489 0.195081 0.423984 0.109404 0.933372 0.682355 0.243570 0.696198 0.0999288 0.415844 0.556896 0.171329 0.161444
3.370790 1.224190 3.974230 1.071760 1.407660 1.028870 0.704939 1.341820 0.740169 0.319440 0.344739 0.967130 0.493905 0.545931 1.613280
2.121110 0.554413 2.030060 0.374866 0.512984 0.857928 0.822765 0.225833 0.473307 1.458160 0.326622 1.386980 1.516120 0.171903 0.795384 4.378020
0.113133 1.163920 0.0719167 0.129767 0.717070 0.215737 0.156557 0.336983 0.262569 0.212483 0.665309 0.137505 0.515706 1.529640 0.139405 0.523742 0.110864
0.240735 0.381533 1.086000 0.325711 0.543833 0.227710 0.196303 0.103604 3.873440 0.420170 0.398618 0.133264 0.428437 6.454280 0.216046 0.786993 0.291148 2.485390
2.006010 0.251849 0.196246 0.152335 1.002140 0.301281 0.588731 0.187247 0.118358 7.821300 1.800340 0.305434 2.058450 0.649892 0.314887 0.232739 1.388230 1.593090 0.648371
"""

WAG_FREQS = np.array([
    0.0866279, 0.043972, 0.0390894, 0.0570451, 0.0193078,
    0.0367281, 0.0580589, 0.0832518, 0.0244313, 0.048466,
    0.086209, 0.0620286, 0.0195027, 0.0384319, 0.0457631,
    0.0695179, 0.0610127, 0.0143859, 0.0352742, 0.0708956,
], dtype=np.float64)

# Symmetric 20x20 exchangeability matrix S (zero diagonal).
WAG_RATES = np.zeros((20, 20), dtype=np.float64)
_vals = [float(v) for v in _WAG_LOWER.split()]
_k = 0
for _i in range(1, 20):
    for _j in range(_i):
        WAG_RATES[_i, _j] = WAG_RATES[_j, _i] = _vals[_k]
        _k += 1
assert _k == 190


def wag_rate_matrix(freqs: np.ndarray | None = None,
                    normalize: bool = True) -> np.ndarray:
    """Instantaneous rate matrix Q = S @ diag(pi), diagonal set so rows
    sum to zero, optionally normalized so the expected substitution rate
    at equilibrium is 1 (branch lengths in expected subs/site)."""
    pi = WAG_FREQS if freqs is None else np.asarray(freqs, dtype=np.float64)
    q = WAG_RATES * pi[None, :]
    np.fill_diagonal(q, 0.0)
    np.fill_diagonal(q, -q.sum(axis=1))
    if normalize:
        mu = -(pi * np.diag(q)).sum()
        q = q / mu
    return q


def wag_eigensystem(freqs: np.ndarray | None = None):
    """Symmetrized eigendecomposition of the WAG rate matrix.

    Returns (eigenvalues, U, U_inv) with Q = U @ diag(eig) @ U_inv, all
    real (WAG is time-reversible).  P(t) = U @ diag(exp(eig*t)) @ U_inv.
    """
    pi = WAG_FREQS if freqs is None else np.asarray(freqs, dtype=np.float64)
    q = wag_rate_matrix(pi)
    d = np.sqrt(pi)
    # B = diag(d) Q diag(1/d) is symmetric for reversible Q.
    b = d[:, None] * q / d[None, :]
    b = (b + b.T) / 2.0
    eig, v = np.linalg.eigh(b)
    u = v / d[:, None]
    u_inv = v.T * d[None, :]
    return eig, u, u_inv
