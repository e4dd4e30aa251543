"""Acquisition machinery: expected improvement + the λ-gated warm/cold
combination (eqs. 5-7 of the paper).

    EI(o)  = E[max(y* - y, 0)]                       (minimization)
    λ(o)   = 1( EI*_warm - EI_warm(o) <= l_α )        (l_α = 0.1, normalized)
    α(o)   = λ(o) · EI_cold(o) + (1 - λ(o)) · EI_warm(o)

λ gates per configuration: near the warm optimum (within l_α of the best
warm score after [0,1] normalization) the target model decides; elsewhere
the source knowledge drives.  EI scores are normalized before the gate so
l_α is scale-free across objectives.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

_SQRT2 = math.sqrt(2.0)


def _norm_pdf(z: np.ndarray) -> np.ndarray:
    return np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)


def _norm_cdf(z: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + np.vectorize(math.erf)(z / _SQRT2))


def expected_improvement(mu: np.ndarray, sd: np.ndarray, best: float,
                         xi: float = 0.0) -> np.ndarray:
    """EI for minimization."""
    sd = np.maximum(sd, 1e-12)
    z = (best - xi - mu) / sd
    return (best - xi - mu) * _norm_cdf(z) + sd * _norm_pdf(z)


def _normalize(a: np.ndarray) -> np.ndarray:
    lo, hi = float(a.min()), float(a.max())
    if hi - lo < 1e-15:
        return np.zeros_like(a)
    return (a - lo) / (hi - lo)


def combined_acquisition(ei_warm: np.ndarray, ei_cold: np.ndarray,
                         l_alpha: float = 0.1
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (α, λ) over the candidate set."""
    w = _normalize(ei_warm)
    c = _normalize(ei_cold)
    lam = (w.max() - w <= l_alpha).astype(np.float64)
    alpha = lam * c + (1.0 - lam) * w
    return alpha, lam
