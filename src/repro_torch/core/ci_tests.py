"""Conditional-independence tests for causal structure discovery.

- ``fisher_z``: partial-correlation test for continuous / ordinal-encoded
  variables (the paper's choice for continuous data).
- ``mutual_info``: binned conditional mutual information with a permutation
  threshold for small discrete domains (the paper's choice for discrete
  data).

Both return (statistic, independent?) at significance ``alpha``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np


def _norm_sf(z: float) -> float:
    """Survival function of the standard normal (no scipy dependency)."""
    return 0.5 * math.erfc(z / math.sqrt(2.0))


def partial_correlation(data: np.ndarray, i: int, j: int,
                        cond: Sequence[int]) -> float:
    """Partial correlation of columns i, j given columns `cond`.

    Computed by regressing out the conditioning set (linear least squares) —
    equivalent to the inverse-covariance formulation but stable for small n.
    """
    x = data[:, i].astype(np.float64)
    y = data[:, j].astype(np.float64)
    if cond:
        z = data[:, list(cond)].astype(np.float64)
        z = np.column_stack([z, np.ones(len(z))])
        bx, *_ = np.linalg.lstsq(z, x, rcond=None)
        by, *_ = np.linalg.lstsq(z, y, rcond=None)
        x = x - z @ bx
        y = y - z @ by
    sx, sy = x.std(), y.std()
    if sx < 1e-12 or sy < 1e-12:
        return 0.0
    r = float(np.clip(np.mean((x - x.mean()) * (y - y.mean())) / (sx * sy),
                      -0.999999, 0.999999))
    return r


def fisher_z(data: np.ndarray, i: int, j: int, cond: Sequence[int],
             alpha: float = 0.05) -> Tuple[float, bool]:
    """Fisher z-test. Returns (p_value, independent?)."""
    n = data.shape[0]
    k = len(cond)
    if n - k - 3 <= 0:
        return 1.0, True
    r = partial_correlation(data, i, j, cond)
    z = 0.5 * math.log((1 + r) / (1 - r)) * math.sqrt(n - k - 3)
    p = 2.0 * _norm_sf(abs(z))
    return p, p > alpha


def _discretize(col: np.ndarray, bins: int = 4) -> np.ndarray:
    uniq = np.unique(col)
    if len(uniq) <= bins:
        return np.searchsorted(uniq, col)
    qs = np.quantile(col, np.linspace(0, 1, bins + 1)[1:-1])
    return np.digitize(col, qs)


def mutual_info(data: np.ndarray, i: int, j: int, cond: Sequence[int],
                alpha: float = 0.05, bins: int = 4,
                rng: Optional[np.random.Generator] = None) -> Tuple[float, bool]:
    """Conditional mutual information I(i; j | cond) with a permutation null.

    Returns (cmi, independent?).  Independence is declared when the observed
    CMI is below the 1-alpha quantile of a small permutation null.
    """
    rng = rng or np.random.default_rng(0)
    xi = _discretize(data[:, i], bins)
    xj = _discretize(data[:, j], bins)
    if cond:
        zi = np.zeros(len(xi), np.int64)
        for c in cond:
            zi = zi * bins + _discretize(data[:, c], bins)
    else:
        zi = np.zeros(len(xi), np.int64)

    def cmi(a, b, z):
        total = 0.0
        n = len(a)
        for zv in np.unique(z):
            m = z == zv
            nz = m.sum()
            if nz < 4:
                continue
            az, bz = a[m], b[m]
            pj = np.zeros((az.max() + 1, bz.max() + 1))
            np.add.at(pj, (az, bz), 1.0)
            pj /= nz
            pa = pj.sum(1, keepdims=True)
            pb = pj.sum(0, keepdims=True)
            nzmask = pj > 0
            total += (nz / n) * float(
                np.sum(pj[nzmask] * np.log(pj[nzmask]
                                           / (pa @ pb)[nzmask])))
        return total

    obs = cmi(xi, xj, zi)
    null = []
    for _ in range(19):  # 19 perms -> 5% one-sided threshold at the max
        null.append(cmi(rng.permutation(xi), xj, zi))
    thresh = max(null) if null else 0.0
    return obs, obs <= max(thresh, 1e-3)
