"""Observation / intervention trade-off (eq. 8 of the paper, from CBO).

    ε = Vol(H(D_v)) / Vol(domain)  ×  N / N_max

When the observational data covers little of the domain (small hull) or we
still have observation budget, observing is cheap and informative; once the
hull saturates, interventions take over.

Hull volume: exact convex hulls are exponential in dimension and the paper's
spaces are 10-30 dimensional with a few hundred points — we use the standard
axis-aligned product bound Vol(H) ≈ Π_d (max_d - min_d), normalized per
dimension so the domain volume is 1.  (Documented approximation; monotone in
coverage, which is the property ε needs.)
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def hull_volume_fraction(x_unit: np.ndarray) -> float:
    """x_unit: (n, d) points already normalized to the unit cube.

    Bounding-box product damped by the expected hull-to-box ratio of n
    points in d dimensions (~(1 - d/n)^d): the convex hull of few points in
    many dimensions is a vanishing fraction of their bounding box, and the
    box alone saturates to 1 almost immediately for d >= 8.
    """
    if len(x_unit) < 2:
        return 0.0
    n, d = x_unit.shape
    rng = x_unit.max(axis=0) - x_unit.min(axis=0)
    box = float(np.prod(np.clip(rng, 0.0, 1.0)))
    shrink = max(0.0, 1.0 - d / n) ** d
    return box * shrink


def observation_epsilon(x_unit: np.ndarray, n_obs: int, n_max: int) -> float:
    if n_max <= 0:
        return 0.0
    vol = hull_volume_fraction(x_unit)
    return float(np.clip(vol * (n_obs / n_max), 0.0, 1.0))
