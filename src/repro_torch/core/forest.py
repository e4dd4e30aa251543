"""Minimal extra-trees random-forest regressor (SMAC's surrogate family).

Numpy-only: each tree subsamples rows (bagging) and picks random split
(feature, threshold) pairs, taking the best of a small random set per node
(extra-trees).  Predictive mean/std across trees drives EI in SMAC.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class _Node:
    feature: int = -1
    thresh: float = 0.0
    left: Optional["_Node"] = None
    right: Optional["_Node"] = None
    value: float = 0.0


def _build(x, y, rng, depth, max_depth, min_leaf, n_trials):
    node = _Node(value=float(y.mean()))
    if depth >= max_depth or len(y) < 2 * min_leaf or y.std() < 1e-12:
        return node
    best = None
    for _ in range(n_trials):
        f = int(rng.integers(x.shape[1]))
        lo, hi = x[:, f].min(), x[:, f].max()
        if hi - lo < 1e-12:
            continue
        t = float(rng.uniform(lo, hi))
        mask = x[:, f] <= t
        nl = int(mask.sum())
        if nl < min_leaf or len(y) - nl < min_leaf:
            continue
        yl, yr = y[mask], y[~mask]
        score = nl * yl.var() + (len(y) - nl) * yr.var()
        if best is None or score < best[0]:
            best = (score, f, t, mask)
    if best is None:
        return node
    _, f, t, mask = best
    node.feature, node.thresh = f, t
    node.left = _build(x[mask], y[mask], rng, depth + 1, max_depth,
                       min_leaf, n_trials)
    node.right = _build(x[~mask], y[~mask], rng, depth + 1, max_depth,
                        min_leaf, n_trials)
    return node


def _predict_one(node: _Node, row: np.ndarray) -> float:
    while node.feature >= 0:
        node = node.left if row[node.feature] <= node.thresh else node.right
    return node.value


class RandomForest:
    def __init__(self, n_trees: int = 24, max_depth: int = 8,
                 min_leaf: int = 2, n_trials: int = 12, seed: int = 0):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.n_trials = n_trials
        self.seed = seed
        self._trees: List[_Node] = []

    def fit(self, x: np.ndarray, y: np.ndarray) -> "RandomForest":
        rng = np.random.default_rng(self.seed)
        self._trees = []
        n = len(y)
        for _ in range(self.n_trees):
            idx = rng.integers(0, n, size=n)  # bootstrap
            self._trees.append(_build(x[idx], y[idx], rng, 0, self.max_depth,
                                      self.min_leaf, self.n_trials))
        return self

    def predict(self, xq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        preds = np.stack([[_predict_one(t, row) for row in xq]
                          for t in self._trees])
        return preds.mean(axis=0), preds.std(axis=0) + 1e-9
