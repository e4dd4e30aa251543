"""Average causal effect (ACE) estimation via backdoor adjustment.

For a node X with parents Pa(X) in the causal performance model, the
interventional mean is identified by adjustment:

    E[Y | do(X=x)] = E_Z [ E[Y | X=x, Z=Pa(X)] ]

We estimate the inner regression with ridge least squares on the adjustment
set (standard linear backdoor estimator — systems objectives are locally
smooth in the recommended-value ranges, and the estimator must stay sane at
the paper's n≈10..2000 sample sizes), and report

    ACE(X) = | d/dx  E[Y | do(X=x)] |  (the absolute adjusted coefficient)

Nodes connected to Y only through bidirected (possibly-confounded) edges get
their effect attenuated by ``confound_discount`` — the conservative
treatment of latent confounding.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.discovery import BIDIRECTED, CausalGraph


def _standardize(x: np.ndarray) -> np.ndarray:
    mu = x.mean(axis=0, keepdims=True)
    sd = x.std(axis=0, keepdims=True)
    sd = np.where(sd < 1e-12, 1.0, sd)
    return (x - mu) / sd


def adjusted_effect(data: np.ndarray, names: Sequence[str], x_name: str,
                    y_name: str, graph: CausalGraph,
                    ridge: float = 1e-3) -> float:
    """|coefficient of X| in ridge(Y ~ X + Pa(X)), standardized data."""
    idx = {n: i for i, n in enumerate(names)}
    if x_name not in idx or y_name not in idx:
        return 0.0
    adj = [p for p in graph.parents(x_name) if p in idx and p != y_name]
    cols = [idx[x_name]] + [idx[p] for p in adj]
    X = _standardize(data[:, cols].astype(np.float64))
    y = _standardize(data[:, [idx[y_name]]].astype(np.float64))[:, 0]
    Xb = np.column_stack([X, np.ones(len(X))])
    A = Xb.T @ Xb + ridge * np.eye(Xb.shape[1])
    b = Xb.T @ y
    coef = np.linalg.solve(A, b)
    return float(abs(coef[0]))


def rank_by_ace(data: np.ndarray, names: Sequence[str], y_name: str,
                graph: CausalGraph, confound_discount: float = 0.5
                ) -> List[Tuple[str, float]]:
    """All non-objective nodes ranked by ACE on the objective, descending."""
    out = []
    for n in names:
        if n == y_name:
            continue
        eff = adjusted_effect(data, names, n, y_name, graph)
        if graph.edge_kind(n, y_name) == BIDIRECTED:
            eff *= confound_discount
        out.append((n, eff))
    out.sort(key=lambda t: -t[1])
    return out


def choose_k(ranked: Sequence[Tuple[str, float]], k_min: int = 2,
             k_max: Optional[int] = None) -> int:
    """Pick k at the sharpest drop of the sorted ACE curve (elbow — the
    Hamerly–Elkan 'learning k' criterion applied to the 1-D effect sizes)."""
    vals = np.array([v for _, v in ranked], np.float64)
    if len(vals) <= k_min:
        return len(vals)
    k_max = k_max or max(k_min, int(np.ceil(len(vals) * 0.6)))
    drops = vals[:-1] - vals[1:]
    lo, hi = k_min - 1, min(k_max, len(drops))
    if lo >= hi:
        return min(k_min, len(vals))
    k = int(np.argmax(drops[lo:hi])) + lo + 1
    return k
