"""Causal Gaussian Process (the CBO-style surrogate, eqs. 2-4 of the paper).

A CGP differs from a plain GP in two ways:

  mean   m(o) = Ê[Y | do(o)]  — the do-calculus interventional estimate from
         the causal performance model + observational data (backdoor
         adjustment over the causal parents of the objective);
  kernel k(o, o') = k_RBF(o, o') + σ(o) σ(o')  with
         σ(o) = sqrt(V̂[Y | do(o)]) — the interventional variance, so the
         posterior uncertainty widens exactly where the causal estimate is
         poorly supported by data.

Implementation: the interventional mean is a ridge regression on the
*causal feature subset* (the Markov-blanket variables the graph exposes);
its local residual variance (k-NN over causal features) gives σ(o).  The GP
is then fit on the residual y - m(o) with the σ-augmented kernel, which is
algebraically the paper's kernel with the mean folded out.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.gp import GPFit, fit_gp, gp_predict
from repro_torch.core.spaces import ConfigSpace


class InterventionalEstimator:
    """Ê[Y|do(o)] and V̂[Y|do(o)] over a causal feature subset.

    ``feature_idx=None`` -> intercept-only mean (the cold model's safe prior
    when too few target samples exist to support a multivariate adjustment);
    the k-NN variance still localizes over the full encoding.
    """

    def __init__(self, feature_idx: Optional[Sequence[int]], ridge: float = 1e-2,
                 knn: int = 8):
        self.feature_idx = None if feature_idx is None else list(feature_idx)
        self.ridge = ridge
        self.knn = knn
        self._coef: Optional[np.ndarray] = None
        self._xf: Optional[np.ndarray] = None
        self._resid2: Optional[np.ndarray] = None
        self._var_floor = 1e-6

    def _features(self, x: np.ndarray) -> np.ndarray:
        if self.feature_idx is None:
            return np.zeros((len(x), 0))
        return x[:, self.feature_idx]

    def fit(self, x: np.ndarray, y: np.ndarray) -> "InterventionalEstimator":
        xf = self._features(x)
        xb = np.column_stack([xf, np.ones(len(x))])
        A = xb.T @ xb + self.ridge * np.eye(xb.shape[1])
        self._coef = np.linalg.solve(A, xb.T @ y)
        pred = xb @ self._coef
        self._xall = x
        self._xf = xf
        self._resid2 = (y - pred) ** 2
        self._var_floor = float(np.median(self._resid2) + 1e-9)
        # cap σ(o): constraint-clamped (was-infeasible) observations create
        # huge local residuals; unbounded σ makes EI *seek* infeasible
        # regions ("high uncertainty"), the classic constrained-BO trap
        self._var_cap = float(np.var(y) + self._var_floor)
        return self

    def mean(self, xq: np.ndarray) -> np.ndarray:
        xb = np.column_stack([self._features(xq), np.ones(len(xq))])
        return xb @ self._coef

    def std(self, xq: np.ndarray) -> np.ndarray:
        """sqrt of local (k-NN) residual variance — V̂[Y|do(o)]."""
        ref = self._xf if self._xf.shape[1] else self._xall
        q = self._features(xq) if self._xf.shape[1] else xq
        d2 = ((q[:, None, :] - ref[None, :, :]) ** 2).sum(-1)
        k = min(self.knn, ref.shape[0])
        idx = np.argpartition(d2, k - 1, axis=1)[:, :k]
        local = np.take_along_axis(
            np.broadcast_to(self._resid2, d2.shape), idx, axis=1)
        var = local.mean(axis=1) + self._var_floor * 0.1
        return np.sqrt(np.minimum(var, self._var_cap))


class CausalGP:
    """Warm/cold surrogate: interventional mean + GP on the residual with a
    σ(o)-augmented kernel.

    ``mean_mode="causal"`` (warm): ridge backdoor mean over the causal
    feature subset, GP over those features — the reduced-space surrogate.
    ``mean_mode="constant"`` (cold): intercept-only interventional mean, GP
    over the full encoding — safe at the handful-of-samples regime the
    target starts in.
    """

    def __init__(self, space: ConfigSpace, feature_names: Sequence[str],
                 mean_mode: str = "causal"):
        self.space = space
        self.mean_mode = mean_mode
        self.feature_names = [n for n in feature_names if n in space.by_name]
        name_to_idx = {n: i for i, n in enumerate(space.names)}
        self.feature_idx = [name_to_idx[n] for n in self.feature_names]
        self.est: Optional[InterventionalEstimator] = None
        self.fit_: Optional[GPFit] = None
        self._x: Optional[np.ndarray] = None
        self._y: Optional[np.ndarray] = None

    def _gp_idx(self):
        return self.feature_idx or list(range(self.space.dim))

    def fit(self, configs: Sequence[Dict], ys: Sequence[float]) -> "CausalGP":
        x = np.stack([self.space.encode(c) for c in configs])
        y = np.asarray(ys, np.float64)
        if not np.isfinite(y).all():  # clamp infeasible to pessimistic finite
            good = y[np.isfinite(y)]
            worst = (good.max() + 0.5 * (np.ptp(good) + 1e-3)
                     if len(good) else 1.0)
            y = np.where(np.isfinite(y), y, worst)
        self._x, self._y = x, y
        mean_idx = (None if self.mean_mode == "constant"
                    else (self.feature_idx or None))
        self.est = InterventionalEstimator(mean_idx).fit(x, y)
        resid = y - self.est.mean(x)
        sigma = self.est.std(x)
        # σ(o)σ(o') kernel term contributes σ(o)^2 on the diagonal; folding
        # it into heteroscedastic noise keeps the GP exact and PSD
        self.fit_ = fit_gp(x[:, self._gp_idx()], resid, extra_var=sigma ** 2)
        return self

    def predict(self, configs: Sequence[Dict]) -> Tuple[np.ndarray, np.ndarray]:
        xq = np.stack([self.space.encode(c) for c in configs])
        mu_do = self.est.mean(xq)
        sig_do = self.est.std(xq)
        mu_gp, sd_gp = gp_predict(self.fit_, xq[:, self._gp_idx()])
        mu = mu_do + np.asarray(mu_gp)
        sd = np.sqrt(np.asarray(sd_gp) ** 2 + sig_do ** 2)
        return mu, sd

    @property
    def best_observed(self) -> float:
        return float(np.min(self._y)) if self._y is not None else np.inf
