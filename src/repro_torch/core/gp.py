"""Gaussian process regression in PyTorch (the surrogate substrate) — the
port of :mod:`repro.core.gp`.

Exact GP with an RBF kernel + heteroscedastic diagonal noise, Cholesky
solves, and a small log-marginal-likelihood grid fit for (lengthscale,
noise) with the signal fixed at 1, as in the reference: the same grid, the
same 1e-8 jitter, float32 throughout (the reference computes in float32
with ``jax_enable_x64`` off).

**Device.**  The fit and the prediction run on the CPU by design, not as a
fallback: n is the tuning budget (a few hundred points at most), so on
the card a fit is a chain of small launches (a Cholesky and a solve per
grid point, each likelihood read back to pick the best) and every
acquisition round copies its candidates over and the posterior back.
``chip_smoke.py`` times one fit and one predict at n = 64, d = 8 on both
devices in turns.  On an H100 the card was faster in most turns but did
not win by the rule for a claimed gain (nine tenths of all turns, and a
median gain beyond the CPU's own spread), and a fit + predict takes a few
milliseconds either way against seconds of replay a round (``PERF.md``
§ 6).
``device=`` places a fit elsewhere (the two agree to 1e-4);
:func:`gp_predict` hands its posterior back on the CPU, where the
acquisition functions read it with numpy.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

DTYPE = torch.float32


class GPFit(NamedTuple):
    x: torch.Tensor          # (n, d) training inputs
    alpha: torch.Tensor      # (n,) K^-1 (y - mean)
    chol: torch.Tensor       # (n, n) cholesky of K + noise
    lengthscale: torch.Tensor
    signal: torch.Tensor
    noise: torch.Tensor
    y_mean: torch.Tensor
    y_std: torch.Tensor


def rbf(x1: torch.Tensor, x2: torch.Tensor, lengthscale, signal
        ) -> torch.Tensor:
    d2 = torch.sum((x1[:, None, :] - x2[None, :, :]) ** 2, dim=-1)
    return signal * torch.exp(-0.5 * d2 / (lengthscale ** 2))


def _fit_given(x: torch.Tensor, y: torch.Tensor, lengthscale: float,
               signal: float, noise: float, extra_var: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(chol, alpha, log marginal likelihood) at one hyperparameter point.
    A matrix that is not positive definite gives a NaN factor and a NaN
    likelihood, as ``jnp.linalg.cholesky`` does, so the grid skips it."""
    n = x.shape[0]
    K = rbf(x, x, lengthscale, signal)
    K = K + torch.diag(noise + extra_var)
    chol, info = torch.linalg.cholesky_ex(
        K + 1e-8 * torch.eye(n, dtype=x.dtype, device=x.device))
    if int(info) != 0:
        chol = torch.full_like(chol, float("nan"))
    alpha = torch.cholesky_solve(y[:, None], chol)[:, 0]
    lml = (-0.5 * torch.dot(y, alpha)
           - torch.sum(torch.log(torch.diagonal(chol)))
           - 0.5 * n * math.log(2 * math.pi))
    return chol, alpha, lml


def fit_gp(x: np.ndarray, y: np.ndarray,
           extra_var: Optional[np.ndarray] = None,
           lengthscales=(0.1, 0.2, 0.4, 0.8, 1.6),
           noises=(1e-4, 1e-2, 1e-1), *, device="cpu") -> GPFit:
    """Fit on standardized targets; hyperparameters by LML grid search."""
    dev = torch.device(device)
    xt = torch.as_tensor(np.asarray(x), dtype=DTYPE, device=dev)
    y_raw = np.asarray(y, np.float64)
    y_mean, y_std = float(y_raw.mean()), float(y_raw.std() + 1e-9)
    yn = torch.as_tensor((y_raw - y_mean) / y_std, dtype=DTYPE, device=dev)
    ev = (torch.zeros(len(y_raw), dtype=DTYPE, device=dev)
          if extra_var is None
          else torch.as_tensor(np.asarray(extra_var) / (y_std ** 2),
                               dtype=DTYPE, device=dev))

    best = None
    for ls in lengthscales:
        for nz in noises:
            chol, alpha, lml = _fit_given(xt, yn, ls, 1.0, nz, ev)
            lml = float(lml)
            if not math.isfinite(lml):
                continue
            if best is None or lml > best[0]:
                best = (lml, ls, nz, chol, alpha)
    if best is None:  # degenerate data; fall back to widest kernel
        ls, nz = lengthscales[-1], noises[-1]
        chol, alpha, _ = _fit_given(xt, yn, ls, 1.0, nz, ev)
        best = (0.0, ls, nz, chol, alpha)
    _, ls, nz, chol, alpha = best

    def scalar(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=DTYPE, device=dev)

    return GPFit(x=xt, alpha=alpha, chol=chol, lengthscale=scalar(ls),
                 signal=scalar(1.0), noise=scalar(nz), y_mean=scalar(y_mean),
                 y_std=scalar(y_std))


@torch.no_grad()
def gp_predict(fit: GPFit, xq) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean/std at query points (unstandardized), on the CPU.
    xq: (m, d)."""
    xq = torch.as_tensor(np.asarray(xq), dtype=DTYPE, device=fit.x.device)
    Ks = rbf(xq, fit.x, fit.lengthscale, fit.signal)    # (m, n)
    mu = Ks @ fit.alpha
    v = torch.linalg.solve_triangular(fit.chol, Ks.T, upper=False)
    var = torch.clamp(fit.signal - torch.sum(v * v, dim=0), min=1e-10)
    return ((mu * fit.y_std + fit.y_mean).cpu(),
            (torch.sqrt(var) * fit.y_std).cpu())
