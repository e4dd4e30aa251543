"""Optimizers — AdamW, Adafactor, SGD-momentum — with warmup / cosine /
linear / constant schedules and global-norm clipping: the port of
:mod:`repro.train.optimizer`.

The update keeps the reference's signature, ``update(grads, state, params,
step) -> (new_params, new_state)``, but works **in place**: the returned
trees hold the same tensors as ``params`` and ``state``, updated.  At
full width that saves a second copy of the fp32 parameters and moments
(about 13 GB for the 8-layer falcon-mamba-7b cut), which the reference's
functional update would allocate.  Schedules and bias corrections are
computed in float32, as in the reference.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.utils.config import TrainConfig
from repro_torch.utils.trees import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, int], Tuple[Any, Any]]
    # update(grads, state, params, step) -> (new_params, new_state)


def _zip_apply(fn: Callable, params, *others) -> None:
    """``fn(param, *matching subtrees)`` for every parameter leaf; the
    others are walked by ``params``' keys (their leaves may be dicts)."""
    if isinstance(params, dict):
        for k, v in params.items():
            _zip_apply(fn, v, *(o[k] for o in others))
    else:
        fn(params, *others)


# --------------------------------------------------------------------------
# schedules
# --------------------------------------------------------------------------

def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    warm, total = cfg.warmup_steps, cfg.total_steps
    base = np.float32(cfg.lr)
    f32 = np.float32

    def sched(step: int) -> float:
        step = f32(step)
        if step < warm:
            return float(base * (step + f32(1)) / f32(max(warm, 1)))
        frac = np.clip((step - f32(warm)) / f32(max(total - warm, 1)),
                       f32(0), f32(1))
        if cfg.schedule == "constant":
            return float(base)
        if cfg.schedule == "linear":
            return float(base * (f32(1) - frac))
        return float(f32(0.5) * base
                     * (f32(1) + np.cos(f32(math.pi) * frac)))

    return sched


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to global norm <= ``max_norm``, the norm before).
    fp32 leaves are scaled in place, as the optimizer updates: the train
    step owns its gradients, and a scaled copy would hold a second fp32
    gradient at the step's peak (14 GB for deepseek-v3 at one layer)."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                           for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    return tree_map(lambda g: g.mul_(scale) if g.dtype == torch.float32
                    else (g.to(torch.float32) * scale).to(g.dtype),
                    grads), gnorm


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _apply(p: torch.Tensor, lr: float, delta: torch.Tensor) -> None:
    if p.dtype == torch.float32:
        p.sub_(lr * delta)
    else:
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

def _adamw(cfg: TrainConfig) -> Optimizer:
    sched = make_schedule(cfg)

    def init(params):
        return {"m": tree_map(_zeros32, params),
                "v": tree_map(_zeros32, params)}

    def update(grads, state, params, step):
        lr = sched(step)
        t = np.float32(step) + np.float32(1)
        c1 = float(np.float32(1) - np.float32(cfg.b1) ** t)
        c2 = float(np.float32(1) - np.float32(cfg.b2) ** t)

        def upd(p, g, m, v):
            gf = g.to(torch.float32)
            m.mul_(cfg.b1).add_((1 - cfg.b1) * gf)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(gf))
            delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
            if p.ndim >= 2:  # no decay on norms / biases
                delta = delta + cfg.weight_decay * p.to(torch.float32)
            _apply(p, lr, delta)

        with torch.no_grad():
            _zip_apply(upd, params, grads, state["m"], state["v"])
        return params, state

    return Optimizer(init, update)


# --------------------------------------------------------------------------
# Adafactor (factored second moment, no first moment)
# --------------------------------------------------------------------------

def _adafactor(cfg: TrainConfig) -> Optimizer:
    sched = make_schedule(cfg)
    d_clip = 1.0  # update clipping threshold (Shazeer & Stern)

    def init(params):
        def slot(p):
            if p.ndim >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": _zeros32(p)}
        return {"slots": tree_map(slot, params)}

    def update(grads, state, params, step):
        lr = sched(step)
        t = np.float32(step) + np.float32(1)
        beta2 = float(np.float32(1) - t ** np.float32(-0.8))

        def upd(p, g, slot):
            gf = g.to(torch.float32)
            g2 = torch.square(gf) + 1e-30
            if p.ndim >= 2:
                vr, vc = slot["vr"], slot["vc"]
                vr.mul_(beta2).add_((1 - beta2) * g2.mean(-1))
                vc.mul_(beta2).add_((1 - beta2) * g2.mean(-2))
                vhat = (vr[..., None] * vc[..., None, :]
                        / (vr.mean(-1, keepdim=True)[..., None] + 1e-30))
            else:
                slot["v"].mul_(beta2).add_((1 - beta2) * g2)
                vhat = slot["v"]
            u = gf / (torch.sqrt(vhat) + 1e-30)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            u = u / torch.clamp(rms / d_clip, min=1.0)
            if p.ndim >= 2:
                u = u + cfg.weight_decay * p.to(torch.float32)
            _apply(p, lr, u)

        with torch.no_grad():
            _zip_apply(upd, params, grads, state["slots"])
        return params, state

    return Optimizer(init, update)


# --------------------------------------------------------------------------
# SGD + momentum
# --------------------------------------------------------------------------

def _sgdm(cfg: TrainConfig) -> Optimizer:
    sched = make_schedule(cfg)

    def init(params):
        return {"m": tree_map(_zeros32, params)}

    def update(grads, state, params, step):
        lr = sched(step)

        def upd(p, g, m):
            m.mul_(cfg.b1).add_(g.to(torch.float32))
            _apply(p, lr, m)

        with torch.no_grad():
            _zip_apply(upd, params, grads, state["m"])
        return params, state

    return Optimizer(init, update)


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    if cfg.optimizer == "adamw":
        return _adamw(cfg)
    if cfg.optimizer == "adafactor":
        return _adafactor(cfg)
    if cfg.optimizer == "sgdm":
        return _sgdm(cfg)
    raise ValueError(f"unknown optimizer {cfg.optimizer}")
