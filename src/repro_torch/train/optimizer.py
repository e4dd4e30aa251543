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

On a sharded train state each leaf is this rank's block.  The elementwise
updates run on the blocks as they are; a statistic over a whole leaf or
tree — the global norm, Adafactor's factored means and update RMS — sums
the blocks over the axes that split each leaf (``layout``, a
:class:`~repro_torch.sharding.layout.Layout`), and a leaf those axes
replicate is counted once.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.sharding import collectives
from repro_torch.utils.config import TrainConfig
from repro_torch.utils.trees import tree_map, tree_map_with_path


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]
    # update(grads, state, params, step, layout=None)
    #     -> (new_params, new_state)


def _zip_apply(fn: Callable, params, *others, path: str = "") -> None:
    """``fn(path, param, *matching subtrees)`` for every parameter leaf;
    the others are walked by ``params``' keys (their leaves may be
    dicts)."""
    if isinstance(params, dict):
        for k, v in params.items():
            _zip_apply(fn, v, *(o[k] for o in others), path=f"{path}{k}/")
    else:
        fn(path[:-1], params, *others)


def _mean(x: torch.Tensor, dim: int, axis, keepdim: bool = False):
    """The mean over ``dim`` of a block whose ``dim`` ``axis`` splits (the
    plain mean when None)."""
    if axis is None:
        return x.mean(dim, keepdim=keepdim)
    return (collectives.sum_(x.sum(dim, keepdim=keepdim), axis)
            / (x.shape[dim] * axis.size))


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


def clip_by_global_norm(grads, max_norm: float, layout=None):
    """(grads scaled to global norm <= ``max_norm``, the norm before).
    fp32 leaves are scaled in place, as the optimizer updates: the train
    step owns its gradients, and a scaled copy would hold a second fp32
    gradient at the step's peak (14 GB for deepseek-v3 at one layer).
    With ``layout`` the leaves are blocks: the squares are summed over the
    axes that split each leaf, one all-reduce a group of axes (without
    one, or on one device, the leaves' squares in leaf order)."""
    by_axis: dict = {}
    leaves: list = []  # in leaf order
    tree_map_with_path(lambda path, g: leaves.append((path, g)), grads)
    for path, g in leaves:
        axis = None if layout is None else layout.split_axes(path)
        key = None if axis is None else axis.name
        sq = torch.sum(torch.square(g.to(torch.float32)))
        prev = by_axis.get(key, (axis, None))[1]
        by_axis[key] = (axis, sq if prev is None else prev + sq)
    gnorm = torch.sqrt(sum(collectives.sum_(sq, axis) for _, (axis, sq)
                           in sorted(by_axis.items(),
                                     key=lambda kv: str(kv[0]))))
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

    def update(grads, state, params, step, layout=None):
        lr = sched(step)
        t = np.float32(step) + np.float32(1)
        c1 = float(np.float32(1) - np.float32(cfg.b1) ** t)
        c2 = float(np.float32(1) - np.float32(cfg.b2) ** t)

        def upd(_, p, g, m, v):
            gf = g.to(torch.float32)
            m.mul_(cfg.b1).add_((1 - cfg.b1) * gf)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(gf))
            # the reference's ops in place where a temporary allows: two
            # leaf-sized temporaries live at once instead of three
            denom = (v / c2).sqrt_().add_(cfg.eps)
            delta = (m / c1).div_(denom)
            del denom
            if p.ndim >= 2:  # no decay on norms / biases
                delta.add_(cfg.weight_decay * p.to(torch.float32))
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

    def update(grads, state, params, step, layout=None):
        lr = sched(step)
        t = np.float32(step) + np.float32(1)
        beta2 = float(np.float32(1) - t ** np.float32(-0.8))

        def upd(path, p, g, slot):
            def axis(dim):  # the group over what splits ``dim`` of p
                return None if layout is None else layout.dim_axis(path, dim)

            gf = g.to(torch.float32)
            g2 = torch.square(gf) + 1e-30
            if p.ndim >= 2:
                vr, vc = slot["vr"], slot["vc"]
                vr.mul_(beta2).add_((1 - beta2) * _mean(g2, -1, axis(-1)))
                vc.mul_(beta2).add_((1 - beta2) * _mean(g2, -2, axis(-2)))
                vhat = (vr[..., None] * vc[..., None, :]
                        / (_mean(vr, -1, axis(-2), keepdim=True)[..., None]
                           + 1e-30))
            else:
                slot["v"].mul_(beta2).add_((1 - beta2) * g2)
                vhat = slot["v"]
            u = gf / (torch.sqrt(vhat) + 1e-30)
            whole = None if layout is None else layout.split_axes(path)
            if whole is None:
                ms = torch.mean(torch.square(u))
            else:
                ms = (collectives.sum_(torch.sum(torch.square(u)), whole)
                      / layout.whole_numel(path))
            rms = torch.sqrt(ms + 1e-30)
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

    def update(grads, state, params, step, layout=None):
        lr = sched(step)

        def upd(_, p, g, m):
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
