"""Train-step factory — the port of :mod:`repro.train.train_step`.

``make_train_step(model, run, optimizer)`` returns ``train_step(state,
batch) -> (state, metrics)`` with:

- mixed precision: fp32 master parameters (``TrainConfig.param_dtype``)
  and a compute copy in ``compute_dtype`` (bf16) made by a differentiable
  cast each step, so gradients arrive in fp32 on the masters.  With
  ``grad_compression`` ``"bf16"`` or ``"int8_ef"`` the gradients are taken
  with respect to the bf16 copies instead (and ``int8_ef`` adds error-
  feedback int8 quantization), as in the reference;
- microbatch accumulation (``ParallelConfig.microbatch``): a Python loop
  where the reference uses ``lax.scan``; gradients are averaged and the
  metrics are the last microbatch's;
- global-norm clipping, z-loss and accuracy metrics;
- the launch configuration installed with ``exclusive=True`` around the
  step body, so a step is a function of its ``launch_config`` alone.

The reference's ``remat`` is dropped: the CLI trains with
``ParallelConfig()`` (``remat="none"``), and the kernels' recompute
backward (:mod:`repro_torch.kernels.ops`) already keeps only their inputs.
The optimizer updates parameters and moments in place
(:mod:`repro_torch.train.optimizer`), so the returned state holds the
tensors of the state it was given.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import dispatch
from repro_torch.models.model import Model, torch_dtype
from repro_torch.train.grad import (
    compress_int8_ef, cross_entropy_loss, init_error_buffer)
from repro_torch.train.optimizer import (
    Optimizer, clip_by_global_norm, make_schedule)
from repro_torch.utils.config import RunConfig
from repro_torch.utils.trees import tree_cast, tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int
    error_buf: Optional[Any] = None  # int8-EF compression residual


def init_train_state(model: Model, run: RunConfig, optimizer: Optimizer,
                     seed: int = 0, params: Optional[Dict] = None
                     ) -> TrainState:
    """Master parameters (drawn from ``seed``, or the given ``params``,
    e.g. imported from the reference) in ``param_dtype``, fresh optimizer
    state and step 0."""
    if params is None:
        params = model.init(seed)
    params = tree_cast(params, torch_dtype(run.train.param_dtype))
    opt_state = optimizer.init(params)
    err = (init_error_buffer(params)
           if run.parallel.grad_compression == "int8_ef" else None)
    return TrainState(params, opt_state, 0, err)


def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def make_train_step(model: Model, run: RunConfig, optimizer: Optimizer,
                    launch_config: Optional[Dict] = None
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    cfg = model.cfg
    tc = run.train
    par = run.parallel
    compute_dtype = torch_dtype(tc.compute_dtype)
    n_micro = par.microbatch
    dispatch.split_launch_config(launch_config or {})  # eager validation
    if cfg.family not in ("dense", "ssm", "hybrid"):
        raise NotImplementedError(f"{cfg.name}: training the {cfg.family} "
                                  f"family is not ported yet")

    def loss_fn(params_c, batch):
        logits, _, _ = model.forward(params_c, batch["inputs"])
        loss, metrics = cross_entropy_loss(logits, batch["targets"],
                                           z_loss=tc.z_loss)
        metrics["loss"] = loss
        return loss, metrics

    def grads_of(params, batch):
        if par.grad_compression in ("bf16", "int8_ef"):
            # differentiate w.r.t. the bf16 copies (the reference's
            # half-size all-reduce), then widen
            wrt = tree_map(lambda p: p.detach().to(compute_dtype)
                           .requires_grad_(), params)
            params_c = wrt
        else:
            wrt = tree_map(lambda p: p.detach().requires_grad_(), params)
            params_c = tree_cast(wrt, compute_dtype)
        loss, metrics = loss_fn(params_c, batch)
        leaves = tree_leaves(wrt)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        grads = _unflatten(params, [g.to(torch.float32) for g in grads])
        return grads, {k: v.detach() for k, v in metrics.items()}

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        with dispatch.use_launch_config(launch_config, exclusive=True):
            if n_micro > 1:
                grads, metrics = None, None
                for i in range(n_micro):
                    mb = {k: v.chunk(n_micro, dim=0)[i]
                          for k, v in batch.items()}
                    g, metrics = grads_of(state.params, mb)
                    grads = g if grads is None else tree_map(
                        torch.add, grads, g)
                grads = tree_map(lambda g: g / n_micro, grads)
            else:
                grads, metrics = grads_of(state.params, batch)

            new_err = state.error_buf
            if par.grad_compression == "int8_ef":
                grads, new_err = compress_int8_ef(grads, state.error_buf)

            grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
            new_params, new_opt = optimizer.update(grads, state.opt_state,
                                                   state.params, state.step)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = make_schedule(tc)(state.step)
        return (TrainState(new_params, new_opt, state.step + 1, new_err),
                metrics)

    return train_step
