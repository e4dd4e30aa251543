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
- global-norm clipping, z-loss, the MoE aux loss (``moe_aux_loss * aux``)
  and DeepSeek's MTP loss (0.3 x the cross-entropy of the next-but-one
  token, from ``mtp_logits``), with accuracy metrics;
- the vlm / audio stub inputs (``vision_embeds`` / ``frames``) passed
  from the batch into the forward as they are: fp32 inputs meet the bf16
  compute copy and promote where they meet a weight, as jax promotes them;
- the launch configuration installed with ``exclusive=True`` around the
  step body, so a step is a function of its ``launch_config`` alone;
- sharded execution over an executing mesh (``mesh``): each rank holds
  its block of every leaf under the rules' placements and steps on the
  rows of its data coordinate (the model ranks of one data coordinate
  take the same rows).  The forward runs on a
  :class:`~repro_torch.sharding.layout.Layout`: tensor-parallel products,
  FSDP blocks gathered before use (their gradients reduce-scattered),
  experts on their ranks.  The loss's sums and counts, the MoE statistics
  and the gradients of the leaves the data axes replicate are summed over
  the data ranks, so every rank computes the step of one process on the
  whole batch: each rank differentiates its share of the global loss and
  the shares' gradients are summed in buckets
  (``grad.all_reduce_grads``), before ``int8_ef`` compression, as the
  reference compresses the global loss's gradient; the optimizer's
  statistics sum the blocks of each leaf.  Under sequence parallelism
  (``sp``) the leaves applied to the stream's sequence blocks (the norm
  scales, the vlm gate: ``Layout.on_stream``) have their gradients summed
  over the model axis first, in the same buckets.  Under a model split of
  the vocab the logits stay each rank's vocab block and the loss runs on
  the blocks (``cross_entropy_loss(..., vocab=)``: the rows' statistics
  all-reduced, no rank forming a whole row), the MTP loss too;
- the reference's ``remat`` policies (``ParallelConfig.remat``): the
  forward runs each layer body under ``torch.utils.checkpoint``
  (:func:`repro_torch.models.transformer.remat`), so the backward
  recomputes what the policy does not keep — the same step, with a lower
  peak and more FLOPs.

The optimizer updates parameters and moments in place
(:mod:`repro_torch.train.optimizer`), so the returned state holds the
tensors of the state it was given.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import MeshSpec
from repro_torch.models.layers import lm_logits, vocab_axis
from repro_torch.models.model import Model, build_model, torch_dtype
from repro_torch.models.transformer import mtp_logits
from repro_torch.sharding.layout import Layout, Scope, shard_params
from repro_torch.train.grad import (
    all_reduce_grads, all_reduce_sum, compress_int8_ef, cross_entropy_loss,
    init_error_buffer)
from repro_torch.train.optimizer import (
    Optimizer, clip_by_global_norm, make_schedule)
from repro_torch.utils.config import RunConfig
from repro_torch.utils.trees import (tree_cast, tree_leaves, tree_map,
                                     tree_map_with_path)


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int
    error_buf: Optional[Any] = None  # int8-EF compression residual


def init_train_state(model: Model, run: RunConfig, optimizer: Optimizer,
                     seed: int = 0, params: Optional[Dict] = None,
                     mesh=None) -> TrainState:
    """Master parameters (drawn from ``seed``, or the given ``params``,
    e.g. imported from the reference) in ``param_dtype``, fresh optimizer
    state and step 0.  On an executing ``mesh`` every leaf is this rank's
    block (:func:`~repro_torch.sharding.layout.shard_params`)."""
    if params is None:
        params = model.init(seed)
    if mesh is not None and mesh.groups is not None:
        # cut before the cast: the whole masters never exist
        params = shard_params(params, run, mesh, mesh.rank)
    params = tree_cast(params, torch_dtype(run.train.param_dtype))
    opt_state = optimizer.init(params)
    err = (init_error_buffer(params)
           if run.parallel.grad_compression == "int8_ef" else None)
    return TrainState(params, opt_state, 0, err)


def train_state_template(model: Model, run: RunConfig,
                         optimizer: Optimizer) -> TrainState:
    """:func:`init_train_state`'s structure, shapes and dtypes on the
    ``meta`` device — nothing allocated: the restore template of a
    checkpoint, where the reference takes ``jax.eval_shape``."""
    meta = build_model(model.cfg, run.parallel, device="meta")
    return init_train_state(meta, run, optimizer)


def metric_names(cfg, tc) -> Tuple[str, ...]:
    """The keys of the metrics a train step returns, from the configs
    alone (the output template of
    :func:`repro_torch.launch.build.build_step`)."""
    names = ["ce_loss", "accuracy", "loss", "grad_norm", "lr"]
    if tc.z_loss > 0.0:
        names.append("z_loss")
    if cfg.is_moe:
        names.append("moe_aux")
    if cfg.mtp_depth > 0:
        names.append("mtp_loss")
    return tuple(sorted(names))


def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def make_train_step(model: Model, run: RunConfig, optimizer: Optimizer,
                    launch_config: Optional[Dict] = None, *, mesh=None
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """``train_step(state, batch)``; with ``mesh`` (the
    :class:`~repro_torch.launch.mesh.MeshSpec` the run executes on) a
    sharded step: ``state`` holds this rank's blocks under the rules'
    placements (:func:`init_train_state` with the mesh) and ``batch`` the
    rows of this rank's data coordinate.  Without ``mesh``, the step of
    one process (the one-device description).  On a description the mesh's
    process groups are looked up at the first call, so a step may be built
    on one (the dry run's bundle); stepping on a description with an axis
    above 1 raises."""
    if mesh is None:
        mesh = MeshSpec.of((1,), ("data",))
    cfg = model.cfg
    tc = run.train
    par = run.parallel
    compute_dtype = torch_dtype(tc.compute_dtype)
    n_micro = par.microbatch
    dispatch.split_launch_config(launch_config or {})  # eager validation
    bound: Dict[str, Any] = {}

    def layout_of() -> Layout:
        if "layout" not in bound:
            shapes = build_model(cfg, par, device="meta").init(0)
            bound["layout"] = Layout.of(shapes, run, mesh)
        return bound["layout"]

    if mesh.groups is not None:  # an executing or traced mesh: made now
        layout_of()

    def loss_fn(params_c, batch, layout):
        inputs, targets = batch["inputs"], batch["targets"]
        group = layout.data
        world = group.size if group is not None else 1
        fkw = {"layout": layout}
        if cfg.family == "vlm":
            fkw["vision_embeds"] = batch["vision_embeds"]
        if cfg.family == "audio":
            fkw["frames"] = batch["frames"]
        head = Scope.top(layout, inputs.shape[1])["embed"]
        vocab = vocab_axis(params_c["embed"], head)
        if cfg.mtp_depth > 0:
            h, _, aux = model.forward(params_c, inputs, return_hidden=True,
                                      **fkw)
            logits = lm_logits(params_c["embed"], h, head)
        else:
            logits, _, aux = model.forward(params_c, inputs, **fkw)
        loss, metrics = cross_entropy_loss(logits, targets, z_loss=tc.z_loss,
                                           group=group, vocab=vocab)
        if cfg.is_moe:
            # every rank holds the global aux loss: its share is 1/world
            loss = loss + tc.moe_aux_loss * (aux / world if group is not None
                                             else aux)
            metrics["moe_aux"] = aux
        if cfg.mtp_depth > 0:
            positions = torch.arange(inputs.shape[1], device=inputs.device)
            lg2 = mtp_logits(params_c, cfg, par, h, targets, positions,
                             layout=layout)
            mtp_tgt = torch.cat([targets[:, 1:],
                                 torch.full_like(targets[:, :1], -1)], dim=1)
            mtp_loss, mtp_metrics = cross_entropy_loss(lg2, mtp_tgt,
                                                       group=group,
                                                       vocab=vocab)
            loss = loss + 0.3 * mtp_loss
            metrics["mtp_loss"] = mtp_metrics["ce_loss"]
        metrics["loss"] = (loss if group is None else
                           all_reduce_sum({"loss": loss.detach()},
                                          group)["loss"])
        return loss, metrics

    def grads_of(params, batch, layout):
        if par.grad_compression in ("bf16", "int8_ef"):
            # differentiate w.r.t. the bf16 copies (the reference's
            # half-size all-reduce), then widen
            wrt = tree_map(lambda p: p.detach().to(compute_dtype)
                           .requires_grad_(), params)
            params_c = wrt
        else:
            wrt = tree_map(lambda p: p.detach().requires_grad_(), params)
            params_c = tree_cast(wrt, compute_dtype)
        # every FSDP block but the stacked layers' (gathered a layer slice
        # at a time in the forward), gathered once
        params_c = {k: v if k == "blocks" else layout.gather(v, f"{k}/")
                    for k, v in params_c.items()}
        try:
            with layout.saved_tensors():
                loss, metrics = loss_fn(params_c, batch, layout)
        finally:
            layout.release()
        del params_c
        paths: list = []
        tree_map_with_path(lambda path, _: paths.append(path), wrt)
        leaves = tree_leaves(wrt)  # in the order of ``paths``
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        grads = [g.to(torch.float32) for g in grads]
        if layout.seq_axis(batch["inputs"].shape[1]) is not None:
            # the leaves applied to the stream's sequence blocks: each
            # model rank holds its block's share
            all_reduce_grads([g for path, g in zip(paths, grads)
                              if layout.on_stream(path)], layout.model)
        group = layout.data
        if group is not None:
            # FSDP gradients were reduce-scattered in the backward and an
            # expert block's gradient is whole: the rest sum over the
            # data ranks
            all_reduce_grads([g for path, g in zip(paths, grads)
                              if layout.data_replicated(path)], group)
        return (_unflatten(params, grads),
                {k: v.detach() for k, v in metrics.items()})

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        layout = layout_of()
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        with dispatch.use_launch_config(launch_config, exclusive=True):
            if n_micro > 1:
                grads, metrics = None, None
                for i in range(n_micro):
                    mb = {k: v.chunk(n_micro, dim=0)[i]
                          for k, v in batch.items()}
                    g, metrics = grads_of(state.params, mb, layout)
                    grads = g if grads is None else tree_map(
                        torch.add, grads, g)
                grads = tree_map(lambda g: g / n_micro, grads)
            else:
                grads, metrics = grads_of(state.params, batch, layout)

            new_err = state.error_buf
            if par.grad_compression == "int8_ef":
                grads, new_err = compress_int8_ef(grads, state.error_buf,
                                                  layout.split_axes)

            grads, gnorm = clip_by_global_norm(grads, tc.grad_clip, layout)
            new_params, new_opt = optimizer.update(
                grads, state.opt_state, state.params, state.step,
                layout=layout)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = make_schedule(tc)(state.step)
        return (TrainState(new_params, new_opt, state.step + 1, new_err),
                metrics)

    return train_step
