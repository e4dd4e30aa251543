"""Assemble a cell's step function with its abstract arguments and
placements — the port of :mod:`repro.launch.build`.

``build_step(run, mesh)`` returns a :class:`StepBundle`: the step (train,
prefill or decode, by ``run.shape.kind``), its arguments as trees of
``meta`` tensors (shapes and dtypes, nothing allocated; where the
reference takes ``jax.eval_shape``), and the DTensor placements of its
inputs and outputs over ``mesh`` (:mod:`repro_torch.launch.mesh`), with
the arguments the step consumes (``donate_argnums``).  The outputs'
placements come from the outputs' structure, known without running the
step: the train state and its metrics; the decode state and the last
position's logits.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple


from repro_torch.configs.registry import input_specs, serve_state_template
from repro_torch.launch.mesh import (MeshSpec, batch_shardings,
                                     params_shardings, serve_shardings,
                                     state_shardings)
from repro_torch.models.model import build_model
from repro_torch.sharding.specs import P, data_axes_of, to_placements
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.train_step import (make_train_step, metric_names,
                                          train_state_template)
from repro_torch.utils.config import RunConfig


class StepBundle(NamedTuple):
    fn: Callable                     # the step function
    abstract_args: Tuple[Any, ...]   # meta-tensor trees, one per argument
    in_shardings: Tuple[Any, ...]    # placement trees, one per argument
    out_shardings: Any
    donate_argnums: Tuple[int, ...]
    kind: str


def build_step(run: RunConfig, mesh: MeshSpec) -> StepBundle:
    cfg = run.model
    model = build_model(cfg, run.parallel, device="meta")
    specs = input_specs(run)
    kind = run.shape.kind
    replicated = to_placements(P(), mesh.axis_names)

    if kind == "train":
        optimizer = make_optimizer(run.train)
        state_t = train_state_template(model, run, optimizer)
        batch_t = specs["batch"]
        state_sh = state_shardings(state_t, run, mesh)
        metrics_sh = {k: replicated for k in metric_names(cfg, run.train)}
        return StepBundle(
            fn=make_train_step(model, run, optimizer, mesh=mesh),
            abstract_args=(state_t, batch_t),
            in_shardings=(state_sh, batch_shardings(batch_t, mesh)),
            out_shardings=(state_sh, metrics_sh),
            donate_argnums=(0,),
            kind=kind,
        )

    params_t = model.init(run.train.seed)
    params_sh = params_shardings(params_t, run, mesh)
    b, s = run.shape.global_batch, run.shape.seq_len
    logits_sh = _logits_sharding((b, cfg.vocab_size), mesh)

    if kind == "prefill":
        batch_t = specs["batch"]
        out_state = serve_state_template(run, b, s)
        return StepBundle(
            fn=make_prefill_step(model, run),
            abstract_args=(params_t, batch_t),
            in_shardings=(params_sh, batch_shardings(batch_t, mesh)),
            out_shardings=(serve_shardings(out_state, run, mesh), logits_sh),
            donate_argnums=(),
            kind=kind,
        )

    if kind != "decode":
        raise ValueError(f"unknown shape kind {kind!r}")
    state_t, tokens_t = specs["state"], specs["tokens"]
    state_sh = serve_shardings(state_t, run, mesh)
    return StepBundle(
        fn=make_decode_step(model, run),
        abstract_args=(params_t, state_t, tokens_t),
        in_shardings=(params_sh, state_sh, batch_shardings(tokens_t, mesh)),
        out_shardings=(state_sh, logits_sh),
        donate_argnums=(1,),  # decode state is consumed each step
        kind=kind,
    )


def _logits_sharding(shape: Tuple[int, ...], mesh: MeshSpec):
    """Logits (B, V): batch over the data axes, vocab over "model", each
    where it divides."""
    daxes = data_axes_of(mesh.axis_names)
    dsize = math.prod(mesh.shape[a] for a in daxes) if daxes else 1
    msize = mesh.shape.get("model", 1)
    spec = [None] * len(shape)
    if daxes and shape[0] % dsize == 0:
        spec[0] = daxes
    if msize > 1 and shape[-1] % msize == 0:
        spec[-1] = "model"
    return to_placements(P(*spec), mesh.axis_names)
