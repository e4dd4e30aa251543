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

``lower_step(run, mesh)`` (the reference's ``:123-138``, which jits the
step with the cell's ``in_shardings`` and lowers it: one device's program
as the SPMD partitioner builds it) returns ``(bundle, traced)``:
:class:`TracedStep`, one call of rank 0's sharded step on ``meta``
tensors under the cost counter of :mod:`repro_torch.launch.hlo_analysis`,
with ``cost_analysis()``, ``memory_analysis()`` and ``as_text()``.
Nothing is allocated and nothing is derived: the step is the one a rank
executes (``make_train_step`` / ``make_prefill_step`` /
``make_decode_step`` with ``mesh=``), built on
:meth:`~repro_torch.launch.mesh.MeshSpec.traced` (the cell's mesh at rank
0's coordinates, whose collectives record themselves and move no data),
and called on the arguments rank 0 holds:

- the parameters, rank 0's blocks under the rules' placements
  (:func:`~repro_torch.sharding.layout.shard_params`); the train state as
  the rank initializes it (``init_train_state(..., mesh=)``: the blocks
  and their optimizer slots);
- the batch and the decode tokens, rank 0's rows where the placements
  split them over the data axes (:func:`~repro_torch.launch.mesh.
  local_shard`; a batch of 1 row stays whole);
- the decode state as the rank holds it (``init_decode_state(...,
  layout=)``: its rows, a GQA cache at its KV heads, an SSM state at its
  channels or heads, MLA's latents and the vlm / audio inputs whole over
  the model axis).  The bundle's placements of the state
  (``sharding.specs.cache_specs``) keep the reference's specs, which
  split a cache's last divisible dim instead.

So the FLOPs, bytes and live bytes are those of the ops the rank runs at
the shapes it holds (the model axis' heads and channels, FSDP's gathered
blocks, the experts of its rank, the stream's sequence block under
``sp``), and the collectives are the ones it sends, in program order
(``kind``, operand bytes, the mesh axes of the group), each in its
tensor's dtype.  The memory analysis is per chip: the arguments (exact),
the traced peak of temporaries, the outputs (the donated arguments and
the new results), the donated arguments.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.registry import input_specs, serve_state_template
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import (MeshSpec, batch_shardings, local_shard,
                                     params_shardings, serve_shardings,
                                     state_shardings)
from repro_torch.models.model import build_model
from repro_torch.sharding.layout import Layout, shard_params
from repro_torch.sharding.specs import P, data_axes_of, to_placements
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.train_step import (init_train_state, make_train_step,
                                          metric_names, train_state_template)
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
            fn=make_prefill_step(model, run, mesh=mesh),
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
        fn=make_decode_step(model, run, mesh=mesh),
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


# --------------------------------------------------------------------------
# lower_step: rank 0's sharded step, traced
# --------------------------------------------------------------------------

class MemoryAnalysis(NamedTuple):
    """Bytes per chip, the fields of XLA's memory analysis."""
    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int
    alias_size_in_bytes: int
    peak_memory_in_bytes: int


class TracedStep:
    """One traced call of a step (:func:`lower_step`): the counter's
    record, with the reference's compiled-step accessors."""

    def __init__(self, counter: hlo_analysis.OpCounter,
                 memory: MemoryAnalysis):
        self.counter = counter
        self.memory = memory

    def cost_analysis(self) -> hlo_analysis.OpCosts:
        return self.counter.costs()

    def memory_analysis(self) -> MemoryAnalysis:
        return self.memory

    def as_text(self) -> str:
        return self.counter.as_text()


def _spec_of(placements, mesh: MeshSpec):
    """The :class:`PartitionSpec` of DTensor placements over ``mesh``."""
    from torch.distributed.tensor import Shard

    by_dim: Dict[int, list] = {}
    for axis, pl in zip(mesh.axis_names, placements):
        if isinstance(pl, Shard):
            by_dim.setdefault(pl.dim, []).append(axis)
    ndim = 1 + max(by_dim, default=-1)
    return P(*(tuple(by_dim[d]) if d in by_dim else None
               for d in range(ndim)))


def _rank_block(tree, placements, mesh: MeshSpec):
    """Rank 0's block of every tensor of ``tree`` under its placements (a
    fresh ``meta`` tensor each)."""
    coords = {a: 0 for a in mesh.axis_names}

    def one(leaf, plc):
        if isinstance(leaf, dict):
            return {k: one(leaf[k], plc[k]) for k in leaf}
        if not isinstance(leaf, torch.Tensor):
            return leaf
        block = local_shard(leaf, _spec_of(plc, mesh), mesh, coords)
        return torch.empty(block.shape, dtype=block.dtype, device="meta")

    return one(tree, placements)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in hlo_analysis.tensors(tree))


def _rank_step(run: RunConfig, bundle: StepBundle, mesh: MeshSpec,
               traced: MeshSpec):
    """Rank 0's step on the ``traced`` mesh and the arguments it holds."""
    cfg = run.model
    model = build_model(cfg, run.parallel, device="meta")
    kind = bundle.kind
    if kind == "train":
        optimizer = make_optimizer(run.train)
        state = init_train_state(model, run, optimizer, mesh=traced)
        batch = _rank_block(bundle.abstract_args[1], bundle.in_shardings[1],
                            mesh)
        return (make_train_step(model, run, optimizer, mesh=traced),
                (state, batch))
    params = shard_params(bundle.abstract_args[0], run, traced, 0)
    if kind == "prefill":
        batch = _rank_block(bundle.abstract_args[1], bundle.in_shardings[1],
                            mesh)
        return make_prefill_step(model, run, mesh=traced), (params, batch)
    tokens = _rank_block(bundle.abstract_args[2], bundle.in_shardings[2],
                         mesh)
    layout = Layout.of(bundle.abstract_args[0], run, traced)
    state = serve_state_template(run, tokens.shape[0], run.shape.seq_len,
                                 layout=layout)
    return (make_decode_step(model, run, mesh=traced),
            (params, state, tokens))


def lower_step(run: RunConfig, mesh: MeshSpec, *,
               stub_dtype: Optional[torch.dtype] = None,
               peak_tensors: int = 0):
    """The step of ``run`` on ``mesh``, rank 0's program traced once on
    ``meta`` tensors: ``(bundle, traced)`` (see the module docstring).
    ``stub_dtype``: the dtype of the vlm / audio stub inputs
    (``vision_embeds`` / ``frames``) the train or prefill step receives,
    where it is not the input specs' (the model's, as the reference's);
    the train CLI's data gives fp32 ones (``data.pipeline``).
    ``peak_tensors``: how many of the largest groups of storages live at
    the peak the counter keeps (``traced.counter.peak_live``)."""
    bundle = _with_stubs(build_step(run, mesh), stub_dtype)
    traced = MeshSpec.traced(tuple(mesh.shape[a] for a in mesh.axis_names),
                             mesh.axis_names, rank=0)
    fn, args = _rank_step(run, bundle, mesh, traced)
    counter = hlo_analysis.OpCounter(peak_tensors)
    arg_bytes = _nbytes(args)
    alias_bytes = sum(_nbytes(args[i]) for i in bundle.donate_argnums)
    out = hlo_analysis.trace(fn, args, train=bundle.kind == "train",
                             counter=counter)
    out_bytes = alias_bytes + counter.result_bytes(out)
    del out
    for kind, axes, nbytes in traced.recorder.entries:
        counter.add_collective(kind, nbytes, axes)
    temp = counter.peak_live_bytes
    memory = MemoryAnalysis(arg_bytes, out_bytes, temp, alias_bytes,
                            arg_bytes + temp)
    return bundle, TracedStep(counter, memory)


def _with_stubs(bundle: StepBundle, dtype: Optional[torch.dtype]
                ) -> StepBundle:
    """``bundle`` with its batch's stub inputs in ``dtype`` (as it is
    without one, and for a decode step, whose batch is its tokens)."""
    if dtype is None or bundle.kind == "decode":
        return bundle
    batch = {k: torch.empty(v.shape, dtype=dtype, device="meta")
             if k in ("frames", "vision_embeds") else v
             for k, v in bundle.abstract_args[1].items()}
    return bundle._replace(abstract_args=(bundle.abstract_args[0], batch)
                           + tuple(bundle.abstract_args[2:]))
