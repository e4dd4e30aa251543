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

``lower_step(run, mesh)`` (the reference's ``:123-138``, which jits and
lowers) returns ``(bundle, traced)``: :class:`TracedStep`, one call of
the step on ``meta`` tensors under the cost counter of
:mod:`repro_torch.launch.hlo_analysis`, with ``cost_analysis()``,
``memory_analysis()`` and ``as_text()``.  Nothing is allocated.

What is traced: the program of one rank on the data axes.  Every
argument but the parameters (the batch; the decode state) is cut to one
data rank's block wherever its placement splits it over the data axes (a
batch of 1 row stays whole), and the step is built on a one-device
``("data",)`` mesh without process groups, so no collective runs and
``activation_sharding`` does not raise.  The parameters and the
optimizer state stay whole: the rank all-gathers an FSDP shard before
use.  Under the sequence rule a train step's stream is traced at a
rank's sequence block ``(B, S/m, D)``: its layout cuts it over an axis
that moves no data (``sharding.layout.traced_sequence``), so the norms,
the residual adds and the live bytes between sublayers count what a rank
holds, and every sublayer reads its gathered input whole.

What is derived, not traced (``model_axis: "derived"`` in a dry-run
record): what the mesh's model axis and FSDP / EP add, from the
placements of ``bundle.in_shardings``, by rules that mirror what the
sharded step executes (:mod:`repro_torch.sharding.layout`; tracing a
rank's sharded program instead is ``ROADMAP.md`` queue 1, item 7.3):

- argument bytes per chip: each leaf's block under its placements
  (:func:`repro_torch.launch.mesh.local_shard`'s shapes), exact;
- FLOPs, bytes and live bytes: the counter's split rules
  (:mod:`repro_torch.launch.hlo_analysis`): what reads a parameter or an
  activation split over the model axis counts divided by the axis' size,
  and a partial sum is whole again; a non-matmul op reading an FSDP- or
  EP-split leaf itself (the cast to the compute dtype, the optimizer's
  update) counts divided by the data axes' size;
- the collectives the placements imply (operand bytes, as the reference
  counts them):

  - data parallelism, a train step over data axes of size > 1: the
    gradient all-reduce of every parameter the data axes replicate, in
    fp32, packed into buckets as ``train/grad.py::all_reduce_grads``
    packs them, and the loss's sums (``cross_entropy_loss``'s 3 or 4
    fp32 sums, the loss itself, the MTP head's 3), each once a
    microbatch; a MoE router's statistics, two all-reduces of E fp32 in
    the forward and one in the backward a routed layer (none in the
    backward of the MTP head's, whose aux loss the train loss leaves out);
  - FSDP: an all-gather of each data-split parameter's block per use, a
    use a layer slice in the forward and again in the backward (a train
    step, each microbatch; serving, once; no backward gather where no
    op saves the gathered weight: an untied embedding's lookup, a
    router widened to fp32), in the compute dtype; a reduce-scatter of
    its fp32 gradient a layer slice and microbatch; an expert block
    split over the data axes (EP) is neither gathered nor reduced;
  - TP (``_tp_collectives``): the all-reduce of a row-parallel
    product's partial sums (``attn/wo``, ``cross/wo``, ``mlp/w_down``,
    ``shared/w_down``, ``mixer/w_out``, ``mixer/w_bcdt``); in a train
    step's
    backward an all-reduce of each input gradient where a tensor every
    model rank holds enters the split (the attention, cross-attention,
    MLP and mixer inputs, MLA's ``c_q`` / ``c_kv`` / rope key, Mamba-1's
    ``w_bcdt`` sums, Mamba-2's ``dt`` / ``A`` / ``B`` and ``C``, the MoE
    tokens and gates, the head's input, the audio encoder's output once
    for the decoder's cross K/V); the vocab split's embedding all-reduce
    and (train) logits all-gather, ``frame_proj``'s and ``mtp/proj``'s
    all-gather of their column blocks, Mamba-2's norm statistics both
    ways, and the MoE combine's all-reduce where no split shared expert
    carries it; where the split cuts through heads (more ranks than KV
    heads, or a query block that is no whole number of heads;
    ``models.attention.split_heads``) the all-gather of the rank's query
    or key and value products and the reduce-scatter of their gradients;
  - SP, a train or prefill step under ``sp`` whose sequence the model
    axis divides (``sharding.specs.sequence_blocks``; not the audio
    family, not decode): the stream between sublayers is a sequence
    block, so each sublayer's input is all-gathered (the block's bytes;
    the backward reduce-scatters the whole input gradient where the
    input feeds column-split products, in place of the all-reduce
    above), a row-parallel product's partial sums are reduce-scattered
    (in place of the all-reduce; the backward all-gathers the block's
    gradient), a whole output is sliced
    (its backward all-gathers), the embedding's partial sums are
    reduce-scattered, the stream is gathered before the head (a train
    step's) and before the MTP head (which runs whole), and the gradients of the leaves
    applied to the stream (``Layout.on_stream``: the norm scales, the
    vlm gate) are all-reduced over the model axis in fp32 buckets;
  - EP: a forward matmul reading an expert down projection whose expert
    dim is split over the data axes gives the two token all-to-alls of
    the layer (dispatch and combine, each of the ``(G, E, C, D)`` expert
    tensor), two more for the backward of a train step;
  - the optimizer's statistics over split leaves (the global norm, the
    ``int8_ef`` scales, Adafactor's factored means;
    ``_optimizer_collectives``).

Each derived collective is in its tensor's dtype: the compute dtype,
but the audio encoder's (and its output's) and a cross K/V's in the
dtype a wider stub input promotes them to (``lower_step(...,
stub_dtype=)``).  Two approximations remain: a prefill step's stream is
traced whole under ``sp`` (only the train step executes sharded), and a
query block that is no whole number of heads (llama4-maverick at tp=16:
2.5) counts the attention at ``H/m`` heads a rank where the rank
computes the 3 heads its rows cross.  The memory analysis is per chip: the
arguments' blocks (exact), the traced peak of temporaries under the split
rules, the outputs (the donated arguments' blocks and the new results),
the donated arguments.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, \
    Tuple

import torch

from repro_torch.configs.registry import input_specs, serve_state_template
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import (MeshSpec, batch_shardings, local_shard,
                                     params_shardings, serve_shardings,
                                     state_shardings)
from repro_torch.models.model import build_model, torch_dtype
from repro_torch.sharding.layout import Layout, traced_sequence
from repro_torch.sharding.specs import (P, data_axes_of, sequence_blocks,
                                        to_placements)
from repro_torch.train.grad import bucket_ranges
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.train_step import (make_train_step, metric_names,
                                          train_state_template)
from repro_torch.utils.config import MeshConfig, RunConfig


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


# --------------------------------------------------------------------------
# lower_step: the traced step and what the mesh adds to it
# --------------------------------------------------------------------------

_ROW = re.compile(r"(attn|cross)/wo$|mlp/w_down$|shared/w_down$"
                  r"|mixer/w_out$|mixer/w_bcdt$")
_EXPERT = re.compile(r"moe/w_down$")
_EXPERTS = re.compile(r"moe/w_(gate|up|down)$")
_ROUTER = re.compile(r"moe/router$")
#: fp32 sums a data-parallel train step all-reduces a microbatch besides
#: the gradients: ``cross_entropy_loss``'s (ce_loss, count, accuracy,
#: [z_loss]) and the loss metric; the MTP head's cross-entropy
_LOSS_SUMS, _MTP_SUMS = 3, 3


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
                 memory: MemoryAnalysis, model_axis: str):
        self.counter = counter
        self.memory = memory
        #: "derived" when the model axis or FSDP / EP add to the traced
        #: program, "none" when the traced program is the chip's
        self.model_axis = model_axis

    def cost_analysis(self) -> hlo_analysis.OpCosts:
        return self.counter.costs()

    def memory_analysis(self) -> MemoryAnalysis:
        return self.memory

    def as_text(self) -> str:
        return self.counter.as_text()


def _leaves(arg, plc, path: str = "") -> Iterator[Tuple[str, Any, Any]]:
    """``(path, leaf, placements)`` of an argument tree beside its tree of
    placements (a leaf's placements are one tuple, not a subtree)."""
    if isinstance(arg, dict):
        for k in sorted(arg):
            yield from _leaves(arg[k], plc[k], f"{path}{k}/")
    elif isinstance(arg, (list, tuple)):
        names = arg._fields if hasattr(arg, "_fields") else range(len(arg))
        for name, a, p in zip(names, arg, plc):
            yield from _leaves(a, p, f"{path}{name}/")
    elif arg is not None:
        yield path[:-1], arg, plc


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


def _split(spec, mesh: MeshSpec, axes) -> int:
    return math.prod(mesh.shape[a] for entry in spec if entry is not None
                     for a in ((entry,) if isinstance(entry, str) else entry)
                     if a in axes)


def _block(t: torch.Tensor, spec, mesh: MeshSpec) -> torch.Tensor:
    """Rank 0's block of ``t`` under ``spec`` (a view)."""
    return local_shard(t, spec, mesh, {a: 0 for a in mesh.axis_names})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def lower_step(run: RunConfig, mesh: MeshSpec, *,
               stub_dtype: Optional[torch.dtype] = None):
    """The step of ``run`` on ``mesh``, traced once on ``meta`` tensors:
    ``(bundle, traced)`` (see the module docstring for what is traced and
    what is derived).  ``stub_dtype``: the dtype of the vlm / audio stub
    inputs (``vision_embeds`` / ``frames``) the train or prefill step
    receives, where it is not the input specs' (the model's, as the
    reference's); the train CLI's data gives fp32 ones
    (``data.pipeline``)."""
    bundle = _with_stubs(build_step(run, mesh), stub_dtype)
    train = bundle.kind == "train"
    daxes = data_axes_of(mesh.axis_names)
    dsize = math.prod(mesh.shape[a] for a in daxes)
    msize = mesh.shape.get("model", 1)
    n_micro = run.parallel.microbatch if train else 1
    compute = torch_dtype(run.train.compute_dtype if train
                          else run.model.dtype)

    # one data rank's program: its rows of the batch (and of the decode
    # state) where they split, on the one-device mesh
    b = run.shape.global_batch
    rank = _with_stubs(build_step(run.replace(
        shape=dataclasses.replace(run.shape, global_batch=b // dsize
                                  if b % dsize == 0 else b),
        mesh=MeshConfig(shape=(1,), axes=("data",))),
        MeshSpec.of((1,), ("data",))), stub_dtype)
    stub = next((rank.abstract_args[1][k].dtype
                 for k in ("frames", "vision_embeds")
                 if bundle.kind != "decode" and k in rank.abstract_args[1]),
                compute)

    counter = hlo_analysis.OpCounter(train=train, data_size=dsize)
    arg_bytes = alias_bytes = 0
    for i, (arg, plc) in enumerate(zip(bundle.abstract_args,
                                       bundle.in_shardings)):
        for _, leaf, pl in _leaves(arg, plc):
            if isinstance(leaf, torch.Tensor):
                nbytes = _nbytes(_block(leaf, _spec_of(pl, mesh), mesh))
                arg_bytes += nbytes
                alias_bytes += nbytes if i in bundle.donate_argnums else 0
    # the parameter-like leaves (argument 0) as traced, with their specs
    params = [(path, leaf, _spec_of(pl, mesh)) for path, leaf, pl in
              _leaves(rank.abstract_args[0], bundle.in_shardings[0])
              if isinstance(leaf, torch.Tensor)]

    derived = msize > 1
    blocks = sequence_blocks(run.parallel, mesh, run.shape.seq_len,
                             run.model.family)
    sp = bundle.kind != "decode" and blocks > 1
    for path, leaf, spec in params:
        model = _split(spec, mesh, ("model",))
        data = _split(spec, mesh, daxes)
        derived |= data > 1
        role = None
        if _ROW.search(path) and model > 1:
            role = "row"
        elif _EXPERT.search(path) and leaf.ndim >= 3 and _split(
                P(*spec[leaf.ndim - 3:leaf.ndim - 2]), mesh,
                daxes) > 1:  # the expert dim of (E, F, D), over the data
            role = "expert"
        elif _ROUTER.search(path):
            role = "router"
        counter.add_param(leaf, hlo_analysis.ParamInfo(path, model, data,
                                                       role))

    # the train step's layout cuts the traced stream as a rank's
    with traced_sequence(blocks if sp else 1):
        out = hlo_analysis.trace(rank.fn, rank.abstract_args, train=train,
                                 counter=counter)
    out_bytes = alias_bytes + counter.result_bytes(out)
    del out
    _step_collectives(counter, run, mesh, params, train, dsize, n_micro,
                      compute, stub)
    if msize > 1:
        _tp_collectives(counter, run, mesh, params, train, n_micro, compute,
                        rank.abstract_args, sp, stub)
    temp = counter.peak_live_bytes
    memory = MemoryAnalysis(arg_bytes, out_bytes, temp, alias_bytes,
                            arg_bytes + temp)
    return bundle, TracedStep(counter, memory,
                              "derived" if derived else "none")


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


def _step_collectives(counter, run: RunConfig, mesh: MeshSpec, params,
                      train: bool, dsize: int, n_micro: int,
                      compute: torch.dtype, stub: torch.dtype) -> None:
    """The step-level collectives of data parallelism and FSDP (the
    module docstring's rules), after the traced ones."""
    grads = params
    if train:  # the state's parameters, not its optimizer slots
        grads = [(p.removeprefix("params/"), leaf, spec)
                 for p, leaf, spec in params if p.startswith("params/")]
    itemsize = torch.empty((), dtype=compute).element_size()
    replicated = []
    daxes = data_axes_of(mesh.axis_names)
    for path, leaf, spec in grads:
        data = _split(spec, mesh, daxes)
        model = _split(spec, mesh, ("model",))
        if data == 1:
            replicated.append(leaf.numel() // model)
            continue
        if _EXPERTS.search(path) and leaf.ndim >= 3 and _split(
                P(spec[leaf.ndim - 3]), mesh, daxes) > 1:
            continue  # an expert block: its gradient is whole
        slices = leaf.shape[0] if "blocks/" in path else 1
        block = leaf.numel() // (model * data * slices)
        uses = (1 + (train and _regathered(path, run, compute, stub))
                ) * n_micro
        counter.add_collective("all-gather", block * itemsize,
                               f"fsdp {path}", slices * uses)
        if train:
            counter.add_collective("reduce-scatter", block * data * 4,
                                   f"fsdp gradient {path}",
                                   slices * n_micro)
    if train:
        _optimizer_collectives(counter, run, mesh, grads)
    if not train or dsize == 1:
        return
    cfg, tc = run.model, run.train
    sums = [_LOSS_SUMS + (tc.z_loss > 0.0), 1]
    if cfg.mtp_depth > 0:
        sums.append(_MTP_SUMS)
    for _ in range(n_micro):
        for start, end in bucket_ranges(replicated):
            counter.add_collective("all-reduce",
                                   4 * sum(replicated[start:end]),
                                   "dp gradient bucket")
        for n in sums:
            counter.add_collective("all-reduce", 4 * n, "dp loss sums")


def _regathered(path: str, run: RunConfig, compute: torch.dtype,
                stub: torch.dtype) -> bool:
    """Whether the backward all-gathers an FSDP weight again: it does
    where an op saved the gathered weight itself for its backward, not
    for the embedding lookup of an untied head (which saves the indices)
    and not for a router widened to fp32 from a narrower compute dtype
    (the product saves the widened copy), and not for the weights that
    read a stub frontend's input (``frame_proj``, the vlm family's cross
    K/V projections: the input takes no gradient, so the product saves
    the input only).  A ``stub`` input wider than ``compute`` widens every
    audio encoder weight and the decoder's cross K/V projections, which
    read the encoder's output (``mm``: the product saves the copy)."""
    if path == "embed/embedding" and not run.model.tie_embeddings:
        return False
    if path == "frame_proj" or (run.model.family == "vlm"
                                and re.search(r"cross/w[kv]$", path)):
        return False
    if torch.promote_types(stub, compute) != compute and (
            path.startswith("enc_blocks/")
            or re.search(r"dec_blocks/cross/w[kv]$", path)):
        return False
    return not (path.endswith("moe/router") and compute != torch.float32)


def _optimizer_collectives(counter, run: RunConfig, mesh: MeshSpec,
                           grads) -> None:
    """The statistics the optimizer sums over the blocks of split leaves
    (:mod:`repro_torch.train.optimizer`): the global norm's sum of squares,
    one fp32 all-reduce a group of axes that splits some leaf (the model
    axis, the data axes, both); under ``int8_ef`` each split leaf's
    maximum; under Adafactor each split leaf's factored means (``vr``
    over a split last dim, ``vc`` and ``vr``'s mean over a split
    second-to-last) and its update's mean square."""
    daxes = data_axes_of(mesh.axis_names)
    groups = set()
    for path, leaf, spec in grads:
        spec = P(*(tuple(spec) + (None,) * (leaf.ndim - len(spec))))
        model = _split(spec, mesh, ("model",)) > 1
        data = _split(spec, mesh, daxes) > 1
        if not (model or data):
            continue
        groups.add((model, data))
        if run.parallel.grad_compression == "int8_ef":
            counter.add_collective("all-reduce", 4, f"int8 scale {path}")
        if run.train.optimizer != "adafactor":
            continue
        local = list(_block(leaf, spec, mesh).shape)
        numel = math.prod(local)
        if leaf.ndim >= 2:
            last = _split(P(spec[-1]), mesh, mesh.axis_names) > 1
            second = _split(P(spec[-2]), mesh, mesh.axis_names) > 1
            if last:
                counter.add_collective("all-reduce", 4 * numel // local[-1],
                                       f"adafactor vr {path}")
            if second:
                counter.add_collective("all-reduce", 4 * numel // local[-2],
                                       f"adafactor vc {path}")
                counter.add_collective(
                    "all-reduce", 4 * numel // (local[-1] * local[-2]),
                    f"adafactor vr mean {path}")
        counter.add_collective("all-reduce", 4, f"adafactor rms {path}")
    for _ in groups:
        counter.add_collective("all-reduce", 4, "global norm")


def _mdim(specs: Dict[str, Any], path: str, scanned: bool):
    """The dim of ``path``'s layer view the model axis splits, or None."""
    spec = specs.get(path)
    if spec is None:
        return None
    parts = list(spec)[1:] if scanned else list(spec)
    for d, entry in enumerate(parts):
        if entry is not None and "model" in (
                (entry,) if isinstance(entry, str) else entry):
            return d
    return None


def _tp_collectives(counter, run: RunConfig, mesh: MeshSpec, params,
                    train: bool, n_micro: int, compute: torch.dtype,
                    args, sp: bool, stub: torch.dtype) -> None:
    """What the model axis adds, as the port's sharded forward executes it
    (:mod:`repro_torch.sharding.layout`): where a sublayer takes its input
    from the stream (``enter``: the input-gradient all-reduce of a tensor
    every model rank holds entering split heads, channels or experts;
    under ``sp`` the all-gather of the block and, for such an input, the
    reduce-scatter of its gradient) and gives its output back (``leave``:
    a row-parallel product's partial sums all-reduced, or under ``sp``
    reduce-scattered; the backward all-gathers the block), the head
    gathers of a split that cuts through heads, MLA's latents, the vocab
    split's embedding and logits, ``frame_proj`` / ``mtp/proj``,
    Mamba-1's ``w_bcdt`` sums and Mamba-2's inner sums, the MoE combine,
    the audio encoder's output entering the cross K/V, and under ``sp``
    the stream leaves' gradient sums.  ``rows``: the tokens of one data
    rank's microbatch (the decoder's; ``enc_rows`` the audio encoder's
    frames).  Each collective is in the dtype its tensor has: the compute
    dtype, but the audio encoder's and its output's in the stub input's
    dtype where that is wider (``mm`` promotes), and a cross K/V's in the
    source's."""
    from repro_torch.models.attention import split_heads
    from repro_torch.models.ssm import _dt_rank
    from repro_torch.models.transformer import block_pattern, num_superblocks

    cfg = run.model
    specs = {p.removeprefix("params/"): spec for p, _, spec in params}
    tokens = (args[1]["inputs"] if train else args[-1] if isinstance(
        args[-1], torch.Tensor) else args[1]["tokens"])
    rows = tokens.shape[0] * tokens.shape[1] // n_micro
    c = torch.empty((), dtype=compute).element_size()
    cw = torch.empty((), dtype=torch.promote_types(stub, compute)
                     ).element_size()
    d = cfg.d_model
    tp = mesh.shape["model"]
    out: list = []  # (kind, bytes, what, backward) once a microbatch
    seq = sp  # the stream in sequence blocks (not in the MTP head)

    def add(kind, nbytes, what, backward=False):
        out.append((kind, nbytes, what, backward))

    def enter(n, partial, what, size=c):
        """A sublayer's input of ``n`` rows from the stream."""
        if seq:
            add("all-gather", n * d * size // tp, f"sp gather {what}")
            if partial:
                add("reduce-scatter", n * d * size, f"sp gather {what}",
                    True)
        elif partial:
            add("all-reduce", n * d * size,
                f"tp partial sum {what} (input)", True)

    def leave(n, partial, what, size=c):
        """A sublayer's output for the stream: ``partial`` sums, or
        whole."""
        if seq:
            if partial:
                add("reduce-scatter", n * d * size, f"sp scatter {what}")
            add("all-gather", n * d * size // tp, f"sp leave {what}", True)
        elif partial:
            add("all-reduce", n * d * size, f"tp partial sum {what}")

    def dense_mlp(prefix, scanned, n=rows, size=c):
        split = _mdim(specs, f"{prefix}w_up", scanned) == 1
        enter(n, split, f"{prefix}w_up", size)
        leave(n, split, f"{prefix}w_down", size)

    def gathered(elems, size, what):
        """A product whose columns cut through heads: all-gathered, the
        gradient reduce-scattered."""
        add("all-gather", elems // tp * size, f"tp heads {what}")
        add("reduce-scatter", elems * size, f"tp heads {what}", True)

    def heads(prefix, scanned, n=rows, size=c, src=None):
        """An attention sublayer; ``src``: (rows, bytes an element) of
        the K/V source (its own input when None)."""
        split = _mdim(specs, f"{prefix}wq", scanned) == 1
        enter(n, split, f"{prefix}wq", size)
        if split:
            hd, hq, hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
            plan = split_heads(hq, hkv, hd, tp, 0, _mdim(
                specs, f"{prefix}wk", scanned) == 1)
            kv_rows, kv_size = src or (n, size)
            if plan.gather_q:
                gathered(n * hq * hd, size, f"{prefix}q")
            if plan.gather_kv:
                for name in ("k", "v"):
                    gathered(kv_rows * hkv * hd, kv_size,
                             f"{prefix}{name}")
        leave(n, split, f"{prefix}wo", size)

    def mla(prefix, scanned):
        split = _mdim(specs, f"{prefix}w_uq", scanned) == 1
        enter(rows, False, f"{prefix}w_dq")
        if split:
            for width, name in ((cfg.q_lora_rank, "c_q"),
                                (cfg.kv_lora_rank, "c_kv"),
                                (cfg.qk_rope_head_dim, "k_pe")):
                add("all-reduce", rows * width * c,
                    f"tp latent {prefix}{name}", True)
        leave(rows, split, f"{prefix}wo")

    def moe(prefix, scanned):
        k = cfg.moe_top_k
        model_experts = _mdim(specs, f"{prefix}w_gate", scanned) == 0
        shared = cfg.moe_num_shared > 0
        shared_split = shared and _mdim(
            specs, f"{prefix}shared/w_up", scanned) == 1
        enter(rows, False, f"{prefix}router")
        if model_experts or shared_split:
            add("all-reduce", rows * d * c, f"tp moe tokens {prefix}", True)
        if model_experts:
            add("all-reduce", rows * k * 4, f"tp moe gates {prefix}", True)
        if _mdim(specs, f"{prefix}w_gate", scanned) == 2:
            from repro_torch.models import moe as moe_mod

            tg = moe_mod._group_size(rows, run.parallel.moe_group_size)
            cap = moe_mod.capacity(cfg, tg,
                                   dropless=run.shape.kind == "decode")
            nbytes = (rows // tg) * cfg.moe_num_experts * cap * d * c
            add("all-reduce", nbytes, f"tp expert ffn {prefix}")
            add("all-reduce", nbytes, f"tp expert ffn {prefix}", True)
        leave(rows, model_experts, f"{prefix}combine")
        if shared and shared_split != model_experts:  # two sums
            leave(rows, shared_split, f"{prefix}shared")

    def attention_block(prefix, scanned, kind):
        if cfg.attn_type == "mla":
            mla(f"{prefix}attn/", scanned)
        else:
            heads(f"{prefix}attn/", scanned)
        if kind == "cross":
            heads(f"{prefix}cross/", scanned, src=(
                rows // tokens.shape[1] * cfg.vision_seq, cw))
        if kind == "moe":
            moe(f"{prefix}moe/", scanned)
        else:
            dense_mlp(f"{prefix}mlp/", scanned)

    def mamba1(prefix, scanned):
        split = _mdim(specs, f"{prefix}w_x", scanned) == 1
        enter(rows, split, f"{prefix}w_x")
        if split:
            nbytes = rows * (_dt_rank(cfg) + 2 * cfg.ssm_state) * c
            add("all-reduce", nbytes, f"tp partial sum {prefix}w_bcdt")
            add("all-reduce", nbytes,
                f"tp partial sum {prefix}w_bcdt (backward)", True)
        leave(rows, split, f"{prefix}w_out")

    def mamba2(prefix, scanned):
        split = _mdim(specs, f"{prefix}w_x", scanned) == 1
        enter(rows, False, f"{prefix}w_B")
        if split:
            h = cfg.ssm_num_heads
            add("all-reduce", rows * d * c,
                f"tp partial sum {prefix}w_out (input)", True)
            add("all-reduce", rows * h * c, f"tp mamba2 dt {prefix}", True)
            add("all-reduce", h * c, f"tp mamba2 A {prefix}", True)
            add("all-reduce", rows * 2 * cfg.ssm_state * c,
                f"tp mamba2 B/C {prefix}", True)
            add("all-reduce", rows * 4, f"tp mamba2 norm {prefix}")
            add("all-reduce", rows * 4, f"tp mamba2 norm {prefix}", True)
        leave(rows, split, f"{prefix}w_out")

    embed_split = _mdim(specs, "embed/embedding", False) == 0
    head_split = (_mdim(specs, "embed/lm_head", False) == 1
                  if "embed/lm_head" in specs else embed_split)

    def embedding(on_stream=True):
        if on_stream and seq:
            leave(rows, embed_split, "embed/embedding")
        elif embed_split:
            add("all-reduce", rows * d * c, "tp vocab embedding")

    def head(on_stream=True):
        if not train:
            return
        if on_stream and seq:
            enter(rows, head_split, "embed head")
        elif head_split:
            add("all-reduce", rows * d * c, "tp vocab head (input)", True)
        if head_split:
            add("all-gather", rows * cfg.vocab_size // tp * c,
                "tp vocab logits")

    if cfg.family == "audio":
        enc_rows = rows // tokens.shape[1] * cfg.encoder_seq
        if run.shape.kind != "decode":  # decode reads the kept enc_out
            if _mdim(specs, "frame_proj", False) == 1:
                add("all-gather", enc_rows * d // tp * cw, "tp frame_proj")
            for _ in range(cfg.encoder_layers or cfg.num_layers):
                heads("enc_blocks/attn/", True, enc_rows, cw)
                dense_mlp("enc_blocks/mlp/", True, enc_rows, cw)
        embedding()
        if _mdim(specs, "dec_blocks/cross/wk", True) == 1:
            add("all-reduce", enc_rows * d * cw, "tp enter enc_out", True)
        for _ in range(cfg.num_layers):
            heads("dec_blocks/attn/", True)
            heads("dec_blocks/cross/", True, src=(enc_rows, cw))
            dense_mlp("dec_blocks/mlp/", True)
        head()
    else:
        embedding()
        pat = block_pattern(cfg)
        for _ in range(num_superblocks(cfg)):
            for i, kind in enumerate(pat):
                prefix = f"blocks/sub{i}/"
                if kind == "mamba1":
                    mamba1(f"{prefix}mixer/", True)
                elif kind in ("mamba2", "mamba2_shared_attn"):
                    mamba2(f"{prefix}mixer/", True)
                    if kind == "mamba2_shared_attn":
                        heads("shared_attn/attn/", False)
                        dense_mlp("shared_attn/mlp/", False)
                else:
                    attention_block(prefix, True, kind)
        head()
        if cfg.mtp_depth > 0 and train:
            # the MTP head runs on the whole sequence, gathered first
            if seq:
                add("all-gather", rows * d * c // tp, "sp gather mtp")
            seq = False
            embedding(False)
            if _mdim(specs, "mtp/proj", False) == 1:
                add("all-reduce", rows * 2 * d * c, "tp mtp proj (input)",
                    True)
                add("all-gather", rows * d // tp * c, "tp mtp proj")
            attention_block("mtp/block/",
                            False, "moe" if cfg.is_moe else "dense")
            head(False)
    if sp and train:
        sizes = [leaf.numel() for p, leaf, _ in params
                 if p.startswith("params/")
                 and Layout.on_stream(p.removeprefix("params/"))]
        for start, end in bucket_ranges(sizes):
            add("all-reduce", 4 * sum(sizes[start:end]),
                "sp stream leaves' gradients", True)
    for kind, nbytes, what, backward in out:
        if train or not backward:
            counter.add_collective(kind, nbytes, what, n_micro)
