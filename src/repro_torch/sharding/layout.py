"""Sharded execution of a train step: each rank holds its block of every
parameter under the placement rules, and the forward reads each weight's
:class:`~repro_torch.sharding.specs.PartitionSpec` to choose its
collective.

A :class:`Layout` binds the rules' specs of a parameter tree to an
executing mesh (:class:`~repro_torch.launch.mesh.MeshSpec` with process
groups).  The model code takes a :class:`Scope` — a layout at a path of
the tree — and asks it, per weight, which dim the model axis splits
(:meth:`Scope.model_dim`); a weight the rules leave whole runs whole.
The collectives are :mod:`repro_torch.sharding.collectives`' autograd
operators on local tensors, so the CUDA kernels see plain tensors at
their local shapes.

FSDP (a weight split over the data axes, ``par.fsdp > 1``): the forward
all-gathers the block in the compute dtype before use — a layer slice of
the stacked ``blocks/`` leaves at a time, the other leaves once a
forward — and the backward reduce-scatters the fp32 gradient
(:func:`~repro_torch.sharding.collectives.gather`).  The whole weight is
not kept for the backward: :meth:`Layout.saved_tensors` replaces each
saved reference to it by its block and all-gathers it again when the
backward first needs it, dropping it after the last use.  The expert dim
of a MoE weight split over the data axes is expert parallelism, not FSDP:
that block is used as it is (:func:`repro_torch.models.moe.apply_moe`).

Sequence parallelism (``par.sp``, :func:`~repro_torch.sharding.specs.
sequence_blocks`): between sublayers each model rank holds its block
``(B, S/m, D)`` of the residual stream, and the norms run on it.  A
sublayer's input is all-gathered along the sequence
(:meth:`Scope.gather_in`) and its output leaves for the block
(:meth:`Scope.leave_out`): a row-parallel product's partial sums by a
reduce-scatter, a whole output by the rank's slice (each with an
all-gather backward).  The gather's backward reduce-scatters where the
gathered tensor's gradient is a partial sum over the model ranks (it
feeds column-split products directly), and takes the rank's slice where
it is complete on every rank (it feeds only replicated weights whose
results enter the split, or a sublayer that keeps its own ``enter``).
The leaves applied to the stream itself (the norm scales, the vlm gate:
:meth:`Layout.on_stream`) get from each rank the share of its block, so
the train step sums their gradients over the model axis.  The audio
family is not cut: the reference constrains none of its activations.

Serving (:func:`repro_torch.train.serve_step.make_prefill_step` /
``make_decode_step`` with a mesh) runs the same forward under no
gradient: the FSDP blocks are gathered before use, and the decode state
holds the rank's heads or channels
(:func:`repro_torch.models.transformer.init_decode_state`).  On a traced
mesh (:meth:`repro_torch.launch.mesh.MeshSpec.traced`) every collective
only records itself, so a dry run executes this module's program as a
rank does, on ``meta`` tensors.
"""

from __future__ import annotations

import contextlib
import re
import weakref
from typing import Dict, Optional, Tuple

import torch

from repro_torch.sharding import collectives as C
from repro_torch.sharding.specs import (PartitionSpec, data_axes_of,
                                        param_specs, sequence_blocks)
from repro_torch.utils.config import ParallelConfig
from repro_torch.utils.trees import flatten_with_paths, tree_map_with_path

_EXPERT = re.compile(r"moe/w_(gate|up|down)$")
#: leaves applied to the residual stream itself (the MTP head, which runs
#: on the whole sequence, aside)
_ON_STREAM = re.compile(r"(^|/)(attn_norm|mlp_norm|cross_norm|norm|"
                        r"final_norm)/scale$|cross_gate$")



def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _spans(axis: Optional[C.Axis]) -> Optional[C.Axis]:
    return axis if axis is not None and axis.size > 1 else None


def _key(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage (a ``meta`` tensor has no address
    of its own)."""
    return id(t.untyped_storage())


class _Held:
    """A gathered weight whose saved references the backward regathers."""

    __slots__ = ("ref", "block", "axis", "dim", "pending", "whole")

    def __init__(self, whole, block, axis, dim):
        self.ref = weakref.ref(whole)
        self.block, self.axis, self.dim = block, axis, dim
        self.pending, self.whole = 0, None

    def unpack(self, size, stride, offset):
        if self.whole is None:
            self.whole = C._all_gather(self.block, self.axis, self.dim)
        self.pending -= 1
        out = self.whole.as_strided(size, stride, offset)
        if self.pending == 0:
            self.whole = None
        return out


class Layout:
    """The specs of a parameter tree on an executing mesh.

    ``specs``: path -> spec of every parameter leaf (the whole tree's,
    scan dim included); ``mesh``: the mesh, whose ``axis("data")`` /
    ``axis("model")`` groups the collectives run over; ``parallel``: the
    run's knobs (``sp`` read here); ``family``: the model's."""

    def __init__(self, specs: Dict[str, PartitionSpec], mesh,
                 shapes: Optional[Dict[str, Tuple[int, ...]]] = None,
                 parallel: Optional[ParallelConfig] = None,
                 family: str = "dense"):
        self.specs = specs
        self.shapes = shapes or {}
        self.mesh = mesh
        self.parallel = parallel or ParallelConfig()
        self.family = family
        self.daxes = data_axes_of(mesh.axis_names)
        #: the groups of the data axes and of the model axis; None where
        #: the axes' size is 1 (no collective, no packing for one)
        self.data = _spans(mesh.axis("data"))
        self.model = _spans(mesh.axis("model"))
        self.tp = self.model.size if self.model is not None else 1
        self._held: Dict[int, list] = {}

    @classmethod
    def of(cls, params, run, mesh) -> "Layout":
        """The layout of ``params`` (a tree of tensors of the whole
        shapes, ``meta`` ones included) under ``run``'s rules."""
        cfg, par = run.model, run.parallel
        specs = flatten_with_paths(param_specs(params, cfg, par, mesh))
        shapes = {k: tuple(v.shape)
                  for k, v in flatten_with_paths(params).items()}
        return cls(specs, mesh, shapes, par, cfg.family)

    # -- the sequence split --------------------------------------------------

    def seq_axis(self, seq_len: int) -> Optional[C.Axis]:
        """The model axis when a forward over ``seq_len`` tokens holds the
        residual stream in sequence blocks, else None."""
        if sequence_blocks(self.parallel, self.mesh, seq_len,
                           self.family) == 1:
            return None
        return self.model

    @staticmethod
    def on_stream(path: str) -> bool:
        """Whether leaf ``path`` is applied to the residual stream itself
        (a norm scale, the vlm gate): under the sequence split its
        gradient on each model rank is its block's share."""
        return bool(_ON_STREAM.search(path)) and not path.startswith("mtp/")

    # -- what a leaf's spec says ---------------------------------------------

    def axis_of(self, entry) -> Optional[C.Axis]:
        """The group over the axes of a spec entry (the data axes, or
        "model"); None for a whole dim."""
        axes = _axes(entry)
        if not axes:
            return None
        if axes == ("model",):
            return self.model
        if axes == self.daxes:
            return self.data
        raise ValueError(f"no process group over {axes} on the mesh "
                         f"{self.mesh.axis_names}")

    def fsdp_dim(self, path: str) -> Optional[int]:
        """The dim of leaf ``path`` that FSDP splits over the data axes (the
        expert dim of a MoE weight is expert parallelism, not FSDP)."""
        spec = self.specs[path]
        for d, entry in enumerate(spec):
            if set(_axes(entry)) & set(self.daxes):
                if _EXPERT.search(path) and d == len(spec) - 3:
                    return None
                return d
        return None

    def split_axes(self, path: str) -> Optional[C.Axis]:
        """The group over every axis that splits leaf ``path`` (None for a
        replicated leaf): a statistic over the whole leaf sums its blocks
        over it, once each."""
        used = {a for entry in self.specs[path] for a in _axes(entry)}
        data = bool(used & set(self.daxes))
        model = "model" in used and self.tp > 1
        if data and model:
            return self.mesh.axis("world")
        if data:
            return self.data
        return self.model if model else None

    def dim_axis(self, path: str, dim: int) -> Optional[C.Axis]:
        """The group over the axes that split ``dim`` of leaf ``path``."""
        axis = self.axis_of(self.specs[path][dim])
        return axis if axis is not None and axis.size > 1 else None

    def whole_numel(self, path: str) -> int:
        n = 1
        for d in self.shapes[path]:
            n *= d
        return n

    def data_replicated(self, path: str) -> bool:
        """Whether the data axes hold leaf ``path`` whole (its gradient is
        then all-reduced over them)."""
        return not any(set(_axes(e)) & set(self.daxes)
                       for e in self.specs[path])

    # -- FSDP ----------------------------------------------------------------

    def gather(self, tree, prefix: str):
        """``tree`` (the leaves at ``prefix``; a layer slice of stacked
        leaves when ``prefix`` starts with ``blocks/``) with every FSDP
        block all-gathered over the data axes: the whole weight in the
        forward, the block's gradient reduce-scattered in the backward."""
        scanned = prefix.startswith("blocks/")

        def one(path, leaf):
            full = f"{prefix}{path}" if path else prefix.rstrip("/")
            d = self.fsdp_dim(full)
            if d is None or self.data is None or self.data.size == 1:
                return leaf
            d -= int(scanned)
            whole = C.gather(leaf, self.data, d)
            held = _Held(whole, leaf.detach(), self.data, d)
            self._held.setdefault(_key(whole), []).append(held)
            return whole

        return tree_map_with_path(one, tree)

    @property
    def fsdp(self) -> bool:
        """Whether some leaf is gathered over the data axes in the step."""
        return (self.data is not None and self.data.size > 1 and
                any(self.fsdp_dim(p) is not None for p in self.specs))

    def saved_tensors(self):
        """The hooks around a forward whose FSDP weights the backward
        all-gathers again (``torch.autograd.graph.saved_tensors_hooks``);
        no hooks without FSDP."""
        if not self.fsdp:
            return contextlib.nullcontext()
        def pack(t):
            for held in self._held.get(_key(t), ()):
                if held.ref() is not None:
                    held.pending += 1
                    return (held, t.size(), t.stride(), t.storage_offset())
            # a backward reads saved values only; the tensor itself would
            # tie a node that saves its own output to that output (a cycle
            # through the graph the collector cannot see)
            return t.detach()

        def unpack(x):
            if isinstance(x, tuple):
                return x[0].unpack(*x[1:])
            return x

        return torch.autograd.graph.saved_tensors_hooks(pack, unpack)

    def release(self) -> None:
        """Forget the forward's gathered weights (the backward's holds
        what it needs)."""
        self._held.clear()

    # -- whole leaves ----------------------------------------------------------

    def gather_whole(self, leaf: torch.Tensor, spec: PartitionSpec
                     ) -> torch.Tensor:
        """The whole leaf from this rank's block under ``spec`` (no
        gradient): all-gathered along each split dim."""
        out = leaf.detach()
        for d, entry in enumerate(spec):
            axis = self.axis_of(entry)
            if axis is not None and axis.size > 1:
                out = C._all_gather(out, axis, d)
        return out


class Scope:
    """A :class:`Layout` at a path of the parameter tree (``prefix``),
    which the model code asks about its weights; ``Scope(None)`` is the
    unsharded model (every weight whole, every collective the identity).
    ``scanned``: the weights are a layer slice of stacked leaves.
    ``seq``: the model axis when the residual stream is in sequence
    blocks (:meth:`Layout.seq_axis`), else None."""

    __slots__ = ("layout", "prefix", "scanned", "seq")

    def __init__(self, layout: Optional[Layout], prefix: str = "",
                 scanned: bool = False, seq: Optional[C.Axis] = None):
        self.layout, self.prefix, self.scanned = layout, prefix, scanned
        self.seq = seq

    @classmethod
    def top(cls, layout: Optional[Layout], seq_len: int) -> "Scope":
        """The root scope of a forward over ``seq_len`` tokens."""
        return cls(layout, seq=None if layout is None
                   else layout.seq_axis(seq_len))

    def __getitem__(self, key: str) -> "Scope":
        return Scope(self.layout, f"{self.prefix}{key}/", self.scanned,
                     self.seq)

    @property
    def model(self) -> Optional[C.Axis]:
        return None if self.layout is None else self.layout.model

    @property
    def data(self) -> Optional[C.Axis]:
        return None if self.layout is None else self.layout.data

    def spec(self, name: str) -> Tuple:
        """The layer-view spec of weight ``name`` (the scan dim dropped)."""
        spec = tuple(self.layout.specs[f"{self.prefix}{name}"])
        return spec[1:] if self.scanned else spec

    def model_dim(self, name: str) -> Optional[int]:
        """The dim of weight ``name`` the model axis splits (None: whole,
        or no model axis)."""
        if self.layout is None or self.layout.tp == 1:
            return None
        for d, entry in enumerate(self.spec(name)):
            if "model" in _axes(entry):
                return d
        return None

    def data_dim(self, name: str) -> Optional[int]:
        """The dim of weight ``name`` the data axes split in the step (the
        expert dim under expert parallelism; FSDP blocks are gathered
        before the model code sees them)."""
        if self.layout is None or self.data is None or self.data.size == 1:
            return None
        for d, entry in enumerate(self.spec(name)):
            if set(_axes(entry)) & set(self.layout.daxes):
                return d
        return None

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return C.enter(x, self.model)

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        return C.leave(x, self.model)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return C.all_reduce(x, self.model)

    def gather_in(self, x: torch.Tensor, partial: bool = True
                  ) -> torch.Tensor:
        """A sublayer's input from the stream: under the sequence split
        the whole sequence, all-gathered along dim 1 (the backward
        reduce-scatters a ``partial`` gradient, else takes this rank's
        block); without it ``x``, through :meth:`enter` when ``partial``
        (it feeds column-split products)."""
        if self.seq is not None:
            return C.gather(x, self.seq, 1,
                            "reduce-scatter" if partial else "slice",
                            grad_dtype=None)
        return self.enter(x) if partial else x

    def leave_out(self, y: torch.Tensor, partial: bool = True
                  ) -> torch.Tensor:
        """A sublayer's output for the stream: ``partial`` sums of a
        row-split product reduce-scattered to this rank's sequence block
        under the sequence split (all-reduced without it); a whole output
        sliced to the block (itself without the split)."""
        if self.seq is not None:
            return (C.scatter(y, self.seq, 1) if partial
                    else C.shard(y, self.seq, 1))
        return self.leave(y) if partial else y

    def local(self, x: torch.Tensor, dim: int, parts: int) -> torch.Tensor:
        """This model rank's block of a whole tensor along ``dim`` when a
        weight's split cuts ``parts`` (heads, experts, channels) into the
        model axis' blocks; ``x`` itself without a model split."""
        axis = self.model
        if axis is None or axis.size == 1:
            return x
        if parts % axis.size:
            raise ValueError(f"{parts} along dim {dim} of "
                             f"{tuple(x.shape)} do not split over "
                             f"{axis.size} model ranks")
        block = x.shape[dim] // axis.size
        return x.narrow(dim, axis.rank * block, block)


#: the unsharded model
LOCAL = Scope(None)


def shard_params(params, run, mesh, rank: int):
    """The blocks rank ``rank`` holds of ``params`` (the reference's, or
    one process's, whole parameters) under ``run``'s rules on ``mesh``:
    contiguous copies on the leaves' device."""
    from repro_torch.launch.mesh import coords_of, local_shard

    coords = coords_of(rank, mesh)
    specs = param_specs(params, run.model, run.parallel, mesh)
    return tree_map_with_path(
        lambda path, leaf: local_shard(
            leaf, specs_at(specs, path), mesh, coords).contiguous().clone(),
        params)


def specs_at(specs, path: str):
    node = specs
    for key in path.split("/"):
        node = node[key]
    return node
