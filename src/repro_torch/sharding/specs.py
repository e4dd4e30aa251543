"""Placement rules — the port of :mod:`repro.sharding.specs`: how every
parameter, activation, cache and optimizer slot is split over a device
mesh.

The rules are pure functions over a mesh's axis names and sizes (any
object with ``axis_names`` and a ``shape`` mapping: the device-free
:class:`~repro_torch.launch.mesh.MeshSpec`, or the mesh
:func:`~repro_torch.launch.mesh.make_mesh` builds) and over tensor shapes
(``meta`` tensors allocate nothing).  They return :class:`PartitionSpec`,
the port's counterpart of jax's: one entry per tensor dim, ``None``
(replicated), a mesh axis name, or a tuple of names split in row-major
order.  :func:`to_placements` turns a spec into DTensor placements, one
per mesh dim.

Conventions, as in the reference:

- data-like axes: ("pod", "data") when present — batch / FSDP /
  EP(optional);
- "model" axis — tensor parallelism (heads, d_ff, vocab, d_inner);
- parameters carry a leading super-block dim when scanned -> specs get a
  leading None;
- FSDP (``par.fsdp > 1``) shards the *non-TP* matrix dimension of each
  weight over the data-like axes (ZeRO-3 style); optimizer state inherits
  the same spec.

Rules are keyed on parameter path suffixes; anything unmatched is
replicated.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Iterator, List, Mapping, Sequence, Tuple, \
    Union

from repro_torch.utils.config import ModelConfig, ParallelConfig
from repro_torch.utils.trees import flatten_with_paths, tree_map_with_path

Entry = Union[None, str, Tuple[str, ...]]


class PartitionSpec:
    """A tensor's split over mesh axes, one entry per dim (jax's
    ``PartitionSpec``; as there, a one-axis tuple is stored as its axis).
    Not a tuple, so the tree helpers take a spec as one leaf; iterating
    gives the entries."""

    __slots__ = ("parts",)

    def __init__(self, *parts: Entry):
        self.parts = tuple(p[0] if isinstance(p, tuple) and len(p) == 1
                           else p for p in parts)

    def __iter__(self) -> Iterator[Entry]:
        return iter(self.parts)

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other) -> bool:
        return (isinstance(other, PartitionSpec)
                and self.parts == other.parts)

    def __hash__(self) -> int:
        return hash(self.parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.parts!r}"


P = PartitionSpec


def _axes(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _mesh_sizes(mesh) -> Tuple[Tuple[str, ...], Dict[str, int]]:
    return tuple(mesh.axis_names), dict(mesh.shape)


def data_axes_of(mesh_axes: Tuple[str, ...]) -> Tuple[str, ...]:
    return tuple(a for a in mesh_axes if a in ("pod", "data"))


def sequence_blocks(par: ParallelConfig, mesh, seq_len: int,
                    family: str = "dense") -> int:
    """The reference's sequence rule (``activation_sharding``'s
    ``seq_spec``): the number of blocks the (B, S, D) residual stream of a
    forward over ``seq_len`` tokens is cut into along the sequence — the
    model axis' size under ``par.sp`` when the mesh has data axes and a
    "model" axis above 1 that divides ``seq_len``, else 1 (the stream
    whole; decode's one token, for one).  The audio ``family`` is never
    cut: the reference constrains none of its activations."""
    axes, sizes = _mesh_sizes(mesh)
    m = sizes.get("model", 1)
    if (par.sp and family != "audio" and data_axes_of(axes) and m > 1
            and seq_len % m == 0):
        return m
    return 1


def activation_sharding(h, par: ParallelConfig, mesh, seq_len=None,
                        blocks=None):
    """The reference's constraint on (B, S, D) activations, on the mesh
    the forward executes on: batch over the data axes, sequence over
    "model" under ``par.sp`` (:func:`sequence_blocks`).  The port executes
    the constraint instead of asking for it: every rank of a data
    coordinate holds its rows, whole over the model axis or, under the
    sequence rule, its block ``(B, S/m, D)`` of the ``seq_len`` tokens
    (the embedding's reduce-scatter cuts it,
    :func:`repro_torch.models.layers.embed_tokens`).  So ``h`` is checked
    against that layout and returned as it is; ``seq_len`` is the whole
    sequence (``h.shape[1]`` when omitted: ``h`` whole), ``blocks`` the
    blocks the caller's layout cuts it into (the rule's when omitted; a
    dry run's traced rank cuts it without a model axis).  A stream of
    another length raises ``ValueError``, an axis above 1 that is not
    "pod", "data" or "model" ``NotImplementedError``: no rule of the
    reference's cuts over it."""
    axes, sizes = _mesh_sizes(mesh)
    other = {a: sizes[a] for a in axes
             if a not in ("pod", "data", "model") and sizes[a] > 1}
    if other:
        raise NotImplementedError(
            f"activation sharding over {other}: the rules place the "
            f"stream over 'pod', 'data' and 'model' only")
    seq_len = h.shape[1] if seq_len is None else seq_len
    if blocks is None:
        blocks = sequence_blocks(par, mesh, seq_len)
    want = seq_len // blocks
    if h.ndim < 3 or h.shape[1] != want:
        raise ValueError(f"a stream of {tuple(h.shape)} where the rule "
                         f"holds {want} of {seq_len} tokens a rank")
    return h


# --------------------------------------------------------------------------
# parameter rules
# --------------------------------------------------------------------------

# (regex on path, spec builder(fsdp_axes) -> tuple of axis assignments for
#  the *trailing* dims of the weight; leading scan dim handled separately)
def _rules(par: ParallelConfig):
    F = "__FSDP__"  # placeholder replaced by fsdp axes (or None)
    M = "model" if par.tp > 1 else None
    E = "model" if par.moe_expert_axis == "model" else "__EP__"
    return [
        # embeddings / head
        (r"embed/embedding$", (M, F)),
        (r"embed/lm_head$", (F, M)),
        (r"frame_proj$", (F, M)),
        # attention (gqa & cross)
        (r"attn/wq$|cross/wq$", (F, M)),
        (r"attn/wk$|cross/wk$", (F, M)),
        (r"attn/wv$|cross/wv$", (F, M)),
        (r"attn/wo$|cross/wo$", (M, F)),
        # MLA
        (r"attn/w_dq$", (F, None)),
        (r"attn/w_uq$", (None, M)),
        (r"attn/w_dkv$", (F, None)),
        (r"attn/w_uk$", (None, M)),
        (r"attn/w_uv$", (None, M)),
        # dense mlp
        (r"mlp/w_gate$|mlp/w_up$|shared/w_gate$|shared/w_up$", (F, M)),
        (r"mlp/w_down$|shared/w_down$", (M, F)),
        # MoE experts (leading expert dim)
        (r"moe/router$", (F, None)),
        (r"moe/w_gate$|moe/w_up$", (E, F, M if E != "model" else None)),
        (r"moe/w_down$", (E, M if E != "model" else None, F)),
        # mamba1
        (r"mixer/w_x$|mixer/w_z$", (F, M)),
        (r"mixer/conv_w$|mixer/conv_x_w$", (None, M)),
        (r"mixer/conv_b$|mixer/conv_x_b$", (M,)),
        (r"mixer/w_bcdt$", (M, None)),
        (r"mixer/w_dt$", (None, M)),
        (r"mixer/dt_bias$", (M,)),
        (r"mixer/A_log$", (M, None)),
        (r"mixer/D$", (M,)),
        (r"mixer/w_out$", (M, F)),
        # mamba2 extras
        (r"mixer/w_B$|mixer/w_C$|mixer/w_dtp$", (F, None)),
        (r"mixer/conv_bc_w$|mixer/conv_bc_b$", None),  # tiny, replicate
        (r"mixer/norm_scale$", (M,)),
        # mtp
        (r"mtp/proj$", (F, M)),
        # norms: replicate
        (r"norm", None),
        (r"scale$", None),
        (r"cross_gate$", None),
    ]


def _spec_for(path: str, shape: Tuple[int, ...], cfg: ModelConfig,
              par: ParallelConfig, mesh_axes: Tuple[str, ...],
              mesh_shape: Mapping[str, int]) -> PartitionSpec:
    daxes = data_axes_of(mesh_axes)
    fsdp_axes: Any = daxes if (par.fsdp > 1 and daxes) else None
    scanned = "blocks/" in path

    dims = len(shape)
    body_dims = dims - 1 if scanned else dims
    assign: Any = None
    for pat, spec in _rules(par):
        if re.search(pat, path):
            assign = spec
            break

    out: List[Entry] = [None] * dims
    if assign is not None:
        # tail-align the assignment onto the body dims
        assign = list(assign)[-body_dims:] if body_dims else []
        offset = dims - len(assign)
        for i, a in enumerate(assign):
            if a == "__FSDP__":
                a = fsdp_axes
            elif a == "__EP__":
                a = daxes if daxes else None
            if a is None:
                continue
            size = math.prod(mesh_shape.get(x, 1) for x in _axes(a))
            if size > 1 and shape[offset + i] % size == 0:
                out[offset + i] = a
    # drop duplicate axis uses (an axis may appear only once in a spec)
    seen = set()
    for i, a in enumerate(out):
        axes = _axes(a)
        if any(x in seen for x in axes):
            out[i] = None
        else:
            seen.update(axes)
    return P(*out)


def param_specs(params_shapes, cfg: ModelConfig, par: ParallelConfig,
                mesh) -> Any:
    """Tree of :class:`PartitionSpec` matching a params tree (of ``meta``
    tensors, or anything with a ``shape``)."""
    mesh_axes, mesh_shape = _mesh_sizes(mesh)
    return tree_map_with_path(
        lambda path, leaf: _spec_for(path, tuple(leaf.shape), cfg, par,
                                     mesh_axes, mesh_shape), params_shapes)


def cache_specs(state_shapes, cfg: ModelConfig, par: ParallelConfig,
                mesh) -> Any:
    """Decode-state sharding: batch over data axes (when divisible),
    kv-heads / latent dims over model axis where aligned."""
    mesh_axes, mesh_shape = _mesh_sizes(mesh)
    daxes = data_axes_of(mesh_axes)
    dsize = math.prod(mesh_shape[a] for a in daxes) if daxes else 1
    msize = mesh_shape.get("model", 1)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        # stacked caches have a leading super-block dim: the batch dim is
        # the first after it
        out: List[Entry] = [None] * len(shape)
        start = 1 if len(shape) >= 3 else 0
        if len(shape) >= 2 and daxes and shape[start] % dsize == 0:
            out[start] = daxes
        # shard a heads-like or channel dim over model (k/v: (..., S, H, D))
        if msize > 1 and len(shape) >= 2:
            for d in range(len(shape) - 1, start, -1):
                if out[d] is None and shape[d] % msize == 0 \
                        and shape[d] >= msize and "length" not in path:
                    out[d] = "model"
                    break
        return P(*out)

    return tree_map_with_path(one, state_shapes)


# --------------------------------------------------------------------------
# train / serve state + batch specs
# --------------------------------------------------------------------------

def train_state_specs(state_template, cfg: ModelConfig, par: ParallelConfig,
                      mesh):
    """Specs for a whole ``TrainState`` (params + optimizer slots + step +
    error buffer).

    Optimizer slots inherit the parameter's spec; adafactor's factored
    ``vr``/``vc`` slots drop the corresponding spec dimension (vr drops the
    last, vc the second-to-last) so ZeRO-style sharding carries over to the
    factored statistics.
    """
    pspecs = param_specs(state_template.params, cfg, par, mesh)
    pspec_by_path = flatten_with_paths(pspecs)

    def opt_spec(path: str, leaf) -> PartitionSpec:
        parts = path.split("/")
        if parts[0] in ("m", "v"):
            return pspec_by_path.get("/".join(parts[1:]), P())
        if parts[0] == "slots":
            kind = parts[-1]
            ppath = "/".join(parts[1:-1])
            spec = tuple(pspec_by_path.get(ppath, P()))
            # pad the spec with Nones to the param rank before factoring
            rank = len(leaf.shape) + (1 if kind in ("vr", "vc") else 0)
            spec = (None,) * (rank - len(spec)) + spec
            if kind == "vr":
                return P(*spec[:-1])
            if kind == "vc":
                return P(*(spec[:-2] + spec[-1:]))
            return P(*spec)
        return P()

    opt_specs = tree_map_with_path(opt_spec, state_template.opt_state)
    err_specs = pspecs if state_template.error_buf is not None else None
    return type(state_template)(
        params=pspecs, opt_state=opt_specs, step=P(), error_buf=err_specs)


def _batch_major(leaf, daxes, dsize) -> List[Entry]:
    out: List[Entry] = [None] * len(leaf.shape)
    if daxes and len(leaf.shape) and leaf.shape[0] % dsize == 0:
        out[0] = daxes
    return out


def batch_specs(batch_template, mesh):
    """Batch arrays shard dim 0 over the data-like axes."""
    axes, sizes = _mesh_sizes(mesh)
    daxes = data_axes_of(axes)
    dsize = math.prod(sizes[a] for a in daxes) if daxes else 1
    return tree_map_with_path(
        lambda _, leaf: P(*_batch_major(leaf, daxes, dsize)), batch_template)


def serve_state_specs(state_template, cfg: ModelConfig, par: ParallelConfig,
                      mesh):
    """ServeState sharding: caches via cache rules; lengths/extras
    batch-major."""
    axes, sizes = _mesh_sizes(mesh)
    daxes = data_axes_of(axes)
    dsize = math.prod(sizes[a] for a in daxes) if daxes else 1
    msize = sizes.get("model", 1)

    caches = cache_specs(state_template.caches, cfg, par, mesh)
    lengths = (P(daxes) if daxes and state_template.lengths.shape[0] % dsize
               == 0 else P(None))

    def extra_spec(_, leaf):
        out = _batch_major(leaf, daxes, dsize)
        if len(leaf.shape) >= 2 and msize > 1 and leaf.shape[-1] % msize == 0:
            out[-1] = "model"
        return P(*out)

    extras = tree_map_with_path(extra_spec, state_template.extras)
    return type(state_template)(caches=caches, lengths=lengths, extras=extras)


# --------------------------------------------------------------------------
# placements
# --------------------------------------------------------------------------

def to_placements(spec: PartitionSpec, mesh_axes: Sequence[str]) -> tuple:
    """DTensor placements of ``spec`` over a mesh with dims ``mesh_axes``:
    ``Shard(d)`` on each mesh dim that splits tensor dim ``d``,
    ``Replicate()`` on the others.  A dim split over several axes (such as
    ``("pod", "data")``) takes one ``Shard(d)`` on each, which DTensor
    applies in mesh-dim order: the axes must be named in that order, as
    the rules name them (row-major)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh_axes = tuple(mesh_axes)
    by_axis: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        order = [mesh_axes.index(a) for a in axes if a in mesh_axes]
        if len(order) != len(axes):
            raise ValueError(f"{spec} names an axis not in the mesh "
                             f"{mesh_axes}")
        if order != sorted(order):
            raise ValueError(f"{spec} splits dim {d} over {axes}, not in "
                             f"the mesh's order {mesh_axes}")
        for a in axes:
            by_axis[a] = d
    return tuple(Shard(by_axis[a]) if a in by_axis else Replicate()
                 for a in mesh_axes)
