"""The collectives of sharded execution, as autograd functions over
``torch.distributed`` calls, counted.

Each operator is a forward / backward pair on the tensors' own device (a
process group that cannot carry a collective on that device raises; no
copy to the host is made):

- :func:`enter` — identity forward, all-reduce backward: where a tensor
  every model rank holds whole enters a computation split over the model
  axis (Megatron's ``f``), so the partial input gradients are summed;
- :func:`leave` — all-reduce forward, identity backward: the partial sums
  of a row-parallel product (Megatron's ``g``);
- :func:`all_reduce` — all-reduce both ways: a partial sum whose every
  consumer is split again (Mamba-1's ``w_bcdt`` product, Mamba-2's norm
  statistics, the MoE router's statistics);
- :func:`gather` — all-gather forward along a dim; the backward
  reduce-scatters (an FSDP weight: every rank's gradient of the whole
  weight is a partial sum) or takes the rank's slice (``"slice"``: a
  product every model rank then uses whole, e.g. the MTP projection);
- :func:`scatter` — reduce-scatter forward along a dim, all-gather
  backward: the partial sums of a row-parallel product leaving for the
  rank's sequence block under sequence parallelism (Megatron's
  sequence-parallel ``g``);
- :func:`shard` — the rank's block along a dim forward, all-gather
  backward: a tensor every model rank holds whole and complete leaving
  for the rank's sequence block;
- :func:`all_to_all` — the GShard expert exchange, an all-to-all both
  ways.

Every call adds its operand's bytes to :data:`COUNTS`, by kind and axis,
under the calling rank: an all-reduce or an all-to-all counts its tensor,
an all-gather its local block, a reduce-scatter its whole input (the
reference's operand convention).  ``axis`` names the mesh axes the group
spans (``"model"``, ``"data"``, ``"pod,data"``).

An axis whose group is a :class:`Recorder` (a traced mesh's,
:meth:`repro_torch.launch.mesh.MeshSpec.traced`) moves no data and never
calls ``torch.distributed``: each operator records ``(kind, axis, operand
bytes)`` in the recorder, by the same convention, and returns an unwritten
tensor of its result's shape on the input's device.  So one rank's
sharded program runs on ``meta`` tensors with the shapes the rank holds,
and its collectives are the ones the rank would send
(:func:`repro_torch.launch.build.lower_step`).
"""

from __future__ import annotations

import threading
from collections import Counter, defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

_LOCK = threading.Lock()
#: global rank -> Counter of (kind, axis) -> operand bytes
COUNTS: Dict[int, Counter] = defaultdict(Counter)


class Axis(NamedTuple):
    """A process group over some mesh axes: ``name`` (the axes joined by
    commas), its ``size`` and this rank's index in it."""
    group: object
    name: str
    size: int
    rank: int


class Recorder:
    """The group of a traced mesh's axes: ``entries`` lists ``(kind, axis
    name, operand bytes)`` of every collective over them, in program
    order."""

    def __init__(self):
        self.entries: List[Tuple[str, str, int]] = []

    def __repr__(self) -> str:
        return f"Recorder({len(self.entries)} collectives)"


def _traced(axis: Axis) -> bool:
    return isinstance(axis.group, Recorder)


def reset_counts() -> None:
    """Forget the calling rank's counts (every rank's without a process
    group): ranks that are threads of one process reset their own."""
    with _LOCK:
        if dist.is_initialized():
            COUNTS.pop(dist.get_rank(), None)
        else:
            COUNTS.clear()


def bytes_by_kind(rank: Optional[int] = None) -> Dict[str, int]:
    """Operand bytes by kind of the collectives ``rank`` (this process's
    global rank unless given) ran since :func:`reset_counts`."""
    rank = dist.get_rank() if rank is None else rank
    out: Counter = Counter()
    with _LOCK:
        for (kind, _), n in COUNTS[rank].items():
            out[kind] += n
    return dict(out)


def _count(kind: str, axis: Axis, t: torch.Tensor) -> None:
    nbytes = t.numel() * t.element_size()
    if _traced(axis):
        axis.group.entries.append((kind, axis.name, nbytes))
        return
    rank = dist.get_rank()
    with _LOCK:
        COUNTS[rank][(kind, axis.name)] += nbytes


def _all_reduce(t: torch.Tensor, axis: Axis, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    if _traced(axis):
        _count("all-reduce", axis, t)
        return t.new_empty(t.shape)
    out = t.contiguous().clone()
    _count("all-reduce", axis, out)
    dist.all_reduce(out, op=op, group=axis.group)
    return out


def _all_gather(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    _count("all-gather", axis, t)
    shape = list(t.shape)
    shape[dim] *= axis.size
    if _traced(axis):
        return t.new_empty(shape)
    t = t.contiguous()
    flat = t.reshape(-1)
    out = flat.new_empty((axis.size * flat.numel(),))
    dist.all_gather_into_tensor(out, flat, group=axis.group)
    # (n, ..., k, ...) -> (..., n k, ...): the blocks in rank order
    out = out.view((axis.size,) + tuple(t.shape)).movedim(0, dim)
    return out.reshape(shape)


def _reduce_scatter(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    n = axis.size
    shape = list(t.shape)
    block = shape[dim] // n
    _count("reduce-scatter", axis, t)
    if _traced(axis):
        shape[dim] = block
        return t.new_empty(shape)
    parts = t.unflatten(dim, (n, block)).movedim(dim, 0).contiguous()
    out = parts.new_empty(parts[0].numel())
    dist.reduce_scatter_tensor(out, parts.reshape(-1), group=axis.group)
    return out.view(parts.shape[1:])


def _slice(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    block = t.shape[dim] // axis.size
    return t.narrow(dim, axis.rank * block, block).contiguous()


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, backward, grad_dtype):
        ctx.axis, ctx.dim, ctx.mode = axis, dim, backward
        ctx.dtype, ctx.grad_dtype = x.dtype, grad_dtype
        return _all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.mode == "slice":
            return _slice(g, ctx.axis, ctx.dim), None, None, None, None
        g = _reduce_scatter(g.to(ctx.grad_dtype or g.dtype), ctx.axis,
                            ctx.dim)
        return g.to(ctx.dtype), None, None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _reduce_scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.axis, ctx.dim), None, None


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _slice(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.axis, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _exchange(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.axis), None


def _exchange(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    _count("all-to-all", axis, x)
    if _traced(axis):
        return x.new_empty(x.shape)
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=axis.group)
    return out


def enter(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Identity forward, all-reduce of the gradient backward."""
    if axis is None or axis.size == 1:
        return x
    return _Enter.apply(x, axis)


def leave(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """All-reduce forward, identity backward."""
    if axis is None or axis.size == 1:
        return x
    return _Leave.apply(x, axis)


def all_reduce(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """All-reduce (sum) forward and backward."""
    if axis is None or axis.size == 1:
        return x
    return _AllReduce.apply(x, axis)


def sum_(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The sum over ``axis`` (no gradient): a new tensor, ``x`` itself on
    one rank."""
    if axis is None or axis.size == 1:
        return x
    return _all_reduce(x.detach(), axis)


def all_reduce_max(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The maximum over ``axis`` (no gradient)."""
    if axis is None or axis.size == 1:
        return x
    return _all_reduce(x.detach(), axis, dist.ReduceOp.MAX)


def all_gather_values(x: torch.Tensor, axis: Optional[Axis], dim: int
                      ) -> torch.Tensor:
    """Every rank's ``x`` along ``dim``, in the group's rank order (no
    gradient)."""
    if axis is None or axis.size == 1:
        return x
    return _all_gather(x.detach(), axis, dim % x.ndim)


def gather(x: torch.Tensor, axis: Optional[Axis], dim: int,
           backward: str = "reduce-scatter",
           grad_dtype: Optional[torch.dtype] = torch.float32
           ) -> torch.Tensor:
    """All-gather along ``dim`` (the blocks in the group's rank order);
    the backward reduce-scatters, or takes this rank's block
    (``backward="slice"``).  The reduce-scatter sums in ``grad_dtype``
    (fp32 by default: an fp32 master's gradient), or in the gradient's own
    dtype when it is None (an activation's)."""
    if axis is None or axis.size == 1:
        return x
    if backward not in ("reduce-scatter", "slice"):
        raise ValueError(f"unknown gather backward {backward!r}")
    return _Gather.apply(x, axis, dim % x.ndim, backward, grad_dtype)


def _blocks(x: torch.Tensor, axis: Axis, dim: int) -> int:
    if x.shape[dim] % axis.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {axis.size} blocks")
    return dim % x.ndim


def scatter(x: torch.Tensor, axis: Optional[Axis], dim: int
            ) -> torch.Tensor:
    """Reduce-scatter (sum) along ``dim``: this rank's block of the sum of
    every rank's ``x``; the backward all-gathers the gradient."""
    if axis is None or axis.size == 1:
        return x
    return _Scatter.apply(x, axis, _blocks(x, axis, dim))


def shard(x: torch.Tensor, axis: Optional[Axis], dim: int) -> torch.Tensor:
    """This rank's block of ``x`` (which every rank holds the same) along
    ``dim``; the backward all-gathers the gradient, so the whole gradient
    of ``x`` is on every rank."""
    if axis is None or axis.size == 1:
        return x
    return _Shard.apply(x, axis, _blocks(x, axis, dim))


def all_to_all(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """``x`` (n, ...) -> (n, ...): block ``j`` goes to rank ``j``, and
    block ``j`` of the result came from rank ``j``; the backward sends
    the gradients back the same way."""
    if axis is None or axis.size == 1:
        return x
    if x.shape[0] != axis.size:
        raise ValueError(f"all-to-all over {axis.size} ranks of a tensor "
                         f"of shape {tuple(x.shape)}")
    return _AllToAll.apply(x, axis)
