"""Op-level cost analysis of one traced step — the port's counterpart of
:mod:`repro.launch.hlo_analysis`.

The reference parses the compiled HLO text of a step.  The port has no
compiler between the step and the card: eager PyTorch dispatches one aten
op after another, each a kernel of its own on the card (or a view of a
tensor).  So this module counts **dispatched aten ops, not HLO**:
:class:`OpCounter`, a ``TorchDispatchMode``, records one call of the step
on ``meta`` tensors (shapes and dtypes, nothing allocated), where the
kernels' plain versions run (:mod:`repro_torch.kernels.dispatch` sends
``meta`` tensors there).

What an op counts:

- **FLOPs.**  A matmul-class op (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  ``addbmm``, ``mv``, ``addmv``, ``dot``; ``einsum``, ``matmul`` and
  ``linear`` reach the dispatcher as these) counts 2·M·N·K.  Every other
  op counts 1 per output element, the reference's rule
  (``repro/launch/hlo_analysis.py:303``, ``:343-345``).  View, metadata
  and factory ops count nothing.
- **Bytes.**  Eager PyTorch fuses nothing, so outside a kernel scope an
  op reads its tensor operands and writes its results (each at its own
  size: a view reads only its elements).  View and metadata ops move
  nothing; ``empty`` allocates without writing; a gather (``embedding``,
  ``index``, ``index_select``, ``gather``) reads its indices and as many
  elements as it writes; an in-place write of an update (``copy_``,
  ``index_put_``, ``index_copy_``, ``scatter_``, ``fill_``, ``zero_``)
  reads its other operands and writes as many elements as the update
  holds (all of ``self`` for a fill).  Inside a kernel scope
  (:func:`repro_torch.kernels.ops._scoped`) the ops' FLOPs count, and of
  their bytes only the scope's boundary, as the reference charges a
  Pallas kernel (``:269-281``): the scope's tensor inputs read once and
  its results written once.
- **Collectives** by kind (``all-reduce``, ``all-gather``,
  ``reduce-scatter``, ``all-to-all``): the bytes of their operands, as the
  reference counts them, and their number, in program order.  The traced
  program is one rank's on a traced mesh, whose collectives record
  themselves (:class:`repro_torch.sharding.collectives.Recorder`);
  :func:`repro_torch.launch.build.lower_step` hands them to
  :meth:`OpCounter.add_collective`.
- **Kernel scopes** entered, by name (``rmsnorm``, ``flash_attention``,
  ``decode_attention``, ``paged_decode_attention``, ``selective_scan``,
  ``ssd``; ``<name>_bwd`` for a recompute backward).
- **Live bytes.**  Each storage an op creates is live from that op until
  its last tensor dies (rounded up to 512 bytes, the CUDA caching
  allocator's granule); the peak is kept.  The step's arguments are not
  among them.  A kernel scope allocates only its results (the kernel
  keeps its interior on chip); a recompute backward (``<name>_bwd``)
  runs the plain version op by op on the card, so its temporaries count.

Every number is per chip: the traced program is one rank's, at the
shapes the rank holds (its parameter blocks, its rows, its heads and
channels, its sequence block), so the counter divides nothing.
"""

from __future__ import annotations

import weakref
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import ops

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all")

#: matmul-class ops: 2·M·N·K each
_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
           "vdot"}
#: ops that move and compute nothing on the card (views aside)
_METADATA = {"_record_function_enter", "_record_function_enter_new",
             "_record_function_exit", "promote_types", "result_type",
             "_local_scalar_dense", "lift_fresh", "_unsafe_view"}
#: allocate without writing
_EMPTY = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "empty_permuted"}
#: read their indices and as many elements as they write
_GATHER = {"embedding", "index", "index_select", "gather"}
#: in-place writes of an update into ``self``
_UPDATE = {"copy_", "index_put_", "index_copy_", "scatter_", "scatter_add_",
           "index_add_", "masked_scatter_", "_index_put_impl_"}
_FILL = {"fill_", "zero_"}
#: the CUDA caching allocator's granule
_GRANULE = 512


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tensors(tree) -> List[torch.Tensor]:
    """The tensors among the leaves of ``tree`` (any pytree)."""
    leaves, _ = tree_flatten(tree)
    return [x for x in leaves if isinstance(x, torch.Tensor)]


def matmul_flops(name: str, args) -> float:
    """2·M·N·K of one matmul-class op (``name`` without its overload)."""
    t = [a for a in args if isinstance(a, torch.Tensor)]
    if name in ("addmm", "baddbmm", "addbmm", "addmv"):
        t = t[1:]  # the added term
    if len(t) < 2:
        return 0.0
    a, b = t[0], t[1]
    if name in ("dot", "vdot"):
        return 2.0 * a.numel()
    if name in ("mv", "addmv"):
        return 2.0 * a.shape[0] * a.shape[1]
    if name in ("bmm", "baddbmm", "addbmm"):
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]


@dataclass
class OpCosts:
    """One traced step's costs, per chip — the fields of the reference's
    ``HloCosts`` (``:357-366``) and the counter's own."""
    flops: float
    bytes_accessed: float
    collective_bytes: Dict[str, float]
    collective_count: Dict[str, int]
    matmul_flops: float
    kernel_scopes: Dict[str, int]
    peak_live_bytes: int

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


class Collective(NamedTuple):
    kind: str
    nbytes: float
    what: str  # the mesh axes of its group ("model", "data", "pod,data")


class OpCounter(TorchDispatchMode):
    """Counts one traced call's ops (see the module docstring).  Use as a
    context manager around the call; it listens to the kernel scopes for
    as long as it is entered.  With ``peak_tensors`` > 0 it also keeps,
    of the storages live at the peak, the that many largest groups made
    by one kind of op (:attr:`peak_live`: bytes, count and ``"op dtype
    shape fwd|bwd"``)."""

    def __init__(self, peak_tensors: int = 0):
        super().__init__()
        self.peak_tensors = peak_tensors
        self.peak_live: List[Tuple[int, int, str]] = []
        self._what: Dict[int, str] = {}  # id(storage) -> its maker
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.matmul_flops = 0.0
        self.kernel_scopes: Counter = Counter()
        self.collectives: List[Collective] = []
        #: op name -> [calls, FLOPs, bytes] (per chip)
        self.by_op: Dict[str, List[float]] = {}
        #: (op, operand shapes, "fwd" | "bwd") -> calls, of matmul-class ops
        self.matmuls: Counter = Counter()
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._known: Dict[int, int] = {}  # id(storage) -> counted bytes
        #: the open kernel scopes: whether each is a kernel's interior
        self._scopes: List[bool] = []
        self._listening = None

    # -- set-up -------------------------------------------------------------

    def add_argument(self, tensor: torch.Tensor) -> None:
        """An argument of the step: its storage is not a temporary."""
        st = tensor.untyped_storage()
        self._known[id(st)] = 0
        weakref.finalize(st, self._known.pop, id(st), None)

    def add_collective(self, kind: str, nbytes: float, what: str,
                       count: int = 1) -> None:
        """Record ``count`` collectives of ``kind``, ``nbytes`` of operand
        each."""
        if kind not in COLLECTIVE_KINDS:
            raise ValueError(f"unknown collective kind {kind!r}")
        for _ in range(count):
            self.collectives.append(Collective(kind, float(nbytes), what))

    # -- the mode -------------------------------------------------------------

    def __enter__(self):
        self._listening = ops.KERNEL_SCOPE.counter
        ops.KERNEL_SCOPE.counter = self
        return super().__enter__()

    def __exit__(self, *exc):
        ops.KERNEL_SCOPE.counter = self._listening
        return super().__exit__(*exc)

    def scoped(self, name: str, body: Callable, args, kwargs):
        """Run ``body`` as the kernel scope ``name`` (called by
        :func:`repro_torch.kernels.ops._scoped`)."""
        self.kernel_scopes[name] += 1
        inputs = tensors((args, kwargs))
        outer = not self._scopes
        # a kernel keeps its interior on chip; a recompute backward runs
        # the plain version op by op, whose temporaries are real
        self._scopes.append(not name.endswith("_bwd"))
        try:
            out = body(*args, **kwargs)
        finally:
            self._scopes.pop()
        results = tensors(out)
        if not name.endswith("_bwd"):
            self._track(results, f"scope:{name}")
        if outer:
            boundary = (sum(map(_nbytes, inputs))
                        + sum(map(_nbytes, results)))
            self.bytes_accessed += boundary
            self._tally(f"scope:{name}", 0.0, boundary)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name in _METADATA or func.is_view:
            return out
        outs = tensors(out)
        ins = tensors((args, kwargs))
        flops, nbytes = self._cost(name, ins, outs, args)
        if self._scopes:  # a kernel's interior: its FLOPs, no bytes
            nbytes = 0.0
        if name in _MATMUL:
            self.matmul_flops += flops
            backward = torch._C._current_autograd_node() is not None
            self.matmuls[(name, tuple(tuple(t.shape) for t in ins),
                          "bwd" if backward else "fwd")] += 1
        self.flops += flops
        self.bytes_accessed += nbytes
        self._tally(name, flops, nbytes)
        if not (self._scopes and self._scopes[-1]):
            self._track(outs, name)
        return out

    # -- rules ----------------------------------------------------------------

    @staticmethod
    def _cost(name, ins, outs, args) -> Tuple[float, float]:
        out_elems = sum(t.numel() for t in outs)
        written = sum(map(_nbytes, outs))
        if name in _MATMUL:
            return matmul_flops(name, args), sum(map(_nbytes, ins)) + written
        if not ins or name in _EMPTY:  # a factory op
            return 0.0, 0.0 if name in _EMPTY else float(written)
        if name in _GATHER:
            idx = sum(_nbytes(t) for t in ins if not t.is_floating_point())
            return float(out_elems), float(idx + 2 * written)
        if name in _FILL:
            return float(out_elems), float(written)
        if name in _UPDATE:
            update = max((t for t in ins[1:] if t.is_floating_point()),
                         key=_nbytes, default=None)
            size = written if update is None else _nbytes(update)
            elems = out_elems if update is None else update.numel()
            return float(elems), float(sum(map(_nbytes, ins[1:])) + size)
        return float(out_elems), float(sum(map(_nbytes, ins)) + written)

    # -- bookkeeping ----------------------------------------------------------

    def _tally(self, name: str, flops: float, nbytes: float) -> None:
        rec = self.by_op.setdefault(name, [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes

    def _track(self, outs, op: str) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._known:
                continue
            size = -(-st.nbytes() // _GRANULE) * _GRANULE
            self._known[key] = size
            self.live_bytes += size
            weakref.finalize(st, self._free, key)
            if self.peak_tensors:
                phase = ("bwd" if torch._C._current_autograd_node() is not None
                         else "fwd")
                self._what[key] = (f"{op} {str(t.dtype)[6:]} "
                                   f"{tuple(t.shape)} {phase}")
        if self.live_bytes > self.peak_live_bytes:
            self.peak_live_bytes = self.live_bytes
            if self.peak_tensors:
                groups: Dict[str, List[int]] = {}
                for k, n in self._known.items():
                    if n:
                        g = groups.setdefault(self._what[k], [0, 0])
                        g[0] += n
                        g[1] += 1
                self.peak_live = sorted(
                    ((n, c, what) for what, (n, c) in groups.items()),
                    reverse=True)[:self.peak_tensors]

    def _free(self, key: int) -> None:
        self.live_bytes -= self._known.pop(key, 0) or 0
        self._what.pop(key, None)

    # -- results --------------------------------------------------------------

    def result_bytes(self, out) -> int:
        """Bytes of the storages in ``out`` that the traced call created
        (not its arguments')."""
        seen = {}
        for t in tensors(out):
            st = t.untyped_storage()
            if self._known.get(id(st)) != 0:  # 0: an argument's storage
                seen[id(st)] = st.nbytes()
        return sum(seen.values())

    def costs(self) -> OpCosts:
        cb: Dict[str, float] = {}
        cc: Dict[str, int] = {}
        for c in self.collectives:
            cb[c.kind] = cb.get(c.kind, 0.0) + c.nbytes
            cc[c.kind] = cc.get(c.kind, 0) + 1
        return OpCosts(flops=self.flops, bytes_accessed=self.bytes_accessed,
                       collective_bytes=cb, collective_count=cc,
                       matmul_flops=self.matmul_flops,
                       kernel_scopes=dict(self.kernel_scopes),
                       peak_live_bytes=self.peak_live_bytes)

    def as_text(self) -> str:
        """The record as text: ops by name (calls, FLOPs, bytes per chip),
        kernel scopes, matmuls by shape, collectives in program order."""
        lines = ["# op  calls  flops  bytes"]
        for name, (n, fl, by) in sorted(self.by_op.items(),
                                        key=lambda kv: -kv[1][1]):
            lines.append(f"{name} {int(n)} {fl:.6g} {by:.6g}")
        lines.append("# kernel scopes")
        lines += [f"{k} {v}" for k, v in sorted(self.kernel_scopes.items())]
        lines.append("# matmuls: op shapes phase calls")
        lines += [f"{op} {shapes} {ph} {n}" for (op, shapes, ph), n in
                  sorted(self.matmuls.items(), key=lambda kv: str(kv[0]))]
        lines.append("# collectives")
        lines += collective_schedule(self, limit=None)
        return "\n".join(lines)


def collective_schedule(counter: OpCounter, limit: Optional[int] = 40
                        ) -> List[str]:
    """The collectives in program order, as ``kind bytes axes`` lines, at
    most ``limit``."""
    out = [f"{c.kind} {c.nbytes:.0f} {c.what}" for c in counter.collectives]
    return out if limit is None else out[:limit]


def trace(fn: Callable, args, *, train: bool, counter: OpCounter):
    """Call ``fn(*args)`` once under ``counter`` (grad on for a train
    step, off for serving) and return its result."""
    for t in tensors(args):
        counter.add_argument(t)
    grad = torch.enable_grad() if train else torch.no_grad()
    with grad, counter:
        return fn(*args)

