"""CUDA RMSNorm wrapper (kernel: ``repro_torch/csrc/rmsnorm.cu``).

Replaces the TPU kernel ``repro/kernels/rmsnorm/kernel.py::rmsnorm_pallas``
(``_rms_kernel``, ``_rms_res_kernel``).  Bound on the H100 by bytes: a row
is read and written once for a handful of flops per element; at the port's
sizes what costs is the latency of the loads.  The kernel makes one pass
over device memory: each lane holds its share of the row in registers
(16-byte vectors, or single elements for widths that are not whole vectors
and for unaligned tensors), with every load of the row, the residual and
the weight in flight at once.  :func:`plan_rmsnorm` decides from the shapes
alone how many warps share a row (more when rows are few) and how many
slots each lane holds; :func:`launch_records` gives the launch it makes.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any, Dict, Iterable, List, NamedTuple, Optional

import torch

from repro_torch.kernels import cuda_lib, dispatch
from repro_torch.kernels.cuda_lib import LaunchRecord, LaunchWork, Tile
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

#: slots a lane holds (16-byte vectors, or elements), as ``rmsnorm.cu``
#: instantiates them
SLOTS = (1, 2, 3, 4, 5, 6, 8, 16)
#: warps that may share one row
WARPS_PER_ROW = (1, 2, 4, 8)
#: a row takes more warps before one lane holds more than this many slots
#: (8 vectors of x, residual and weight stay in registers without spilling)
MAX_SLOTS_PER_WARP_ROW = 8
#: while the call has fewer warps than this (~8 per SM on 132 SMs), a row
#: takes more warps, as long as every lane keeps at least one slot
TARGET_WARPS = 1024
#: warps of one block (``kMaxRmsWarps``): its static ``partial`` holds one
#: fp32 sum a warp
MAX_BLOCK_WARPS = 8
STATIC_SMEM = MAX_BLOCK_WARPS * 4
#: rows of the shapes :func:`launch_shapes` gives: a training call's, so
#: that one warp takes a row of the narrower widths and ``row_block`` bites
SHAPE_ROWS = 1024


class RmsPlan(NamedTuple):
    warps_per_row: int
    rows_per_block: int
    slots: int          # per lane
    vectorized: bool    # 16-byte vectors (else single elements)


def max_width(itemsize: int, vectorized: bool) -> int:
    """The widest row an instantiation covers."""
    per_slot = 16 // itemsize if vectorized else 1
    return SLOTS[-1] * 32 * WARPS_PER_ROW[-1] * per_slot


@lru_cache(maxsize=256)
def plan_rmsnorm(rows: int, dim: int, itemsize: int, vectorized: bool,
                 row_block: int = 4) -> RmsPlan:
    """The launch plan for ``rows`` rows of ``dim`` elements of
    ``itemsize`` bytes, from the shapes alone.  A row takes the fewest
    warps that keep each lane at :data:`MAX_SLOTS_PER_WARP_ROW` slots or
    fewer, then more while the call has fewer than :data:`TARGET_WARPS`
    warps; with one warp per row, ``row_block`` rows share a block.
    Raises for a width no instantiation covers."""
    per_slot = 16 // itemsize if vectorized else 1
    if dim < 1 or dim % per_slot:
        raise ValueError(f"rmsnorm: width {dim} is not a whole number of "
                         f"{per_slot}-element slots")
    n = dim // per_slot

    def need(wpr):
        return -(-n // (32 * wpr))

    wpr = WARPS_PER_ROW[0]
    while wpr < WARPS_PER_ROW[-1] and need(wpr) > MAX_SLOTS_PER_WARP_ROW:
        wpr *= 2
    while (wpr < WARPS_PER_ROW[-1] and rows * wpr < TARGET_WARPS
           and n >= 64 * wpr):
        wpr *= 2
    slots = next((s for s in SLOTS if s >= need(wpr)), None)
    if slots is None:
        raise ValueError(
            f"rmsnorm: width {dim} is wider than the kernel covers "
            f"({max_width(itemsize, vectorized)} elements of {itemsize} "
            f"bytes{'' if vectorized else ', element by element'})")
    return RmsPlan(wpr, row_block if wpr == 1 else 1, slots, vectorized)


def launch_shapes(cfgs: Iterable[Any]) -> List[Dict[str, Any]]:
    """The norm widths of the model configs ``cfgs`` (each model width) at
    :data:`SHAPE_ROWS` rows."""
    return [dict(rows=SHAPE_ROWS, dim=d)
            for d in sorted({c.d_model for c in cfgs})]


def launch_records(shape: Dict[str, Any], dtype: torch.dtype, *,
                   row_block: int = 4) -> List[LaunchRecord]:
    """The launch of one call on ``rows`` x ``dim`` contiguous, aligned
    tensors: :func:`plan_rmsnorm`'s plan, ``rows_per_block`` rows of
    ``warps_per_row`` warps a block."""
    rows, dim = shape["rows"], shape["dim"]
    itemsize = dtype.itemsize
    row_block = dispatch.snap_down(
        row_block, dispatch.get_family("rmsnorm").option("row_block").values)
    plan = plan_rmsnorm(rows, dim, itemsize, dim % (16 // itemsize) == 0,
                        row_block)
    rpb = plan.rows_per_block

    def writes(idx):
        return (Tile("y", ((idx[0] * rpb, min((idx[0] + 1) * rpb, rows)),
                           (0, dim))),)

    return [LaunchRecord(
        f"repro::rmsnorm_kernel<{cuda_lib.CTYPE_NAMES[dtype]}, {plan.slots}, "
        f"{str(plan.vectorized).lower()}>", (-(-rows // rpb), 1, 1),
        (32 * plan.warps_per_row * rpb, 1, 1), 0, STATIC_SMEM,
        writes=writes)]


def launch_work(shape: Dict[str, Any], dtype: torch.dtype, *,
                row_block: int = 4) -> List[LaunchWork]:
    """The work of one call: x read and y written once, the weight read
    once; four operations an element."""
    rows, dim = shape["rows"], shape["dim"]
    return [LaunchWork(4 * rows * dim, 0,
                       (2 * rows * dim + dim) * dtype.itemsize)]


def rmsnorm_cuda(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-5,
                 residual: Optional[torch.Tensor] = None,
                 row_block: int = 4) -> torch.Tensor:
    """``rmsnorm(x [+ residual]) * weight`` over the last axis.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, weight, eps=eps, residual=residual)
    tensors = (x, weight) + ((residual,) if residual is not None else ())
    cuda_lib.require("rmsnorm", *tensors, dtype=x.dtype)
    d = x.shape[-1]
    if weight.shape != (d,):
        raise ValueError(f"rmsnorm: weight {tuple(weight.shape)} != ({d},)")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"rmsnorm: residual {tuple(residual.shape)} != "
                         f"x {tuple(x.shape)}")
    y = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    vec = 16 // x.element_size()
    vectorized = d % vec == 0 and all(
        t.data_ptr() % 16 == 0 for t in tensors + (y,))
    row_block = dispatch.snap_down(
        row_block, dispatch.get_family("rmsnorm").option("row_block").values)
    plan = plan_rmsnorm(rows, d, x.element_size(), vectorized, row_block)
    err = cuda_lib.library().repro_rmsnorm(
        x.data_ptr(), residual.data_ptr() if residual is not None else None,
        weight.data_ptr(), y.data_ptr(), rows, d, eps, cuda_lib.dtype_code(x),
        plan.rows_per_block, plan.warps_per_row, plan.slots,
        int(plan.vectorized), cuda_lib.stream_of(x))
    cuda_lib.check(err, "rmsnorm")
    cuda_lib.LAUNCHES["rmsnorm"] += 1
    return y
