"""CUDA Mamba-1 selective-scan wrapper (kernel:
``repro_torch/csrc/selective_scan.cu``).

Replaces the TPU kernel
``repro/kernels/mamba_scan/kernel.py::selective_scan_pallas``
(``_scan_kernel``).  On the H100 the exponentials bound it: B*L*C*N of
them on the special-function units (about 2x the bytes' time at the
training shape).  The kernel runs the sequence loop inside each block with
the state in registers: a lane holds :data:`STATES` (4) consecutive
states of one channel, ``lanes`` lanes share the channel (a power of two,
``lanes * 4 >= N``), a block takes ``channels`` channels of one batch row,
and the time loop is unrolled with every decay of 8 steps formed before
the FMAs on h that need them.
x, dt, B and C are staged ``chunk`` steps at a time through a two-stage
``cp.async`` ring.  Ragged L and C are masked, not padded.  With
``return_state`` the lanes also write the final state (B, C, N) fp32 from
their registers after the last chunk (serving's prefill); the plan is the
same.

:func:`plan_scan` picks the plan from the shapes alone.  The launch
options keep their names: ``chunk`` is the steps staged per pass and
``c_block`` the most channels a block takes; both snap down into the
family's domains (the reference's TPU-sized ``ssm_chunk`` of 256 becomes
64), and the planner then takes fewer channels a block while the grid is
short of blocks.  Neither changes the result.  :func:`launch_records`
gives the launch a plan makes.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any, Dict, Iterable, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels import cuda_lib, dispatch
from repro_torch.kernels.cuda_lib import LaunchRecord, LaunchWork, Tile
from repro_torch.kernels.mamba_scan.ref import selective_scan_chunked_ref

#: states a lane holds (``kStates`` in the kernel; the fastest of 1, 2, 4
#: and 8 in a sweep on the card at falcon-mamba-7b's training shape)
STATES = 4
#: steps whose decays a lane forms together (``kDecaySteps``)
DECAY_STEPS = 8
#: lanes that may share one channel (one warp)
MAX_LANES = 32
#: the largest state size N the kernel takes
MAX_STATE = STATES * MAX_LANES
#: threads a block (``kMaxThreads`` in the kernel)
MAX_THREADS = 256
#: while the grid has fewer blocks than this (half an H100's 132 SMs), a
#: block takes fewer channels, so a short call still spreads over the SMs
MIN_BLOCKS = 64


class ScanPlan(NamedTuple):
    lanes: int      # LPC: lanes sharing one channel, STATES states each
    channels: int   # channels a block takes
    chunk: int      # time steps staged per pass
    threads: int    # channels * lanes
    blocks: int
    smem: int       # shared bytes a block


def _pow2_ceil(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


def lanes_for(n: int) -> int:
    """Lanes a channel of state size ``n`` needs: a power of two with
    ``lanes * STATES >= n``."""
    return _pow2_ceil(-(-n // STATES))


def group_steps(lanes: int) -> int:
    """Steps of one unrolled group (``G`` in the kernel): the reduce-scatter
    over the lanes takes ``lanes`` steps at once, the decays
    :data:`DECAY_STEPS`."""
    return max(lanes, DECAY_STEPS)


def scan_smem_bytes(n: int, k: int, channels: int, chunk: int,
                    itemsize: int) -> int:
    """Shared bytes of one block (``smem_bytes`` in the kernel): the x/dt
    ring, the raw B/C ring, the fp32 B/C table of ``k`` padded states and
    the y tile (sized with the input's element size)."""
    row = (channels + 16 // itemsize) * itemsize
    return (4 * chunk * row + 4 * chunk * n * itemsize
            + 2 * chunk * 2 * k * 4 + 2 * chunk * row)


def make_plan(b: int, c: int, n: int, itemsize: int, channels: int,
              chunk: int) -> ScanPlan:
    """The plan of ``channels`` channels a block and ``chunk`` steps a
    pass for x, dt of (b, ., c) and a state of n stored in ``itemsize``
    bytes; raises for one the kernel does not take."""
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"selective_scan: state size {n} outside 1.."
                         f"{MAX_STATE}")
    if itemsize not in (2, 4):
        raise ValueError(f"selective_scan: element size {itemsize}")
    lanes = lanes_for(n)
    threads = channels * lanes
    smem = scan_smem_bytes(n, STATES * lanes, channels, chunk, itemsize)
    if (threads % 32 or threads > MAX_THREADS or channels * itemsize % 16
            or chunk % 16 or chunk < group_steps(lanes)
            or smem > cuda_lib.SMEM_LIMIT):
        raise ValueError(f"selective_scan: no plan of {channels} channels "
                         f"and chunk {chunk} at N {n} ({threads} threads, "
                         f"{smem} bytes of shared memory)")
    return ScanPlan(lanes, channels, chunk, threads, b * -(-c // channels),
                    smem)


@lru_cache(maxsize=256)
def plan_scan(b: int, l: int, c: int, n: int, itemsize: int,
              chunk: int = 64, c_block: int = 64) -> ScanPlan:
    """The launch plan for x, dt of (b, l, c) and a state of n, stored in
    ``itemsize`` bytes, from the shapes alone.  A block takes ``c_block``
    channels (within :data:`MAX_THREADS` threads, one warp at least), then
    fewer while the grid has fewer than :data:`MIN_BLOCKS` blocks; the
    chunk is at most the sequence (16 steps at least), at least one
    unrolled group, and shrinks while a block would need more than half an
    SM's shared memory.  Raises for N past :data:`MAX_STATE`."""
    fam = dispatch.get_family("mamba_scan")
    chunk = dispatch.snap_down(chunk, fam.option("chunk").values)
    c_block = dispatch.snap_down(c_block, fam.option("c_block").values)
    lanes = lanes_for(n)
    # 8 channels keep a tile row a whole number of 16-byte vectors
    fewest = max(32 // lanes, 8)
    channels = min(max(c_block, fewest), MAX_THREADS // lanes)
    while b * -(-c // channels) < MIN_BLOCKS and channels > fewest:
        channels //= 2
    # a short sequence stages no more than it has (16 steps at least)
    least = max(16, group_steps(lanes))
    chunk = max(min(chunk, _pow2_ceil(l)), least)
    while (scan_smem_bytes(n, STATES * lanes, channels, chunk, itemsize)
           > cuda_lib.SMEM_LIMIT // 2 and chunk > least):
        chunk //= 2
    return make_plan(b, c, n, itemsize, channels, chunk)


#: batch and sequence of the shapes :func:`launch_shapes` gives (ragged
#: against every chunk)
SHAPE_BATCH, SHAPE_LEN = 2, 80


def launch_shapes(cfgs: Iterable[Any]) -> List[Dict[str, Any]]:
    """The Mamba-1 scans of the model configs ``cfgs``: their state size N
    over their inner width, with the final state (serving's prefill), at
    :data:`SHAPE_BATCH` x :data:`SHAPE_LEN`."""
    dims = sorted({(c.ssm_state, c.ssm_expand * c.d_model) for c in cfgs
                   if c.family in ("ssm", "hybrid") and not c.ssm_num_heads})
    return [dict(batch=SHAPE_BATCH, len=SHAPE_LEN, channels=ch, n=n,
                 return_state=True) for n, ch in dims]


def plan_record(plan: ScanPlan, dtype: torch.dtype, b: int, l: int, c: int,
                n: int, return_state: bool,
                out_dtype: Optional[torch.dtype] = None) -> LaunchRecord:
    """The launch of ``plan`` on x, dt of (b, l, c) stored as ``dtype``,
    y in ``out_dtype`` (x's; default ``dtype``): grid (channel blocks, B);
    block (cx, b) writes y[b, :, its channels] and, with ``return_state``,
    their final state."""
    cpb = plan.channels

    def writes(idx):
        c0, b0 = idx[0] * cpb, idx[1]
        cs = (c0, min(c0 + cpb, c))
        tiles = (Tile("y", ((b0, b0 + 1), (0, l), cs)),)
        if return_state:
            tiles += (Tile("h_out", ((b0, b0 + 1), cs, (0, n))),)
        return tiles

    name = cuda_lib.CTYPE_NAMES[dtype]
    out = cuda_lib.CTYPE_NAMES[out_dtype or dtype]
    return LaunchRecord(
        f"repro::scan::selective_scan_kernel<{name}, {out}, {plan.lanes}>",
        (-(-c // cpb), b, 1), (plan.threads, 1, 1), plan.smem,
        writes=writes)


def _storage(dtype: torch.dtype, dt_dtype: torch.dtype) -> torch.dtype:
    """The kernel's storage for x, B and C in ``dtype`` beside dt in
    ``dt_dtype``, as :func:`storage_size` picks it."""
    same = dt_dtype == dtype and dtype in cuda_lib.DTYPE_CODES
    return dtype if same else torch.float32


def launch_records(shape: Dict[str, Any], dtype: torch.dtype, *,
                   chunk: int = 64, c_block: int = 64,
                   dt_dtype: Optional[torch.dtype] = None
                   ) -> List[LaunchRecord]:
    """The launch of one scan at ``shape`` on x, B, C and y in ``dtype``
    and dt in ``dt_dtype`` (default ``dtype``): :func:`plan_scan`'s plan
    on the kernel's storage (a bf16 x beside fp32 dt is widened to fp32,
    y stays bf16)."""
    b, l, c, n = (shape["batch"], shape["len"], shape["channels"],
                  shape["n"])
    storage = _storage(dtype, dt_dtype or dtype)
    plan = plan_scan(b, l, c, n, storage.itemsize, chunk,
                     c_block)
    return [plan_record(plan, storage, b, l, c, n, shape["return_state"],
                        dtype)]


def launch_work(shape: Dict[str, Any], dtype: torch.dtype, *,
                chunk: int = 64, c_block: int = 64,
                dt_dtype: Optional[torch.dtype] = None) -> List[LaunchWork]:
    """The work of one scan at ``shape`` on x, B, C and y in ``dtype`` and
    dt in ``dt_dtype`` (default ``dtype``): every block walks all ``len``
    time steps; where dt's type differs, the wrapper first widens x, B and
    C to one fp32 storage (three copies, as :func:`storage_size` says)."""
    b, l, c, n = (shape["batch"], shape["len"], shape["channels"],
                  shape["n"])
    es = dtype.itemsize
    dt_dtype = dt_dtype or dtype
    wide = _storage(dtype, dt_dtype) != dtype
    (record,) = launch_records(shape, dtype, chunk=chunk, c_block=c_block,
                               dt_dtype=dt_dtype)
    blocks = record.grid[0] * record.grid[1] * record.grid[2]
    hbm = (2 * b * l * c * es + b * l * c * dt_dtype.itemsize
           + 2 * b * l * n * es + 4 * c * n + 4 * c
           + shape["return_state"] * 4 * b * c * n)
    widened = b * l * (c + 2 * n) if wide else 0
    return [LaunchWork(7 * b * l * c * n, b * l * c * n, hbm,
                       steps=np.full(blocks, l), copies=3 if wide else 0,
                       copy_bytes=widened * (es + 4))]


def storage_size(x: torch.Tensor, dt: torch.Tensor, Bmat: torch.Tensor,
                 Cmat: torch.Tensor) -> int:
    """Bytes an element of the kernel's storage: x's when x, dt, B and C
    share a type the kernel takes, else fp32's (as
    :func:`cuda_lib.one_storage` widens)."""
    same = all(t.dtype == x.dtype for t in (dt, Bmat, Cmat))
    return x.element_size() if same and x.dtype in cuda_lib.DTYPE_CODES \
        else 4


def selective_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        Bmat: torch.Tensor, Cmat: torch.Tensor,
                        D: torch.Tensor, *, chunk: int = 64,
                        c_block: int = 64, return_state: bool = False):
    """x, dt (B, L, C); A (C, N); Bmat, Cmat (B, L, N); D (C,) -> y (B, L,
    C) in x's dtype, and with ``return_state`` the final state (B, C, N)
    fp32.  A CPU tensor takes the plain version; a CUDA tensor launches
    :func:`plan_scan`'s plan."""
    if x.device.type == "cpu":
        return selective_scan_chunked_ref(x, dt, A, Bmat, Cmat, D,
                                          chunk=chunk,
                                          return_state=return_state)
    b, l, c = x.shape
    plan = plan_scan(b, l, c, A.shape[1], storage_size(x, dt, Bmat, Cmat),
                     chunk, c_block)
    return launch_scan(plan, x, dt, A, Bmat, Cmat, D,
                       return_state=return_state)


def launch_scan(plan: ScanPlan, x: torch.Tensor, dt: torch.Tensor,
                A: torch.Tensor, Bmat: torch.Tensor, Cmat: torch.Tensor,
                D: torch.Tensor, *, return_state: bool = False):
    """Launches the kernel on CUDA tensors with ``plan`` (from
    :func:`plan_scan`, or :func:`make_plan` for a sweep); returns y, or
    (y, h_final) with ``return_state``."""
    b, l, c = x.shape
    n = A.shape[1]
    if dt.shape != x.shape or A.shape != (c, n) or D.shape != (c,) \
            or Bmat.shape != (b, l, n) or Cmat.shape != (b, l, n):
        raise ValueError(
            f"selective_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, B {tuple(Bmat.shape)}, C {tuple(Cmat.shape)}, "
            f"D {tuple(D.shape)}")
    out_code = cuda_lib.dtype_code(x)
    xs, dts, bs, cs = cuda_lib.one_storage(x, dt, Bmat, Cmat)
    a32 = A.to(torch.float32).contiguous()
    d32 = D.to(torch.float32).contiguous()
    cuda_lib.require("selective_scan", xs, dts, bs, cs, a32, d32)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    h = None
    if return_state:  # an empty sequence leaves the state at zero
        h = torch.zeros((b, c, n), dtype=torch.float32, device=x.device) \
            if l == 0 else torch.empty((b, c, n), dtype=torch.float32,
                                       device=x.device)
    if y.numel() > 0:
        err = cuda_lib.library().repro_selective_scan(
            xs.data_ptr(), dts.data_ptr(), a32.data_ptr(), bs.data_ptr(),
            cs.data_ptr(), d32.data_ptr(), y.data_ptr(), b, l, c, n,
            plan.lanes, plan.channels, plan.chunk, cuda_lib.dtype_code(xs),
            out_code, None if h is None else h.data_ptr(),
            cuda_lib.stream_of(x))
        cuda_lib.check(err, "selective_scan")
        cuda_lib.LAUNCHES["selective_scan"] += 1
    return (y, h) if return_state else y
