"""Measurement backends for the kernel-launch tuning environment — the
port of :mod:`repro.envs.measure`, priced on the H100.

CAMEO's premise is that cheap source-environment measurements transfer to a
costly target.  This module supplies the source side of that pair for the
launch space, and the geometry the serving simulator prices with:

- :class:`AnalyticBackend` — the launch-geometry model: the launches each
  family's ``kernel.py::launch_records`` gives for the candidate, priced
  in waves over the card's SMs.  Fast and deterministic: the
  observational source.
- :class:`ShiftedAnalyticBackend` — the analytic model a fixed,
  reproducible distance away: composable :class:`EnvShift` perturbations
  (scaled hardware constants, workload-shape changes, heteroscedastic
  noise, a tightened shared-memory budget) build the paper's
  environmental-change target pairs on a CPU.  Named kinds live in
  ``SHIFT_KINDS`` and are selectable as ``shifted:<kind>``.
- :class:`WallClockBackend` — timed execution of the port's kernels under
  the candidate configuration: each family's representative inputs are
  dispatched through :func:`repro_torch.kernels.dispatch.dispatch` with
  the candidate installed exclusively, on the card by default (CUDA
  events around each call, median of k) or on the CPU (the plain
  versions, host clock) when asked.  Expensive and honest: the
  intervention target.

All satisfy the :class:`MeasurementBackend` protocol —
``measure(config) -> (counters, y)`` with latency in microseconds.
Selection: an explicit constructor argument wins, then the
``REPRO_MEASURE_BACKEND`` env var, then ``analytic``.

**What the names mean on this card.**  The field and counter names stay
the reference's (``mxu_flops_per_us``, ``vpu_flops_per_us``,
``vmem_limit``, ``launch_overhead_us``, ``grid_points``,
``vmem_peak_bytes``, the "vmem" infeasibility reason), because the
simulator reads them and a causal model learned over the reference's
counters must keep its variables.  On the H100: ``grid_points`` counts the
CUDA blocks a configuration launches; "vmem" is the static plus dynamic
shared memory of its largest block, and the budget it must fit is the
232,448 bytes one block may opt into; ``mxu`` is the tensor cores' bf16
rate, ``vpu`` the CUDA cores' fp32 rate; ``launch_overhead_us`` is charged
once a launch (not a block).  The geometry reads the launches off the
kernels' own plans (``plan_rmsnorm``, ``plan_decode_splits``,
``plan_scan``, ``ssd_route`` through each family's ``launch_records``),
counts their work with each family's ``launch_work``, and prices them
from data-sheet rates and latencies that ``chip_smoke.py`` phase 4d
measures on the card (:data:`LAUNCH_US`, :data:`CHAIN_LINK_US`,
:data:`SCAN_STEP_US`, and :data:`TILE_US`, a K/V tile's latency and an
SM's time a tile at each head dim and block shape of the prefill).

The timing harness (:func:`timeit`) takes an injectable clock so tests run
against a deterministic :class:`FakeClock` instead of ``perf_counter``.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field, replace
from typing import (Any, Callable, Dict, Iterable, List, Mapping,
                    Optional, Protocol, Sequence, Tuple, Union,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch.utils.hardware import (
    FP32_LANES_PER_SM, H100_SM_COUNT, H100_SMEM_PER_BLOCK, H100_SMEM_PER_SM,
    MAX_SM_BLOCKS, MAX_SM_THREADS, SFU_PER_SM, SMEM_RESERVED_PER_BLOCK)

MEASURE_BACKEND_ENV = "REPRO_MEASURE_BACKEND"
ANALYTIC = "analytic"
WALLCLOCK = "wallclock"
SHIFTED_PREFIX = "shifted:"

SMEM_LIMIT_BYTES = H100_SMEM_PER_BLOCK  # opt-in shared memory of one H100 block
# NVIDIA's data sheet, H100 SXM at 700 W: dense bf16 on the tensor cores,
# fp32 on the CUDA cores, HBM3 bandwidth, boost clock
TENSOR_FLOPS_PER_US = 989e6
CUDA_CORE_FLOPS_PER_US = 67e6
HBM_BYTES_PER_US = 3.35e6
SM_CLOCK_HZ = 1.98e9
#: fp32 operations one exponential takes the time of: an SM issues
#: FP32_LANES_PER_SM multiply-adds (two operations each) a clock and
#: SFU_PER_SM exponentials
EXP_FLOPS = 2 * FP32_LANES_PER_SM // SFU_PER_SM
# Measured on one H100 80GB HBM3 at 700 W by ``chip_smoke.py`` phase 4d
# (``measure_geometry_constants``; PERF.md lists each run's values), never
# fitted to a family:
#: one launch of the smallest block the port makes (RMSNorm of one row of
#: 8 elements) through WallClockBackend's CUDA-event timer
LAUNCH_US = 5.54
#: one link of an in-order chain: the slope of the tensor-core SSD's time
#: over its links on one (batch, head) pair
CHAIN_LINK_US = 4.21
#: one step of the Mamba-1 recurrence in a block: the slope of the scan's
#: time over the sequence on one block of one warp
SCAN_STEP_US = 0.0946
#: one K/V tile of the online softmax, by (head dim, q rows, kv rows) of
#: the tile: ``(latency, sm_us)``, the slope of the bf16 prefill's time over
#: the tiles its blocks walk, with one block on the card (a block's latency
#: a tile) and with every SM full of resident blocks (``sm_us`` is that
#: slope over the blocks an SM holds: an SM's time a tile when its blocks
#: contend)
TILE_US = {
    (16, 32, 32): (0.4174, 0.181), (16, 32, 64): (0.5951, 0.3038),
    (16, 64, 32): (0.4114, 0.1799), (16, 64, 64): (0.5637, 0.2766),
    (32, 32, 32): (0.5146, 0.1989), (32, 32, 64): (0.7371, 0.3704),
    (32, 64, 32): (0.4811, 0.2035), (32, 64, 64): (0.6797, 0.3733),
    (64, 32, 32): (0.7029, 0.2938), (64, 32, 64): (1.11, 0.5667),
    (64, 64, 32): (0.6314, 0.3008), (64, 64, 64): (0.9457, 0.6103),
    (80, 32, 32): (0.7083, 0.3797), (80, 32, 64): (1.559, 0.7685),
    (80, 64, 32): (0.6334, 0.3851), (80, 64, 64): (1.188, 0.8363),
    (128, 32, 32): (0.9746, 0.6225), (128, 32, 64): (1.874, 1.02),
    (128, 64, 32): (0.8314, 0.572), (128, 64, 64): (1.42, 1.402),
}
HOST_CALL_S = 5e-4                # a kernel call's host time, if unmeasured
SPIN_MIN_S, SPIN_MAX_S = 1e-3, 2e-2  # the spin ahead of a timed run

COUNTER_NAMES = ("grid_points", "vmem_peak_bytes", "hbm_bytes", "flops")


@dataclass(frozen=True)
class HardwareSpec:
    """The card the launch-geometry model prices on.

    The defaults are one H100 SXM's (data sheet, 700 W): ``mxu_flops_per_us``
    is the tensor cores' dense bf16 rate, ``vpu_flops_per_us`` the CUDA
    cores' fp32 rate (which also sets the exponentials' rate, one per
    :data:`EXP_FLOPS` fp32 operations), ``hbm_bytes_per_us`` the HBM
    bandwidth; the names are the reference's.  A shifted environment scales
    them (another card, a slow one)."""

    mxu_flops_per_us: float = TENSOR_FLOPS_PER_US
    vpu_flops_per_us: float = CUDA_CORE_FLOPS_PER_US
    hbm_bytes_per_us: float = HBM_BYTES_PER_US

    def scaled(self, mxu: float = 1.0, vpu: float = 1.0,
               hbm: float = 1.0) -> "HardwareSpec":
        if mxu == vpu == hbm == 1.0:
            return self
        return HardwareSpec(self.mxu_flops_per_us * mxu,
                            self.vpu_flops_per_us * vpu,
                            self.hbm_bytes_per_us * hbm)


@dataclass(frozen=True)
class KernelWorkload:
    """One (model shape x batch) cell the kernels run under: the tensors
    :class:`WallClockBackend` draws and :class:`LaunchGeometry` prices.
    ``vmem_limit`` is the shared memory a block must fit (default: the
    232,448 bytes one H100 block may opt into); ``launch_overhead_us`` the
    cost of one launch on the card (default: :data:`LAUNCH_US`, measured)."""

    name: str = "serve-8b"
    batch: int = 8
    seq_len: int = 4096
    heads: int = 32
    kv_heads: int = 8
    head_dim: int = 128
    d_model: int = 4096
    # mamba-1 surface
    channels: int = 8192
    scan_state: int = 16
    # mamba-2 surface
    ssm_heads: int = 64
    ssm_head_dim: int = 64
    ssm_state: int = 128
    vmem_limit: int = SMEM_LIMIT_BYTES
    launch_overhead_us: float = LAUNCH_US
    noise: float = 0.01


def family_params(family: str, config: Dict[str, Any]) -> Dict[str, Any]:
    """Per-family launch parameters out of a flat ``family.param`` config,
    falling back to the registry defaults for anything unspecified."""
    from repro_torch.kernels import dispatch

    fam = dispatch.get_family(family)
    out = {o.name: o.default for o in fam.launch_options}
    for o in fam.launch_options:
        key = f"{family}.{o.name}"
        if key in config:
            out[o.name] = config[key]
    return out


# --------------------------------------------------------------------------
# launch-geometry model
# --------------------------------------------------------------------------

def resident_blocks(record) -> int:
    """Blocks of ``record`` one SM holds at once, by their shared bytes
    (each with the runtime's reserved kilobyte) and threads."""
    by_smem = H100_SMEM_PER_SM // (record.smem + SMEM_RESERVED_PER_BLOCK)
    by_threads = MAX_SM_THREADS // max(record.threads, 1)
    return max(1, min(MAX_SM_BLOCKS, by_smem, by_threads))


class LaunchGeometry:
    """The launch-geometry model of the port's Hopper kernels.

    ``family_cost(family, params)`` returns ``(t_us, grid, vmem, flops,
    hbm)`` for one call of the family on the workload's tensors, the ones
    :class:`WallClockBackend` draws, in ``dtype`` (bf16 by default):

    - ``grid``: the blocks the family's ``launch_records`` launch for the
      parameters (the "grid points" of the reference's names);
    - ``vmem``: the largest block's static plus dynamic shared bytes;
    - ``flops`` / ``hbm``: the work itself, as the family's
      ``launch_work`` counts it — the arithmetic, and the compulsory
      device-memory bytes — whatever the launch;
    - ``t_us``: the launch costs ``launch_overhead_us``; its blocks run in
      waves over :data:`H100_SM_COUNT` SMs at the residency their shared
      bytes and threads allow, each wave the larger of its share of the
      compute (at the tensor-core or the CUDA-core rate, over the SMs it
      occupies), of the bytes (at the HBM rate) and of its serial steps
      (:meth:`serial_us`); an in-order chain (the SSD's, the split
      decode's combine) adds its links x :data:`CHAIN_LINK_US`, and
      widening copies their launches and bytes.

    Parameters snap into the kernels' domains inside ``launch_records``
    and ``launch_work``, so configurations that launch the same blocks
    price the same.
    """

    MODELS = ("flash_attention", "mamba_scan", "ssd", "rmsnorm",
              "paged_attention")

    def __init__(self, workload: KernelWorkload,
                 hardware: Optional[HardwareSpec] = None,
                 dtype: torch.dtype = torch.bfloat16):
        self.workload = workload
        self.hardware = hardware or HardwareSpec()
        self.dtype = dtype

    # -- what WallClockBackend launches -----------------------------------

    def shape(self, family: str) -> Dict[str, Any]:
        """The ``launch_records`` shape of ``family`` on the workload's
        tensors: a causal prefill of batch x seq_len; the scan and the SSD
        without states; RMSNorm over batch x seq_len rows; one paged decode
        step over slots of seq_len rows (its capacity comes from the launch
        parameters)."""
        w = self.workload
        g = max(w.heads // max(w.kv_heads, 1), 1)
        if family == "flash_attention":
            return dict(d=w.head_dim, dv=w.head_dim, g=g, causal=True,
                        decode=False, batch=w.batch, kv_heads=w.kv_heads,
                        sq=w.seq_len, skv=w.seq_len)
        if family == "mamba_scan":
            return dict(batch=w.batch, len=w.seq_len, channels=w.channels,
                        n=w.scan_state, return_state=False)
        if family == "ssd":
            return dict(batch=w.batch, len=w.seq_len, heads=w.ssm_heads,
                        p=w.ssm_head_dim, groups=1, n=w.ssm_state,
                        states=False)
        if family == "rmsnorm":
            return dict(rows=w.batch * w.seq_len, dim=w.d_model)
        if family == "paged_attention":
            return dict(batch=w.batch, kv_heads=w.kv_heads, g=g,
                        d=w.head_dim, lens=[w.seq_len] * w.batch)
        raise KeyError(
            f"no launch-geometry model for family {family!r}; "
            f"modeled: {sorted(self.MODELS)}")

    def record(self, family: str, params: Dict[str, Any]):
        """The one launch (``cuda_lib.LaunchRecord``) a call makes."""
        # dt comes in fp32 (models/ssm.py): the scan's wrapper widens x, B
        # and C to one fp32 storage (``storage_size``), y in x's dtype
        dt = {"dt_dtype": torch.float32} if family == "mamba_scan" else {}
        (record,) = _kernel_module(family).launch_records(
            self.shape(family), self.dtype, **params, **dt)
        return record

    def work(self, family: str, params: Dict[str, Any]):
        """The family's ``launch_work`` (``cuda_lib.LaunchWork``) on the
        workload: its arithmetic, compulsory bytes and serial parts (dt in
        fp32 for the scan and the SSD, as the backend draws it)."""
        dt = ({"dt_dtype": torch.float32}
              if family in ("mamba_scan", "ssd") else {})
        (work,) = _kernel_module(family).launch_work(
            self.shape(family), self.dtype, **params, **dt)
        return work

    @staticmethod
    def step_us(work) -> Tuple[float, float]:
        """``(latency, sm_us)`` of one serial step of ``work``: a K/V tile
        from :data:`TILE_US` at the smallest measured head dim at or above
        the tile's (the largest where none is), a scan time step
        :data:`SCAN_STEP_US` (the SM's throughput left to the compute)."""
        if work.tile is None:
            return SCAN_STEP_US, 0.0
        d, _, qb, kb = work.tile
        dims = sorted({k[0] for k in TILE_US})
        dim = next((x for x in dims if x >= d), dims[-1])
        return TILE_US[(dim, qb, kb)]

    @staticmethod
    def serial_us(steps: np.ndarray, latency: float, sm_us: float) -> float:
        """One wave's serial time: its blocks dealt out over the SMs in
        launch order; on each SM a block takes a step in ``latency``, or in
        ``sm_us`` x the blocks still walking where the SM's throughput
        holds them back; the slowest SM."""
        k = len(steps)
        sms = min(H100_SM_COUNT, k)
        rounds = -(-k // sms)
        dealt = np.zeros(rounds * sms)
        dealt[:k] = steps
        per_sm = -np.sort(-dealt.reshape(rounds, sms), axis=0)
        after = np.vstack([per_sm[1:], np.zeros((1, sms))])
        rate = np.maximum(latency, np.arange(1, rounds + 1) * sm_us)
        return float(((per_sm - after) * rate[:, None]).sum(axis=0).max())

    def launch_us(self, record, work) -> float:
        """The call's time: the launch's overhead, its waves of resident
        blocks (each the larger of its compute, its bytes and its serial
        steps), its chain's links, and any widening copies."""
        hw = self.hardware
        blocks = math.prod(record.grid)
        slots = H100_SM_COUNT * resident_blocks(record)
        if work.tensor:
            compute = (work.flops / hw.mxu_flops_per_us
                       + work.exps * EXP_FLOPS / hw.vpu_flops_per_us)
        else:
            compute = ((work.flops + work.exps * EXP_FLOPS)
                       / hw.vpu_flops_per_us)
        nbytes = work.hbm / hw.hbm_bytes_per_us
        latency, sm_us = (self.step_us(work) if work.steps is not None
                          else (0.0, 0.0))
        t = 0.0
        for first in range(0, blocks, slots):
            k = min(slots, blocks - first)
            frac = k / blocks
            # the scheduler deals a wave's blocks out over the SMs
            sms = min(H100_SM_COUNT, k)
            serial = (self.serial_us(work.steps[first:first + k], latency,
                                     sm_us)
                      if work.steps is not None else 0.0)
            t += max(compute * frac * H100_SM_COUNT / sms, nbytes * frac,
                     serial)
        return ((1 + work.copies) * self.workload.launch_overhead_us
                + work.copy_bytes / hw.hbm_bytes_per_us + t
                + work.links * CHAIN_LINK_US)

    def family_cost(self, family: str, params: Dict[str, Any]
                    ) -> Tuple[float, float, float, float, float]:
        if family not in self.MODELS:
            raise KeyError(
                f"no launch-geometry model for family {family!r}; "
                f"modeled: {sorted(self.MODELS)}")
        record = self.record(family, params)
        work = self.work(family, params)
        return (self.launch_us(record, work), float(math.prod(record.grid)),
                float(record.smem), float(work.flops), float(work.hbm))

    def totals(self, families: Sequence[str], config: Dict[str, Any]
               ) -> Tuple[Dict[str, float], float, bool]:
        """Summed counters, total modeled latency, and shared-memory
        feasibility over ``families`` (evaluated in the given order — keep
        it sorted for reproducible accumulation)."""
        total_us, grid_pts, vmem_peak, flops, hbm = 0.0, 0.0, 0.0, 0.0, 0.0
        feasible = True
        for family in families:
            t, grid, vmem, fl, hb = self.family_cost(
                family, family_params(family, config))
            total_us += t
            grid_pts += grid
            vmem_peak = max(vmem_peak, vmem)
            flops += fl
            hbm += hb
            if vmem > self.workload.vmem_limit:
                feasible = False
        counters = {"grid_points": grid_pts, "vmem_peak_bytes": vmem_peak,
                    "hbm_bytes": hbm, "flops": flops}
        return counters, total_us, feasible


def _kernel_module(family: str):
    import importlib

    return importlib.import_module(f"repro_torch.kernels.{family}.kernel")


def modeled_families() -> Tuple[str, ...]:
    return LaunchGeometry.MODELS


# --------------------------------------------------------------------------
# environment shifts
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class EnvShift:
    """One composable, deterministic perturbation of the analytic
    environment — the paper's environmental-change axes instantiated for the
    launch space.  A shift rewrites the (workload, hardware) pair the
    geometry model prices with:

    - hardware: scale the peak rates and the launch overhead (a different
      card);
    - workload: scale/override the workload shape (a different serving
      assignment);
    - feasibility: scale the shared-memory budget a block must fit
      (tightened -> launches with larger blocks become infeasible in the
      target);
    - noise: scale the multiplicative measurement noise and/or add a
      heteroscedastic component that grows with modeled latency;
    - fleet: scale the device count (elastic resize) and/or slow a fraction
      of devices down (stragglers).  The fleet fields are consumed by
      fleet-aware environments (``repro_torch.envs.serving_env`` derives a
      ``FleetSpec`` from them); :meth:`apply` only rewrites the
      (workload, hardware) pair, so non-fleet backends see a shift kind's
      *aggregate* effect through the base scales.

    Shifts compose left-to-right: scales multiply, absolute
    ``workload_update`` overrides win over earlier scales.
    """

    name: str = "shift"
    mxu_scale: float = 1.0
    vpu_scale: float = 1.0
    hbm_scale: float = 1.0
    launch_overhead_scale: float = 1.0
    vmem_scale: float = 1.0
    seq_scale: float = 1.0
    batch_scale: float = 1.0
    workload_update: Mapping[str, Any] = field(default_factory=dict)
    noise_scale: float = 1.0
    hetero_noise: float = 0.0
    # fleet-disruption axes (consumed by fleet-aware serving environments)
    device_scale: float = 1.0        # elastic resize: scales the device count
    straggler_frac: float = 0.0      # fraction of devices running slow
    straggler_slowdown: float = 1.0  # how slow the straggling devices are

    def apply(self, workload: KernelWorkload, hardware: HardwareSpec
              ) -> Tuple[KernelWorkload, HardwareSpec]:
        w = workload
        if self.seq_scale != 1.0:
            w = replace(w, seq_len=max(1, int(w.seq_len * self.seq_scale)))
        if self.batch_scale != 1.0:
            w = replace(w, batch=max(1, int(w.batch * self.batch_scale)))
        if self.vmem_scale != 1.0:
            w = replace(w, vmem_limit=max(1, int(w.vmem_limit * self.vmem_scale)))
        if self.launch_overhead_scale != 1.0:
            w = replace(w, launch_overhead_us=w.launch_overhead_us
                        * self.launch_overhead_scale)
        if self.noise_scale != 1.0:
            w = replace(w, noise=w.noise * self.noise_scale)
        if self.workload_update:
            w = replace(w, **dict(self.workload_update))
        return w, hardware.scaled(self.mxu_scale, self.vpu_scale,
                                  self.hbm_scale)


_HARDWARE_SHIFT = EnvShift(name="hardware", mxu_scale=0.5, hbm_scale=0.6,
                           launch_overhead_scale=2.0)
_WORKLOAD_SHIFT = EnvShift(name="workload", seq_scale=2.0, batch_scale=0.5)
_NOISE_SHIFT = EnvShift(name="noise", noise_scale=4.0, hetero_noise=0.05)
_FEASIBILITY_SHIFT = EnvShift(name="feasibility", vmem_scale=0.5)
# stragglers: a quarter of the devices run 3x slow.  Fleet-aware envs place
# them on the device grid; the base scales model the aggregate drag (slower
# effective memory, contention-inflated launch overhead) so the kernel-grid
# backends shift too.
_STRAGGLER_SHIFT = EnvShift(name="straggler", hbm_scale=0.8,
                            launch_overhead_scale=1.5, straggler_frac=0.25,
                            straggler_slowdown=3.0)
# elastic resize: a quarter of the fleet is preempted and the surviving
# devices absorb the traffic (larger effective batch per replica)
_RESIZE_SHIFT = EnvShift(name="resize", batch_scale=1.5, device_scale=0.75)

SHIFT_KINDS: Dict[str, Tuple[EnvShift, ...]] = {
    "hardware": (_HARDWARE_SHIFT,),
    "workload": (_WORKLOAD_SHIFT,),
    "noise": (_NOISE_SHIFT,),
    "feasibility": (_FEASIBILITY_SHIFT,),
    "severe": (_HARDWARE_SHIFT, _WORKLOAD_SHIFT, _FEASIBILITY_SHIFT,
               _NOISE_SHIFT),
    "straggler": (_STRAGGLER_SHIFT,),
    "resize": (_RESIZE_SHIFT,),
}


def shift_kinds() -> Tuple[str, ...]:
    return tuple(SHIFT_KINDS)


def shifts_for(kind: str) -> Tuple[EnvShift, ...]:
    if kind not in SHIFT_KINDS:
        raise ValueError(
            f"unknown shift kind {kind!r}; known: {sorted(SHIFT_KINDS)}")
    return SHIFT_KINDS[kind]


def _check_modeled(families: Tuple[str, ...]) -> None:
    unmodeled = [f for f in families if f not in LaunchGeometry.MODELS]
    if unmodeled:
        raise ValueError(
            f"no launch-geometry model for families {unmodeled}; "
            f"modeled: {sorted(LaunchGeometry.MODELS)}")


# --------------------------------------------------------------------------
# timing harness
# --------------------------------------------------------------------------

class FakeClock:
    """Deterministic clock for tests: each call returns the previous time
    advanced by the next scripted delta (seconds), cycling when exhausted."""

    def __init__(self, deltas: Sequence[float] = (1e-3,), start: float = 0.0):
        if not deltas:
            raise ValueError("FakeClock needs at least one delta")
        self.deltas = tuple(float(d) for d in deltas)
        self.now = float(start)
        self.calls = 0

    def __call__(self) -> float:
        t = self.now
        self.now += self.deltas[self.calls % len(self.deltas)]
        self.calls += 1
        return t


@dataclass(frozen=True)
class TimingResult:
    """Samples from one timed measurement, all in microseconds."""

    samples_us: Tuple[float, ...]
    warmup_us: Tuple[float, ...] = ()

    @property
    def median_us(self) -> float:
        return float(np.median(self.samples_us))

    @property
    def best_us(self) -> float:
        return float(min(self.samples_us))

    @property
    def mean_us(self) -> float:
        return float(np.mean(self.samples_us))


def _block_until_ready(out: Any) -> None:
    """Synchronize every CUDA device a tensor of ``out`` (nested tuples,
    lists and dicts) lives on."""
    stack, devices = [out], set()
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    for dev in devices:
        torch.cuda.synchronize(dev)


def timeit(fn: Callable[[], Any], *, warmup: int = 2, repeats: int = 5,
           clock: Optional[Callable[[], float]] = None,
           block: bool = True) -> TimingResult:
    """Time ``fn`` (a thunk): ``warmup`` discarded runs, then ``repeats``
    measured ones.  Each run is bracketed by ``clock()`` and, when ``block``,
    waits for the CUDA devices its output lives on (the counterpart of
    ``jax.block_until_ready``), so queued kernels do not leak into the next
    sample.  Returns all samples; callers take ``median_us`` (robust to
    scheduler noise)."""
    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    clock = clock or time.perf_counter

    def one() -> float:
        t0 = clock()
        out = fn()
        if block:
            _block_until_ready(out)
        return (clock() - t0) * 1e6

    warm = tuple(one() for _ in range(warmup))
    samples = tuple(one() for _ in range(repeats))
    return TimingResult(samples, warm)


# --------------------------------------------------------------------------
# backends
# --------------------------------------------------------------------------

@runtime_checkable
class MeasurementBackend(Protocol):
    """What the kernel-launch environment needs from a measurement source.

    ``measure`` maps a flat ``{"family.param": value}`` launch configuration
    to ``(counters, y)``: the system-event counters (the paper's C) and the
    latency objective in microseconds (``inf`` = infeasible).
    """

    counter_names: Tuple[str, ...]
    families: Tuple[str, ...]

    def measure(self, config: Dict[str, Any]
                ) -> Tuple[Dict[str, float], float]: ...

    def measure_batch(self, configs: Sequence[Dict[str, Any]]
                      ) -> List[Tuple[Dict[str, float], float]]: ...


class AnalyticBackend:
    """The launch-geometry model as a measurement backend.

    The reference's backend, draw for draw: same accumulation order over
    sorted families, the same shared-memory ("vmem") gate, and the
    multiplicative noise draw is taken from ``default_rng(seed + 13)`` only
    for feasible configurations.
    """

    counter_names = COUNTER_NAMES

    def __init__(self, workload: KernelWorkload, families: Iterable[str],
                 seed: int = 0, *, hardware: Optional[HardwareSpec] = None):
        self.workload = workload
        self.families = tuple(sorted(families))
        _check_modeled(self.families)
        self.hardware = hardware or HardwareSpec()
        self.geometry = LaunchGeometry(workload, self.hardware)
        self._noise_rng = np.random.default_rng(seed + 13)

    def _sigma(self, total_us: float) -> float:
        """Relative noise scale for one measurement (constant here; the
        shifted backend makes it latency-dependent)."""
        return self.workload.noise

    def measure(self, config: Dict[str, Any]) -> Tuple[Dict[str, float], float]:
        counters, total_us, feasible = self.geometry.totals(
            self.families, config)
        if not feasible:
            return counters, float("inf")
        y = total_us * (1.0 + self._sigma(total_us)
                        * float(self._noise_rng.standard_normal()))
        return counters, y

    def measure_batch(self, configs: Sequence[Dict[str, Any]]
                      ) -> List[Tuple[Dict[str, float], float]]:
        """Vectorized q-batch: one geometry pass per member, ONE noise draw
        for all feasible members.  ``Generator.standard_normal(n)`` fills
        arrays from the same stream as n scalar draws, so the results are
        bit-identical to sequential :meth:`measure` calls in order —
        infeasible members draw nothing, exactly like the scalar path."""
        metas = [self.geometry.totals(self.families, c) for c in configs]
        n_feasible = sum(1 for _, _, feasible in metas if feasible)
        noise = (self._noise_rng.standard_normal(n_feasible)
                 if n_feasible else np.empty(0))
        out: List[Tuple[Dict[str, float], float]] = []
        j = 0
        for counters, total_us, feasible in metas:
            if not feasible:
                out.append((counters, float("inf")))
                continue
            y = total_us * (1.0 + self._sigma(total_us) * float(noise[j]))
            j += 1
            out.append((counters, y))
        return out


class ShiftedAnalyticBackend(AnalyticBackend):
    """An analytic target environment a fixed distance from the source.

    ``shifts`` (a shift-kind name or a sequence of :class:`EnvShift`) are
    composed onto the base workload and the default :class:`HardwareSpec`,
    and the geometry model prices against the shifted pair.  Everything is
    seeded and CPU-cheap, so source→target fidelity gaps (the paper's
    environmental changes) are reproducible in CI.

    ``hardware`` is the unshifted card (default: one H100 SXM); the parity
    tests pass the reference's constants.

    Heteroscedastic noise: a shift's ``hetero_noise`` adds a latency-
    dependent component ``hetero * t / (t + HETERO_PIVOT_US)`` to the
    relative noise — slow configurations measure noisier than fast ones, so
    the target's noise floor is configuration-dependent (unlike the source).
    """

    HETERO_PIVOT_US = 1e4

    def __init__(self, workload: KernelWorkload, families: Iterable[str],
                 seed: int = 0, *,
                 shifts: Union[str, Sequence[EnvShift]] = (),
                 hardware: Optional[HardwareSpec] = None):
        if isinstance(shifts, str):
            shifts = shifts_for(shifts)
        self.shifts = tuple(shifts)
        self.base_workload = workload
        shifted, hardware = workload, hardware or HardwareSpec()
        for s in self.shifts:
            shifted, hardware = s.apply(shifted, hardware)
        super().__init__(shifted, families, seed, hardware=hardware)
        self._hetero = float(sum(s.hetero_noise for s in self.shifts))

    @property
    def shift_names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.shifts)

    def _sigma(self, total_us: float) -> float:
        return (self.workload.noise + self._hetero
                * total_us / (total_us + self.HETERO_PIVOT_US))


class WallClockBackend:
    """Timed execution of the port's kernels under the candidate config.

    Each family's representative inputs are the reference's shapes, drawn
    from ``default_rng(seed)`` in the reference's order, and go to
    ``device`` (default ``cuda``, which raises without a card) in the
    dtypes the port's serve and train paths hand that kernel: ``dtype``
    activations (default bf16) with the fp32 ``A``, ``D`` and ``dt`` that
    ``models/ssm.py`` passes.  Every call goes through the generic router
    inside ``use_launch_config({family: params}, exclusive=True)``, so the
    candidate outranks any configuration active around the measurement.

    Timing: with no ``clock``, on the card, each call is bracketed by a
    pair of CUDA events — ``warmup`` discarded calls, ``repeats`` timed
    ones queued behind a spin kernel (so the events bracket the kernel, not
    the host's launch latency), one synchronize, the median elapsed time.
    The inputs stay in L2 between calls.  With a ``clock`` (the
    reference's :class:`FakeClock` contract), or on the CPU, the
    host-clock :func:`timeit` path runs unchanged.  Counters and the
    shared-memory gate come from the geometry model in ``dtype``, which
    prices exactly these inputs; an infeasible configuration returns
    ``inf`` without launching.

    When the obs tracer is active each measurement exports a ``measure``
    span on the env track with its config, ``y`` and per-family times (and
    the first an ``inputs`` span for building the inputs).
    """

    counter_names = COUNTER_NAMES

    def __init__(self, workload: KernelWorkload, families: Iterable[str],
                 seed: int = 0, *, device: Any = None,
                 dtype: Optional[torch.dtype] = None, warmup: int = 1,
                 repeats: int = 3,
                 clock: Optional[Callable[[], float]] = None):
        from repro_torch.utils.device import resolve_device

        self.workload = workload
        self.families = tuple(sorted(families))
        _check_modeled(self.families)
        self.device = resolve_device(device)
        self.dtype = dtype or torch.bfloat16
        self.geometry = LaunchGeometry(workload, dtype=self.dtype)
        self.warmup = warmup
        self.repeats = repeats
        self.clock = clock
        self._input_rng = np.random.default_rng(seed)
        self._inputs: Dict[str, Tuple[torch.Tensor, ...]] = {}

    # -- representative inputs ------------------------------------------

    def _build_inputs(self, family: str) -> Tuple[torch.Tensor, ...]:
        w, rng = self.workload, self._input_rng
        f32 = torch.float32

        def draw(*shape):
            return rng.normal(size=shape).astype(np.float32)

        def put(a, dtype):
            return torch.as_tensor(a).to(device=self.device, dtype=dtype)

        if family == "flash_attention":
            return (put(draw(w.batch, w.seq_len, w.heads, w.head_dim),
                        self.dtype),
                    put(draw(w.batch, w.seq_len, w.kv_heads, w.head_dim),
                        self.dtype),
                    put(draw(w.batch, w.seq_len, w.kv_heads, w.head_dim),
                        self.dtype))
        if family == "mamba_scan":
            x = draw(w.batch, w.seq_len, w.channels)
            dt = np.abs(draw(w.batch, w.seq_len, w.channels)) * 0.05
            A = -np.abs(draw(w.channels, w.scan_state))
            B = draw(w.batch, w.seq_len, w.scan_state)
            C = draw(w.batch, w.seq_len, w.scan_state)
            D = np.ones((w.channels,), np.float32)
            return (put(x, self.dtype), put(dt, f32), put(A, f32),
                    put(B, self.dtype), put(C, self.dtype), put(D, f32))
        if family == "ssd":
            x = draw(w.batch, w.seq_len, w.ssm_heads, w.ssm_head_dim)
            dt = np.abs(draw(w.batch, w.seq_len, w.ssm_heads)) * 0.05
            A = -np.abs(draw(w.ssm_heads))
            B = draw(w.batch, w.seq_len, 1, w.ssm_state)
            C = draw(w.batch, w.seq_len, 1, w.ssm_state)
            D = np.ones((w.ssm_heads,), np.float32)
            return (put(x, self.dtype), put(dt, f32), put(A, f32),
                    put(B, self.dtype), put(C, self.dtype), put(D, f32))
        if family == "rmsnorm":
            return (put(draw(w.batch, w.seq_len, w.d_model), self.dtype),
                    put(draw(w.d_model), self.dtype))
        if family == "paged_attention":
            # the pool's shape is the candidate's page_size: there are no
            # config-independent inputs; the replay environment (a real
            # batcher) measures paged decode
            raise KeyError(
                "paged_attention has no config-independent representative "
                "inputs (the KV pool shape IS the launch config); measure "
                "it through ReplayServingEnv instead")
        raise KeyError(f"no representative workload for family {family!r}")

    def inputs(self, family: str) -> Tuple[torch.Tensor, ...]:
        """The family's representative inputs, built on first use."""
        if family not in self._inputs:
            self._inputs[family] = self._build_inputs(family)
        return self._inputs[family]

    def call(self, family: str, params: Dict[str, Any]) -> torch.Tensor:
        """One call of ``family`` on its inputs with exactly ``params``
        installed."""
        from repro_torch.kernels import dispatch

        args = self.inputs(family)
        with dispatch.use_launch_config({family: dict(params)},
                                        exclusive=True):
            return dispatch.dispatch(family, *args)

    def _time_us(self, fn: Callable[[], Any]) -> float:
        if self.clock is not None or self.device.type != "cuda":
            return timeit(fn, warmup=self.warmup, repeats=self.repeats,
                          clock=self.clock).median_us
        host_s = HOST_CALL_S
        for i in range(self.warmup):
            if i == self.warmup - 1:
                torch.cuda.synchronize(self.device)
                # repro: ignore[wall-clock] -- the host's enqueue time of one call sizes the spin below; no result is timed by it
                t0 = time.perf_counter()
            fn()
        if self.warmup:
            # repro: ignore[wall-clock] -- the host's enqueue time of one call sizes the spin below; no result is timed by it
            host_s = time.perf_counter() - t0
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(self.repeats)]
        # hold the card busy while the host queues every timed call, so
        # each pair of events brackets the kernel and not the host's
        # launch latency (0.1-0.5 ms a call through Python on an H100
        # host); capped, since a first call's host time includes lazy
        # set-up
        spin_s = min(max(4.0 * host_s * self.repeats, SPIN_MIN_S),
                     SPIN_MAX_S)
        torch.cuda._sleep(int(spin_s * SM_CLOCK_HZ))
        for start, end in events:
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize(self.device)
        return float(np.median([s.elapsed_time(e) * 1e3
                                for s, e in events]))

    # -- MeasurementBackend ---------------------------------------------

    def measure(self, config: Dict[str, Any]) -> Tuple[Dict[str, float], float]:
        from repro_torch.obs import trace as obs_trace

        counters, _, feasible = self.geometry.totals(self.families, config)
        if not feasible:
            return counters, float("inf")
        missing = [f for f in self.families if f not in self._inputs]
        if missing:
            with obs_trace.span("inputs", cat="env",
                                track=obs_trace.TRACK_ENV, families=missing):
                for family in missing:
                    self.inputs(family)
        with obs_trace.span("measure", cat="env",
                            track=obs_trace.TRACK_ENV,
                            backend=WALLCLOCK) as span:
            per_family = {}
            with torch.no_grad():
                for family in self.families:
                    params = family_params(family, config)
                    per_family[family] = self._time_us(
                        lambda: self.call(family, params))
            total_us = float(sum(per_family[f] for f in self.families))
            span.set(config=dict(config), y=total_us, family_us=per_family)
        return counters, total_us

    def measure_batch(self, configs: Sequence[Dict[str, Any]]
                      ) -> List[Tuple[Dict[str, float], float]]:
        """Measures once per distinct tuple of launch parameters: members
        with identical parameters share one timed measurement."""
        out: List[Tuple[Dict[str, float], float]] = []
        shared: Dict[tuple, Tuple[Dict[str, float], float]] = {}
        for config in configs:
            key = tuple((f, tuple(sorted(family_params(f, config).items())))
                        for f in self.families)
            if key not in shared:
                shared[key] = self.measure(config)
            out.append(shared[key])
        return out


# --------------------------------------------------------------------------
# selection
# --------------------------------------------------------------------------

#: name -> backend class; :func:`register_backend` extends it.  The
#: ``shifted:<kind>`` family is prefix-routed on top of these keys.
BACKEND_FACTORIES: Dict[str, Callable[..., MeasurementBackend]] = {
    ANALYTIC: AnalyticBackend,
    WALLCLOCK: WallClockBackend,
}


def register_backend(name: str,
                     factory: Callable[..., MeasurementBackend]) -> None:
    """Register a backend class under ``name`` — it becomes selectable
    everywhere a backend name is accepted (constructor args, CLI flags, the
    ``REPRO_MEASURE_BACKEND`` env var)."""
    if name in BACKEND_FACTORIES or name.startswith(SHIFTED_PREFIX):
        raise ValueError(f"measurement backend {name!r} already registered")
    BACKEND_FACTORIES[name] = factory


def backend_names() -> Tuple[str, ...]:
    """Every valid backend spelling: registry keys plus the registered
    ``shifted:<kind>`` forms."""
    return tuple(sorted(BACKEND_FACTORIES)
                 + [SHIFTED_PREFIX + k for k in sorted(SHIFT_KINDS)])


def resolve_backend_name(explicit: Optional[str] = None) -> str:
    """Backend precedence: explicit argument > env var > analytic.

    ``shifted:<kind>`` (e.g. ``shifted:hardware``) names a
    :class:`ShiftedAnalyticBackend` with that registered shift kind, so an
    environment-shifted target is selectable through the same
    ``REPRO_MEASURE_BACKEND`` plumbing as the real backends.  Unknown names
    (including unknown shift kinds) raise ``ValueError`` carrying the full
    list of valid spellings."""
    name = explicit or os.environ.get(MEASURE_BACKEND_ENV, "") or ANALYTIC
    if name.startswith(SHIFTED_PREFIX):
        kind = name[len(SHIFTED_PREFIX):]
        if kind in SHIFT_KINDS:
            return name
    elif name in BACKEND_FACTORIES:
        return name
    source = "argument" if explicit else f"{MEASURE_BACKEND_ENV} env var"
    raise ValueError(
        f"unknown measurement backend {name!r} (from {source}); "
        f"valid: {list(backend_names())}")


def make_backend(name: Optional[str], workload: KernelWorkload,
                 families: Iterable[str], seed: int = 0,
                 **kw: Any) -> MeasurementBackend:
    """Instantiate a backend by name (``None`` -> env var -> analytic).
    Keyword arguments are forwarded to the backend constructor."""
    resolved = resolve_backend_name(name)
    if resolved.startswith(SHIFTED_PREFIX):
        return ShiftedAnalyticBackend(
            workload, families, seed,
            shifts=resolved[len(SHIFTED_PREFIX):], **kw)
    return BACKEND_FACTORIES[resolved](workload, families, seed, **kw)
