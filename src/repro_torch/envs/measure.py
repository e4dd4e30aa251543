"""Measurement backends for the kernel-launch tuning environment — the
port of :mod:`repro.envs.measure`, with the H100's constants.

CAMEO's premise is that cheap source-environment measurements transfer to a
costly target.  This module supplies the source side of that pair for the
launch space, and the geometry the serving simulator prices with:

- :class:`AnalyticBackend` — the launch-geometry model (grid extent, block
  footprints, streamed bytes, per-launch overhead).  Fast and
  deterministic: the observational source.
- :class:`ShiftedAnalyticBackend` — the analytic model a fixed,
  reproducible distance away: composable :class:`EnvShift` perturbations
  (scaled hardware constants, workload-shape changes, heteroscedastic
  noise, a tightened footprint budget) build the paper's
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

**The card's constants.**  :class:`HardwareSpec` and
:class:`KernelWorkload` default to one H100 SXM: 989 TFLOP/s bf16 on the
tensor cores, 67 TFLOP/s fp32 on the CUDA cores, 3.35 TB/s of HBM, and
232,448 bytes of shared memory a block may opt into.  The field and
counter names stay the reference's (``mxu_flops_per_us``,
``vpu_flops_per_us``, ``vmem_limit``, ``vmem_peak_bytes``, the "vmem"
infeasibility reason), because the simulator reads them and a causal model
learned over the reference's counters must transfer; each docstring says
what the name means on this card.  :class:`LaunchGeometry`'s formulae are
the reference's: a footprint read off the Hopper kernels' own plans
(``plan_rmsnorm``, ``plan_decode_splits``, ``plan_scan``, ``ssd_route``)
is a later item.

The timing harness (:func:`timeit`) takes an injectable clock so tests run
against a deterministic :class:`FakeClock` instead of ``perf_counter``.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field, replace
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Protocol, Sequence, Tuple, Union, runtime_checkable)

import numpy as np
import torch

from repro_torch.utils.hardware import H100_SMEM_PER_BLOCK

MEASURE_BACKEND_ENV = "REPRO_MEASURE_BACKEND"
ANALYTIC = "analytic"
WALLCLOCK = "wallclock"
SHIFTED_PREFIX = "shifted:"

LANE = 128                        # tile edge the geometry's utilization uses
SMEM_LIMIT_BYTES = H100_SMEM_PER_BLOCK  # opt-in shared memory of one H100 block
TENSOR_FLOPS_PER_US = 989e6       # H100 SXM bf16 dense tensor cores
CUDA_CORE_FLOPS_PER_US = 67e6     # H100 SXM fp32 on the CUDA cores
HBM_BYTES_PER_US = 3.35e6         # H100 SXM HBM3, 3.35 TB/s
SM_CLOCK_HZ = 1.98e9              # H100 SXM boost clock (spin lengths)
HOST_CALL_S = 5e-4                # a kernel call's host time, if unmeasured
SPIN_MIN_S, SPIN_MAX_S = 1e-3, 2e-2  # the spin ahead of a timed run
F32 = 4                           # scratch accumulators
BF16 = 2                          # streamed in/out blocks

COUNTER_NAMES = ("grid_points", "vmem_peak_bytes", "hbm_bytes", "flops")


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _padded(a: int, b: int) -> int:
    return _ceil_div(a, b) * b


def _mxu_util(*block_dims: int) -> float:
    """Fraction of the matrix unit a tile fills: 1.0 at >= 128 a side (the
    reference's rule, kept for the simulator's parity)."""
    u = 1.0
    for d in block_dims:
        u *= min(d, LANE) / LANE
    return max(u, 1e-3)


@dataclass(frozen=True)
class HardwareSpec:
    """The hardware constants the launch-geometry model prices with.

    The defaults are one H100 SXM's: ``mxu_flops_per_us`` is the bf16
    dense rate of the tensor cores, ``vpu_flops_per_us`` the fp32 rate of
    the CUDA cores, ``hbm_bytes_per_us`` the HBM bandwidth (the names are
    the reference's).  A shifted environment scales them (another card)."""

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
    """One (model shape x batch) cell the kernels run under.  ``vmem_limit``
    is the on-chip footprint budget a launch must fit (default: the shared
    memory one H100 block may hold)."""

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
    launch_overhead_us: float = 1.5
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

class LaunchGeometry:
    """Analytic cost model of one kernel launch per family.

    Each ``<family>(params)`` returns ``(t_us, grid, vmem, flops, hbm)`` —
    modeled latency, grid points, on-chip footprint of the blocks (the
    "vmem" of the reference's names), total FLOPs, and streamed HBM bytes —
    from the launch parameters, by the reference's formulae.  ``hardware``
    supplies the peak rates (default: one H100 SXM).
    """

    def __init__(self, workload: KernelWorkload,
                 hardware: Optional[HardwareSpec] = None):
        self.workload = workload
        self.hardware = hardware or HardwareSpec()

    def flash_attention(self, p) -> Tuple[float, float, float, float, float]:
        w = self.workload
        qb, kb = int(p["q_block"]), int(p["kv_block"])
        sq, sk = _padded(w.seq_len, qb), _padded(w.seq_len, kb)
        grid = w.batch * w.heads * (sq // qb) * (sk // kb)
        # causal: roughly half the kv blocks are visible
        flops = 0.5 * w.batch * w.heads * sq * sk * 4 * w.head_dim
        vmem = (BF16 * 2 * (qb + 2 * kb) * w.head_dim         # double-buffered in
                + BF16 * 2 * qb * w.head_dim                  # out
                + F32 * qb * (w.head_dim + 2 * LANE))         # acc/m/l scratch
        hbm = F32 * grid * (qb + 2 * kb) * w.head_dim / 2 + F32 * sq * w.head_dim
        t = (grid * w.launch_overhead_us
             + flops / (self.hardware.mxu_flops_per_us * _mxu_util(qb, kb))
             + hbm / self.hardware.hbm_bytes_per_us)
        return t, grid, vmem, flops, hbm

    def mamba_scan(self, p) -> Tuple[float, float, float, float, float]:
        w = self.workload
        chunk, cb = int(p["chunk"]), int(p["c_block"])
        l = _padded(w.seq_len, chunk)
        grid = w.batch * _ceil_div(w.channels, cb) * (l // chunk)
        flops = 8.0 * w.batch * l * w.channels * w.scan_state
        vmem = (BF16 * 2 * chunk * (3 * cb + 2 * w.scan_state)  # in, dbl-buffered
                + BF16 * 2 * chunk * cb                          # out
                + F32 * cb * w.scan_state)                       # state scratch
        hbm = F32 * w.batch * l * (3 * w.channels + 2 * w.scan_state)
        # the recurrence is serial inside a chunk: VPU-bound step chain
        serial = grid * chunk * (cb * w.scan_state
                                 / self.hardware.vpu_flops_per_us) * 1e-3
        t = (grid * w.launch_overhead_us + serial
             + hbm / self.hardware.hbm_bytes_per_us)
        return t, grid, vmem, flops, hbm

    def ssd(self, p) -> Tuple[float, float, float, float, float]:
        w = self.workload
        chunk = int(p["chunk"])
        l = _padded(w.seq_len, chunk)
        grid = w.batch * w.ssm_heads * (l // chunk)
        n, hd = w.ssm_state, w.ssm_head_dim
        # quadratic intra-chunk term + two state matmuls per chunk
        flops = grid * (2 * chunk * chunk * (n + hd) + 4 * chunk * n * hd)
        vmem = (BF16 * 2 * chunk * (hd + 2 * n) + BF16 * 2 * chunk * hd
                + F32 * (chunk * chunk + n * hd))
        hbm = F32 * w.batch * l * w.ssm_heads * (hd + 2 * n // max(w.ssm_heads // 8, 1))
        t = (grid * w.launch_overhead_us
             + flops / (self.hardware.mxu_flops_per_us * _mxu_util(chunk))
             + hbm / self.hardware.hbm_bytes_per_us)
        return t, grid, vmem, flops, hbm

    def rmsnorm(self, p) -> Tuple[float, float, float, float, float]:
        w = self.workload
        rb = int(p["row_block"])
        rows = _padded(w.batch * w.seq_len, rb)
        grid = rows // rb
        flops = 4.0 * rows * w.d_model
        vmem = BF16 * (2 * 2 * rb * w.d_model + w.d_model)
        hbm = F32 * rows * w.d_model * 2
        t = grid * w.launch_overhead_us + hbm / self.hardware.hbm_bytes_per_us
        return t, grid, vmem, flops, hbm

    def paged_attention(self, p) -> Tuple[float, float, float, float, float]:
        w = self.workload
        ps = int(p["page_size"])
        n_pages = _ceil_div(w.seq_len, ps)
        grid = w.batch * w.kv_heads * n_pages
        g = max(w.heads // max(w.kv_heads, 1), 1)
        ctx = n_pages * ps
        # one new token per slot attending over the page-quantized context
        flops = w.batch * w.heads * ctx * 4 * w.head_dim
        # the paged win: on-chip memory holds one (page_size x head_dim) K/V page pair
        # per stream — independent of seq_len, unlike the dense decode cache
        vmem = (BF16 * 2 * 2 * ps * w.head_dim       # k/v page, dbl-buffered
                + BF16 * 2 * g * w.head_dim          # q in / out block
                + F32 * g * (w.head_dim + 2 * LANE))  # acc/m/l scratch
        hbm = (F32 * grid * 2 * ps * w.head_dim       # streamed pool pages
               + F32 * w.batch * w.heads * w.head_dim * 2  # q in, out
               + F32 * w.batch * n_pages)             # page table
        t = (grid * w.launch_overhead_us
             + flops / (self.hardware.mxu_flops_per_us * _mxu_util(ps))
             + hbm / self.hardware.hbm_bytes_per_us)
        return t, grid, vmem, flops, hbm

    MODELS = ("flash_attention", "mamba_scan", "ssd", "rmsnorm",
              "paged_attention")

    def family_cost(self, family: str, params: Dict[str, Any]
                    ) -> Tuple[float, float, float, float, float]:
        if family not in self.MODELS:
            raise KeyError(
                f"no launch-geometry model for family {family!r}; "
                f"modeled: {sorted(self.MODELS)}")
        return getattr(self, family)(params)

    def totals(self, families: Sequence[str], config: Dict[str, Any]
               ) -> Tuple[Dict[str, float], float, bool]:
        """Summed counters, total modeled latency, and footprint feasibility over
        ``families`` (evaluated in the given order — keep it sorted for
        reproducible accumulation)."""
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

    - hardware: scale the peak rates and per-launch overhead (a different
      accelerator generation);
    - workload: scale/override the workload shape (a different serving
      assignment);
    - feasibility: scale the footprint budget (tightened -> parts of the
      source-feasible grid become infeasible in the target);
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
    sorted families, same footprint feasibility gate, and the
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
    footprint feasibility gate come from the geometry model; an
    infeasible configuration returns ``inf`` without launching.

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
        self.geometry = LaunchGeometry(workload)
        self.device = resolve_device(device)
        self.dtype = dtype or torch.bfloat16
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
