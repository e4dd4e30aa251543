"""Serving-stack tuning environment: the whole serving configuration —
scheduler knobs joined with kernel launch geometry — as a CAMEO PerfEnv
whose environment axis is the request workload.

The configuration space is :func:`repro_torch.workloads.sim.serving_space`:
``serving.*`` scheduler options (decode slots, admission chunk, cache
length, interleave policy) plus the ``family.param`` launch options of the
dispatch registry.  Measurement runs the deterministic continuous-batching
simulator (:class:`repro_torch.workloads.sim.ServingSimulator`) over ONE fixed
trace realization per environment instance, so configurations are compared
under the identical arrival process and the paper's environment change is a
*workload swap*: two ``ServingEnv`` with different trace specs are a
source→target transfer pair (see :func:`make_serving_pair`).

Objectives:

- ``latency`` (default): minimize the p99 request latency (modeled us);
- ``throughput``: maximize completed requests per modeled second, under the
  SLO as a constraint — ``query_text`` emits "maximize throughput for which
  latency is less than <slo_us> ...", exercising the direction-aware
  infeasibility path end-to-end.

Infeasible configurations (launch blocks overflowing the footprint budget
— the "vmem" reason, in the reference's names — a cache_len the
trace does not fit in) measure as ``inf`` in the minimize direction and
``-inf`` in the maximize direction.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.envs import measure as measure_mod
from repro_torch.envs.base import PooledEnv
from repro_torch.envs.measure import EnvShift, HardwareSpec, KernelWorkload
from repro_torch.kernels import dispatch
from repro_torch.workloads.sim import (FLEET_COUNTER_NAMES, SIM_COUNTER_NAMES,
                                 FleetPlan, FleetSimulator, FleetSpec,
                                 ServingPlan, ServingSimulator, SimReport,
                                 serving_space, stalled_report)
from repro_torch.workloads.traces import Trace, TraceWorkload, make_workload

OBJECTIVES = ("latency", "throughput")

#: seed salt for the straggler placement draw — fixed so the SAME devices
#: straggle for every environment instance over the same substrate (the
#: straggler set is part of the environment, not of any env's noise stream)
_STRAGGLER_SALT = 0x57A6


def _resolve_shifts(shifts: Union[str, Sequence[EnvShift]]
                    ) -> Tuple[EnvShift, ...]:
    if isinstance(shifts, str):
        return measure_mod.shifts_for(shifts)
    return tuple(shifts)


def fleet_spec_for(shifts: Sequence[EnvShift],
                   num_devices: int = 8) -> FleetSpec:
    """The deployment substrate the composed ``shifts`` leave behind:
    ``device_scale`` resizes the fleet (elastic preemption), and
    ``straggler_frac``/``straggler_slowdown`` place slow devices.  The
    straggler set depends only on the substrate (device count, slow count),
    NOT on any environment seed — target optimum sweeps and tuning runs at
    different seeds must agree on which devices limp."""
    devices = num_devices
    frac = 0.0
    slowdown = 1.0
    for s in shifts:
        devices = max(1, int(round(devices * s.device_scale)))
        frac = max(frac, s.straggler_frac)
        slowdown *= s.straggler_slowdown
    n_slow = int(round(frac * devices))
    if n_slow == 0 or slowdown <= 1.0:
        return FleetSpec(num_devices=devices)
    rng = np.random.default_rng([devices, n_slow, _STRAGGLER_SALT])
    slow = tuple(sorted(int(d) for d in
                        rng.choice(devices, size=n_slow, replace=False)))
    return FleetSpec(num_devices=devices, slow_devices=slow,
                     slowdown=slowdown)


class ServingEnv(PooledEnv):
    """PerfEnv over the serving stack for one workload trace.

    ``workload`` is a spec string (``make_workload`` grammar), a bound
    :class:`TraceWorkload`, or an already-generated :class:`Trace`.  ``cell``
    fixes the served model's kernel dimensions; ``families`` the kernel
    families it dispatches (default: every modeled registered family).  The
    trace realization is drawn once at construction from ``trace_seed``
    (default ``seed``) — every measurement replays the same arrivals.
    """

    def __init__(self, workload: Union[str, TraceWorkload, Trace] = "poisson",
                 cell: Optional[KernelWorkload] = None,
                 families: Optional[Iterable[str]] = None, seed: int = 0,
                 *, objective: str = "latency", slo_us: float = 2_000.0,
                 hardware: Optional[HardwareSpec] = None,
                 trace_seed: Optional[int] = None, fleet: bool = False,
                 shifts: Union[str, Sequence[EnvShift]] = (),
                 num_devices: int = 8):
        if objective not in OBJECTIVES:
            raise ValueError(f"unknown serving objective {objective!r}; "
                             f"known: {sorted(OBJECTIVES)}")
        self.cell = cell or KernelWorkload()
        if families is None:
            modeled = measure_mod.modeled_families()
            families = [f for f in dispatch.families() if f in modeled]
        self.families = tuple(sorted(families))
        if isinstance(workload, str):
            workload = make_workload(workload)
        if isinstance(workload, Trace):
            self.trace = workload
            self.workload_spec = workload.spec
        else:
            self.trace = workload.generate(
                seed if trace_seed is None else trace_seed)
            self.workload_spec = workload.spec
        self.objective = objective
        self.maximize = objective == "throughput"
        self.slo_us = float(slo_us)
        # environment shifts rewrite the substrate this env prices against:
        # the model cell + hardware (all kinds) and the fleet spec
        # (straggler/resize kinds) — the trace realization is untouched
        self.shifts = _resolve_shifts(shifts)
        shifted_hw = hardware or HardwareSpec()
        shifted_cell = self.cell
        for s in self.shifts:
            shifted_cell, shifted_hw = s.apply(shifted_cell, shifted_hw)
        self.fleet = bool(fleet)
        if self.fleet:
            self.fleet_spec = fleet_spec_for(self.shifts, num_devices)
            self.sim = FleetSimulator(
                shifted_cell, self.families, hardware=shifted_hw,
                slo_us=self.slo_us, fleet=self.fleet_spec)
        else:
            self.fleet_spec = None
            self.sim = ServingSimulator(shifted_cell, self.families,
                                        hardware=shifted_hw,
                                        slo_us=self.slo_us)
        self._noise_rng = np.random.default_rng(seed + 13)
        super().__init__(serving_space(self.families, fleet=self.fleet),
                         FLEET_COUNTER_NAMES if self.fleet
                         else SIM_COUNTER_NAMES, seed=seed)

    @property
    def query_text(self) -> str:
        """The query ``transfer_tune`` should run this environment under
        (``{budget}`` left for the runner to fill)."""
        if self.maximize:
            return (f"maximize throughput for which latency is less than "
                    f"{self.slo_us:g} within {{budget}} samples")
        return "minimize latency within {budget} samples"

    def simulate(self, config: Dict[str, Any]) -> SimReport:
        """The raw (noise-free) simulator report for one configuration."""
        plan = ServingPlan.from_config(config)
        if self.fleet:
            return self.sim.run(self.trace, plan,
                                FleetPlan.from_config(config), config)
        return self.sim.run(self.trace, plan, config)

    def _measure(self, config: Dict[str, Any]
                 ) -> Tuple[Dict[str, float], float]:
        from repro_torch.serving.scheduler import DrainStall

        try:
            report = self.simulate(config)
        except DrainStall:
            # a deployment that cannot drain its own trace (e.g. a starved
            # page pool serializing every request) prices as infeasible
            report = stalled_report(
                len(self.trace.requests),
                FleetPlan.from_config(config) if self.fleet else None)
        counters = report.counters()
        if not report.feasible:
            return counters, float("-inf" if self.maximize else "inf")
        y = (report.throughput_rps if self.maximize
             else report.p99_latency_us)
        y *= 1.0 + self.cell.noise * float(self._noise_rng.standard_normal())
        return counters, y

    # -- deployment -----------------------------------------------------

    @staticmethod
    def plan_of(config: Dict[str, Any]) -> ServingPlan:
        """The scheduler half of a tuned configuration — feed its fields to
        :class:`repro_torch.serving.scheduler.ContinuousBatcher`."""
        return ServingPlan.from_config(config)

    def apply(self, config: Dict[str, Any]):
        """Context manager installing the kernel-launch half on the dispatch
        registry (the scheduler half deploys via :meth:`plan_of`)."""
        from repro_torch.tuner.space import launch_config_of

        return dispatch.use_launch_config(launch_config_of(config))


def make_serving_pair(source: Union[str, TraceWorkload],
                      target: Union[str, TraceWorkload],
                      cell: Optional[KernelWorkload] = None,
                      families: Optional[Iterable[str]] = None,
                      seed: int = 0, **kw: Any
                      ) -> Tuple[ServingEnv, ServingEnv]:
    """(source, target) serving environments differing ONLY in workload —
    the paper's workload-fluctuation environment change.  Identical
    configuration space; independent measurement-noise streams."""
    src = ServingEnv(source, cell, families, seed=seed + 1, **kw)
    tgt = ServingEnv(target, cell, src.families, seed=seed + 2, **kw)
    return src, tgt


def make_fleet_pair(workload: Union[str, TraceWorkload] = "poisson",
                    shift: Union[str, Sequence[EnvShift]] = "straggler",
                    cell: Optional[KernelWorkload] = None,
                    families: Optional[Iterable[str]] = None,
                    seed: int = 0, num_devices: int = 8, **kw: Any
                    ) -> Tuple[ServingEnv, ServingEnv]:
    """(source, target) FLEET environments differing ONLY in the fleet
    disruption: same workload trace realization, same devices — the target
    additionally suffers ``shift`` (a shift kind name like ``"straggler"``/
    ``"resize"`` or explicit :class:`EnvShift` list).  The paper's transfer
    question at fleet scale: does the router/replica configuration learned
    on the healthy fleet carry to the degraded one?"""
    trace_seed = kw.pop("trace_seed", seed)
    src = ServingEnv(workload, cell, families, seed=seed + 1, fleet=True,
                     num_devices=num_devices, trace_seed=trace_seed, **kw)
    tgt = ServingEnv(workload, cell, src.families, seed=seed + 2, fleet=True,
                     shifts=shift, num_devices=num_devices,
                     trace_seed=trace_seed, **kw)
    return src, tgt
