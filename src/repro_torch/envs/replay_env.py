"""Replay-backed serving environment: the real ``ContinuousBatcher`` as the
*target* half of a sim-to-real transfer pair — the port of
:mod:`repro.envs.replay_env`, deploying onto the port's batcher on the GPU
(``device="cpu"`` runs the plain PyTorch versions, as the tests do).

CAMEO's premise is that the source environment is a cheap stand-in for a
target where intervention is costly — and the paper validates against the
real deployment, not a second simulator.  :class:`ReplayServingEnv` closes
that loop for the serving stack: it exposes the SAME configuration surface
as :class:`repro_torch.envs.serving_env.ServingEnv` (``serving.*`` scheduler knobs
joined with the ``family.param`` kernel-launch options), but each
measurement *deploys* the candidate — scheduler half via
``ServingEnv.plan_of``, launch half baked into the serve steps through
``dispatch.use_launch_config`` inside the step factories — onto a freshly
constructed batcher and replays the pinned trace through
:func:`repro_torch.serving.replay.replay_trace`.  ``y`` is the replay's wall-clock
p99 latency (ms) or throughput (completed req/s), and the replay counters
(queue depth, occupancy, prefill/decode wall-time split, rejections) are the
discovery variables, name-compatible with the simulator's so a causal model
extracted from simulator observations transfers onto replay measurements.

Feasibility mirrors the simulator: a ``cache_len`` the trace does not fit
in, or a launch config whose modeled on-chip footprint overflows, measures
as ``inf``/``-inf`` direction-aware *without* running the batcher (the
reference's convention: counters and the footprint gate stay analytic).  A replay that stalls past the tick budget also measures
infeasible — a deployment that cannot drain its own trace is not a usable
configuration.

:func:`make_sim2real_pair` builds the canonical transfer pair: a
``ServingEnv`` (simulator = source) and a ``ReplayServingEnv`` (real batcher
= target) over the *identical* trace realization, with the simulator priced
at the kernel dimensions of the very model the batcher runs.

Fleet mode (``fleet=True``) puts a router in front: the analytic
:class:`~repro_torch.workloads.sim.FleetSimulator` plans which replica
takes each request, the trace is split into one sub-trace per replica, and
each sub-trace replays on the deployed batcher; the straggler monitor is
fed each replica's measured decode seconds per tick.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

from repro_torch.envs import measure as measure_mod
from repro_torch.envs.base import PooledEnv
from repro_torch.envs.measure import HardwareSpec, KernelWorkload, LaunchGeometry
from repro_torch.envs.serving_env import OBJECTIVES, ServingEnv
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.paging import PagedPlan
from repro_torch.workloads.sim import (FleetPlan, FleetReport, ServingPlan,
                                      serving_space)
from repro_torch.workloads.traces import Trace, TraceWorkload, make_workload
from repro_torch.utils.device import DeviceLike, resolve_device, synchronize

# The replay-only rejection mediators, registered in the obs metrics
# registry as their own "replay" group; the discovery tuples below are
# derived group compositions (serving [+ replay] [+ fleet]) — the registry
# is the single source of truth, so sim and replay can never silently
# drift apart.  Objective clones stay out, exactly as in the sim groups.
obs_metrics.declare("rejected_rate", group="replay",
                    help="fraction of trace requests rejected at submit")
obs_metrics.declare("rejected_too_long", group="replay", kind="counter",
                    help="requests rejected because prompt+max_new "
                         "overflows the deployed shape")

#: the simulator's discovery counters plus the replay-only rejection signals
REPLAY_COUNTER_NAMES: Tuple[str, ...] = obs_metrics.discovery_names(
    "serving", "replay")

#: fleet-mode discovery counters: the replay set plus the router/straggler
#: mediators — objective clones stay out, exactly as in FLEET_COUNTER_NAMES
REPLAY_FLEET_COUNTER_NAMES: Tuple[str, ...] = obs_metrics.discovery_names(
    "serving", "replay", "fleet")


def default_replay_model():
    """A tiny dense ``ModelConfig`` cheap enough to replay traces through on
    a CPU — the deployment stand-in :func:`make_sim2real_pair` uses unless
    the caller brings a real assignment."""
    from repro_torch.utils.config import ModelConfig

    return ModelConfig(name="sim2real-tiny", vocab_size=64, d_model=32,
                       num_heads=4, num_kv_heads=2, d_ff=64, num_layers=2,
                       dtype="float32")


class _SmallLru:
    """A tiny explicit LRU (get refreshes recency, put evicts the oldest) —
    unlike ``functools.lru_cache`` the key set is inspectable and the store
    can be cleared in tests, and unlike an open dict it is BOUNDED, so long
    batched sweeps cycling through many deployments do not grow memory
    without limit."""

    def __init__(self, maxsize: int):
        self.maxsize = int(maxsize)
        self._store: "OrderedDict[Any, Any]" = OrderedDict()

    def get(self, key):
        if key not in self._store:
            return None
        self._store.move_to_end(key)
        return self._store[key]

    def put(self, key, value) -> None:
        if key in self._store:
            self._store.move_to_end(key)
        self._store[key] = value
        while len(self._store) > self.maxsize:
            self._store.popitem(last=False)

    def __contains__(self, key) -> bool:
        return key in self._store

    def __len__(self) -> int:
        return len(self._store)

    def clear(self) -> None:
        self._store.clear()


#: built (model, run) per (model_cfg, device), and seeded params per
#: (model_cfg, model_seed, device) — one ``Model`` identity keeps the
#: ``jitted_steps`` step cache warm across env instances
_MODEL_LRU = _SmallLru(maxsize=4)

#: deployments already warmed by :meth:`ReplayServingEnv.intervene_batch`,
#: keyed (model_seed, model_cfg, device, num_slots, cache_len, paged,
#: launch_key); bounded with eviction — an evicted entry only costs a
#: redundant warm pass, never correctness
_WARMED_DEPLOYMENTS = _SmallLru(maxsize=64)


def _built_model(model_cfg, model_seed: int, device, params=None):
    """(model, run, params) shared across every env instance with the same
    deployment — cached in a small explicit LRU (``_MODEL_LRU``) so the
    step cache stays warm while long sweeps over many deployments still
    evict instead of accumulating.  ``params`` (e.g. the reference's
    weights carried across) replace the seeded ones and are not cached."""
    from repro_torch.models.model import build_model
    from repro_torch.utils.config import RunConfig, ShapeConfig

    mkey = ("model", model_cfg, device)
    built = _MODEL_LRU.get(mkey)
    if built is None:
        run = RunConfig(model=model_cfg,
                        shape=ShapeConfig("sim2real", 64, 4, "decode"))
        built = (build_model(model_cfg, run.parallel, device=device), run)
        _MODEL_LRU.put(mkey, built)
    model, run = built
    if params is None:
        pkey = ("params", model_cfg, int(model_seed), device)
        params = _MODEL_LRU.get(pkey)
        if params is None:
            params = model.init(int(model_seed))
            _MODEL_LRU.put(pkey, params)
    return model, run, params


class ReplayServingEnv(PooledEnv):
    """PerfEnv measuring serving configurations on the real batcher.

    ``workload`` is a spec string, bound :class:`TraceWorkload`, or
    already-generated :class:`Trace` — identical grammar to ``ServingEnv``;
    the realization is drawn once at construction (``trace_seed``, default
    ``seed``) and every measurement replays the same arrivals.  The model is
    the *deployment* and stays fixed across seeds (``model_seed``), so two
    envs differing only in ``seed`` measure the same system.

    ``ticks_per_s`` is pinned at construction against the DEFAULT plan's
    slot count: the arrival schedule is part of the environment, so it must
    not drift with the candidate configuration's ``num_slots``.

    ``device`` (default ``cuda``; without a card that raises) is where the
    batcher runs; ``params`` replaces the seeded weights (the tests hand in
    the reference's through ``models.interop.params_from_jax``).
    ``fleet=True`` adds the router and replica knobs (``fleet.*``) over a
    fleet of ``num_devices`` devices.
    """

    def __init__(self, workload: Union[str, TraceWorkload, Trace],
                 model_cfg=None, *, families: Optional[Iterable[str]] = None,
                 cell: Optional[KernelWorkload] = None, seed: int = 0,
                 objective: str = "latency", slo_ms: float = 1_000.0,
                 hardware: Optional[HardwareSpec] = None,
                 trace_seed: Optional[int] = None,
                 ticks_per_s: Optional[float] = None,
                 max_ticks: int = 100_000, model_seed: int = 0,
                 replay_seed: int = 0, warmup: int = 1, repeats: int = 1,
                 fleet: bool = False, num_devices: int = 8,
                 device: DeviceLike = None, params=None):
        from repro_torch.launch.tune import launch_workload_for
        from repro_torch.serving.replay import default_ticks_per_s
        from repro_torch.tuner.space import launch_families_for

        if objective not in OBJECTIVES:
            raise ValueError(f"unknown serving objective {objective!r}; "
                             f"known: {sorted(OBJECTIVES)}")
        self.device = resolve_device(device)
        self.model_cfg = model_cfg or default_replay_model()
        if families is None:
            modeled = measure_mod.modeled_families()
            families = [f for f in launch_families_for(self.model_cfg)
                        if f in modeled]
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
        self.slo_ms = float(slo_ms)
        # the analytic cell the footprint gate prices with — derived
        # from the deployed model unless pinned, like launch tuning does
        self.cell = cell or launch_workload_for(self.model_cfg, batch=1,
                                                seq_len=512, kind="serve")
        self.hardware = hardware or HardwareSpec()
        self.max_ticks = int(max_ticks)
        self.ticks_per_s = ticks_per_s or default_ticks_per_s(
            self.trace, ServingPlan().num_slots)
        self._replay_seed = int(replay_seed)
        self.warmup = int(warmup)
        self.repeats = max(int(repeats), 1)
        #: decode graphs captured inside measured replays (the captures
        #: belong in the warm-up: a capture is set-up, not serving)
        self.measured_captures = 0
        self._model_seed = int(model_seed)
        self.model, self.run, self.params = _built_model(
            self.model_cfg, model_seed, self.device, params)
        self.fleet = bool(fleet)
        self.num_devices = int(num_devices)
        super().__init__(serving_space(self.families, fleet=self.fleet),
                         REPLAY_FLEET_COUNTER_NAMES if self.fleet
                         else REPLAY_COUNTER_NAMES, seed=seed)
        # the deployment key: members of a q-batch sharing these dims share
        # one (prefill, decode) step pair and its warm-up — num_slots stays
        # out (it only changes the decode batch).  fleet.* router knobs
        # never touch a step's shapes, so like the scheduler knobs they
        # stay out: every replica of every fleet plan shares one deployment.
        self.batch_share_dims = tuple(
            ["serving.cache_len"]
            + [n for n in self.space.names
               if "." in n and not n.startswith(("serving.", "fleet."))])

    # measurements are deployment + wall-clock, not noise draws: reusing a
    # prior result for a repeated configuration is pure savings
    memoize_measurements = True

    @property
    def query_text(self) -> str:
        """The query ``transfer_tune`` should run this environment under
        (``{budget}`` left for the runner to fill).  Latency binds in wall
        milliseconds — the replay's unit, not the simulator's."""
        if self.maximize:
            return (f"maximize throughput for which latency is less than "
                    f"{self.slo_ms:g} within {{budget}} samples")
        return "minimize latency within {budget} samples"

    # -- feasibility (analytic) ------------------------------------------

    def infeasible_reason(self, config: Dict[str, Any]) -> str:
        """"" when deployable; otherwise why not (``cache_len``/``pages``/
        ``vmem``/``devices``), decided analytically so undeployable configs
        never reach the batcher.  The paged branch mirrors
        ``ServingSimulator.capacity_reason`` so the analytic gate and the
        real deployment agree.  "vmem": a kernel the step launches has a
        block whose shared bytes (its ``launch_records``) exceed the cell's
        ``vmem_limit`` (default the 232,448 bytes of one H100 block)."""
        plan = ServingPlan.from_config(config)
        paged = PagedPlan.from_config(config)
        if paged.paging:
            if (self.trace.max_context > paged.slot_capacity
                    or paged.pages_for(self.trace.max_context)
                    > paged.pool_pages):
                return "pages"
        elif self.trace.max_context > plan.cache_len:
            return "cache_len"
        if (self.fleet and FleetPlan.from_config(config).num_replicas
                > self.num_devices):
            return "devices"
        seq = paged.slot_capacity if paged.paging else plan.cache_len
        w = dataclasses.replace(self.cell, batch=plan.num_slots, seq_len=seq)
        _, _, feasible = LaunchGeometry(w, self.hardware).totals(
            self.families, config)
        return "" if feasible else "vmem"

    def _infeasible_counters(self) -> Dict[str, float]:
        n = float(len(self.trace.requests))
        c = {"queue_depth_mean": n, "queue_depth_max": n,
             "occupancy_mean": 0.0, "prefill_decode_ratio": 0.0,
             "slo_violation_rate": 1.0, "page_pool_occupancy": 0.0,
             "page_faults": 0.0, "prefill_chunks_inflight": 0.0,
             "rejected_rate": 1.0, "rejected_too_long": 0.0,
             "latency": 0.0, "throughput": 0.0}
        if self.fleet:
            c.update(routing_imbalance=1.0, replica_queue_depth_max=n,
                     straggler_flagged=0.0)
        return c

    # -- measurement ----------------------------------------------------

    def replay(self, config: Dict[str, Any]):
        """Deploy ``config`` on a FRESH batcher and replay the pinned trace;
        returns the :class:`repro_torch.serving.replay.ReplayReport`.  The
        launch half is baked into the serve steps (the step factories run
        under an exclusive ``dispatch.use_launch_config``); the scheduler
        half is the batcher's geometry."""
        plan = ServingPlan.from_config(config)
        paged = PagedPlan.from_config(config)
        deploy_span = obs_trace.span(
            "deployment", cat="env", track=obs_trace.TRACK_ENV,
            num_slots=plan.num_slots, cache_len=plan.cache_len,
            paging=paged.paging, members=1)
        with deploy_span:
            return self._replay_deployed(config, plan, paged)

    def _replay_deployed(self, config: Dict[str, Any], plan: ServingPlan,
                         paged: "PagedPlan"):
        from repro_torch.serving.replay import replay_trace
        from repro_torch.serving.scheduler import ContinuousBatcher
        from repro_torch.tuner.space import launch_config_of

        batcher = ContinuousBatcher(
            self.model, self.run, self.params, num_slots=plan.num_slots,
            cache_len=plan.cache_len, interleave=plan.interleave,
            launch_config=launch_config_of(config), seed=self._replay_seed,
            paged=paged, on_too_long="reject")
        # warmup replays run every step shape this deployment needs (the
        # CUDA library's build on first use, cuBLAS's and the allocator's
        # first calls, the decode graph's capture on the batcher's state) so
        # the measured replay times execution, not set-up — the per-replay
        # delta accounting of replay_trace makes reuse sound
        def one():
            return replay_trace(batcher, self.trace,
                                admit_chunk=plan.admit_chunk,
                                ticks_per_s=self.ticks_per_s,
                                seed=self._replay_seed,
                                max_ticks=self.max_ticks)

        for _ in range(self.warmup):
            one()
        # median-of-k on the objective metric, the WallClockBackend recipe
        # against wall-clock jitter; the whole median report is returned so
        # counters stay internally consistent
        with self._counting_captures(batcher):
            reports = sorted((one() for _ in range(self.repeats)),
                             key=lambda r: (r.throughput_rps if self.maximize
                                            else r.p99_latency_ms))
        return reports[len(reports) // 2]

    @contextlib.contextmanager
    def _counting_captures(self, batcher):
        """Around measured replays: adds the decode graphs that
        ``batcher``'s step captured inside to :attr:`measured_captures`."""
        before = batcher._decode.captures
        try:
            yield
        finally:
            self.measured_captures += batcher._decode.captures - before

    def _measure(self, config: Dict[str, Any]
                 ) -> Tuple[Dict[str, float], float]:
        from repro_torch.serving.scheduler import DrainStall

        bad = float("-inf" if self.maximize else "inf")
        if self.infeasible_reason(config):
            return self._infeasible_counters(), bad
        if self.fleet:
            plan = ServingPlan.from_config(config)
            num_slots, cache_len, paged, frozen = self._deploy_key(plan,
                                                                   config)
            batcher = self._fresh_batcher(num_slots, cache_len, paged, frozen)
            self._warm_deployment(batcher, frozen)
            batcher.interleave = plan.interleave
            try:
                return self._member_result(batcher, config, plan)
            except DrainStall:
                return self._infeasible_counters(), bad
        try:
            with obs_trace.span("measure", cat="env",
                                track=obs_trace.TRACK_ENV,
                                config=dict(config)) as span:
                report = self.replay(config)
                span.set(p99_ms=report.p99_latency_ms, ticks=report.ticks,
                         completed=report.completed,
                         rejected=report.rejected)
        except DrainStall:
            return self._infeasible_counters(), bad
        counters = report.counters(self.slo_ms)
        y = (report.throughput_rps if self.maximize
             else report.p99_latency_ms)
        return counters, y

    # -- fleet replay (sim-planned routing, shared deployment) -----------

    def _fleet_route(self, config: Dict[str, Any], plan: ServingPlan,
                     fleet_plan: FleetPlan) -> FleetReport:
        """Route the pinned trace with the analytic fleet simulator — the
        router's decisions depend only on modeled backlogs, so the plan is
        deterministic and shared between sim-side and replay-side envs."""
        from repro_torch.workloads.sim import FleetSimulator, FleetSpec

        sim = FleetSimulator(self.cell, self.families,
                             hardware=self.hardware,
                             max_ticks=self.max_ticks,
                             fleet=FleetSpec(num_devices=self.num_devices))
        return sim.run(self.trace, plan, fleet_plan, config)

    def _subtraces(self, assignments: Tuple[Tuple[int, ...], ...]
                   ) -> List[Optional[Trace]]:
        """Split the pinned trace into one sub-trace per replica (``None``
        for replicas the router left empty); uids and arrival times are
        preserved, so per-request latency semantics carry over."""
        reqs = self.trace.requests
        out: List[Optional[Trace]] = []
        for r, idxs in enumerate(assignments):
            if not idxs:
                out.append(None)
                continue
            out.append(Trace(kind=self.trace.kind,
                             spec=f"{self.trace.spec}#r{r}",
                             seed=self.trace.seed,
                             requests=tuple(reqs[i] for i in idxs)))
        return out

    def _pool_fleet(self, reports: List[Any], plan_report: FleetReport
                    ) -> Tuple[Dict[str, float], float]:
        """Pool per-replica :class:`ReplayReport`s into one fleet
        measurement.  Replicas run concurrently in a real fleet, so wall
        time is the max over replicas; everything request-weighted pools.
        The straggler monitor is fed each replica's measured decode
        seconds per tick (synchronized with the device), not the plan's."""
        import numpy as np

        from repro_torch.runtime.straggler import StragglerMonitor

        lat = [l for r in reports for l in r.latencies_ms]
        arr = np.asarray(lat, np.float64)
        completed = sum(r.completed for r in reports)
        rejected = sum(r.rejected for r in reports)
        ticks = sum(r.ticks for r in reports)
        wall = max((r.wall_s for r in reports), default=1e-9)
        prefill = sum(r.prefill_s for r in reports)
        decode = sum(r.decode_s for r in reports)
        monitor = StragglerMonitor(max(plan_report.num_replicas, 1))
        step_times = {i: r.decode_s / r.ticks
                      for i, r in enumerate(reports) if r.ticks > 0}
        if step_times:
            for _ in range(monitor.patience):
                monitor.report(step_times)
        p99 = float(np.percentile(arr, 99)) if arr.size else 0.0
        counters = {
            "queue_depth_mean": (sum(r.queue_depth_mean * r.ticks
                                     for r in reports) / max(ticks, 1)),
            "queue_depth_max": max((r.queue_depth_max for r in reports),
                                   default=0.0),
            "occupancy_mean": (sum(r.mean_occupancy * r.ticks
                                   for r in reports) / max(ticks, 1)),
            "prefill_decode_ratio": prefill / max(decode, 1e-9),
            "slo_violation_rate": (float((arr > self.slo_ms).mean())
                                   if arr.size else 0.0),
            "page_pool_occupancy": (sum(r.page_pool_occupancy * r.ticks
                                        for r in reports) / max(ticks, 1)),
            "page_faults": float(sum(r.page_faults for r in reports)),
            "prefill_chunks_inflight": (
                sum(r.prefill_chunks_inflight * r.ticks
                    for r in reports) / max(ticks, 1)),
            "rejected_rate": rejected / max(rejected + completed, 1),
            "rejected_too_long": float(sum(r.rejected_too_long
                                           for r in reports)),
            "latency": p99,
            "throughput": completed / max(wall, 1e-9),
            "routing_imbalance": plan_report.routing_imbalance,
            "replica_queue_depth_max": plan_report.replica_queue_depth_max,
            "straggler_flagged": float(len(monitor.flagged())),
        }
        y = counters["throughput"] if self.maximize else p99
        return counters, y

    def fleet_replay(self, batcher, config: Dict[str, Any],
                     plan: ServingPlan):
        """One fleet measurement's parts: (the router's plan, the
        per-replica replay reports in replica order, empty replicas left
        out), replayed on ``batcher``; ``None`` reports when the plan is
        infeasible."""
        from repro_torch.serving.replay import replay_trace

        plan_report = self._fleet_route(config, plan,
                                        FleetPlan.from_config(config))
        if not plan_report.feasible:
            return plan_report, None
        reports = [replay_trace(batcher, st, admit_chunk=plan.admit_chunk,
                                ticks_per_s=self.ticks_per_s,
                                seed=self._replay_seed,
                                max_ticks=self.max_ticks)
                   for st in self._subtraces(plan_report.assignments)
                   if st is not None]
        return plan_report, reports

    def _member_result(self, batcher, config: Dict[str, Any],
                       plan: ServingPlan) -> Tuple[Dict[str, float], float]:
        """(counters, y) of one member measured on a warmed deployment —
        plain replay, or (fleet mode) sim-planned routing followed by one
        sub-trace replay per replica on the SAME shared batcher (replica
        batchers are identical deployments, so sequential replay on one
        instance is sound and the fleet wall time is the max over
        replicas)."""
        from repro_torch.serving.replay import replay_trace

        if self.fleet:
            outs = []
            with self._counting_captures(batcher):
                for _ in range(self.repeats):
                    plan_report, reports = self.fleet_replay(batcher, config,
                                                             plan)
                    if reports is None:
                        return (self._infeasible_counters(),
                                float("-inf" if self.maximize else "inf"))
                    outs.append(self._pool_fleet(reports, plan_report))
            outs.sort(key=lambda cy: cy[1])
            return outs[len(outs) // 2]

        with self._counting_captures(batcher):
            reports = sorted(
                (replay_trace(batcher, self.trace,
                              admit_chunk=plan.admit_chunk,
                              ticks_per_s=self.ticks_per_s,
                              seed=self._replay_seed,
                              max_ticks=self.max_ticks)
                 for _ in range(self.repeats)),
                key=lambda r: (r.throughput_rps if self.maximize
                               else r.p99_latency_ms))
        report = reports[len(reports) // 2]
        return (report.counters(self.slo_ms),
                (report.throughput_rps if self.maximize
                 else report.p99_latency_ms))

    # -- batched measurement --------------------------------------------

    def _deploy_key(self, plan: ServingPlan, config: Dict[str, Any]) -> tuple:
        from repro_torch.tuner.space import launch_config_of
        from repro_torch.train.serve_step import freeze_launch_config

        # PagedPlan is a frozen dataclass of scalars — hashable, and it
        # captures the paged compiled shape (pool, page size, table width)
        # the launch-config half does not
        return (plan.num_slots, plan.cache_len, PagedPlan.from_config(config),
                freeze_launch_config(launch_config_of(config)))

    def _fresh_batcher(self, num_slots: int, cache_len: int,
                       paged: PagedPlan, frozen: tuple):
        from repro_torch.serving.scheduler import ContinuousBatcher

        return ContinuousBatcher(
            self.model, self.run, self.params, num_slots=num_slots,
            cache_len=cache_len, interleave="eager",
            launch_config={f: dict(p) for f, p in frozen},
            seed=self._replay_seed, paged=paged, on_too_long="reject")

    def _warm_deployment(self, batcher, frozen: tuple) -> None:
        """Run every step shape this deployment's replays need once, eagerly
        and synchronized, without replaying: one prefill per distinct
        fitting prompt length plus one decode step (on first use this
        builds the CUDA library and warms cuBLAS; on the card the decode
        step captures its graph on this batcher's state).  Direct calls —
        the batcher's wall-time counters and scheduling state are
        untouched, so the measured replays start clean.  The decode step
        writes its pad rows into the fresh batcher's caches in place and
        advances every slot's length by one: rows and lengths that seating
        a request overwrites whole, or a paged deployment's scratch page.
        The prefills are recorded in a bounded LRU so repeat deployments
        skip them; the decode step runs on every fresh batcher, whose state
        a graph has not seen."""
        import torch

        wkey = (self._model_seed, self.model_cfg, self.device,
                batcher.num_slots, batcher.cache_len, batcher.paged, frozen)
        lens = []
        if wkey in _WARMED_DEPLOYMENTS:
            obs_trace.instant("warmup_cached", cat="env",
                              track=obs_trace.TRACK_ENV,
                              num_slots=batcher.num_slots,
                              cache_len=batcher.cache_len)
        else:
            lens = sorted({r.prompt_len for r in self.trace.requests
                           if r.prompt_len + r.output_len
                           <= batcher.cache_len})
        with obs_trace.span("warmup", cat="env", track=obs_trace.TRACK_ENV,
                            num_slots=batcher.num_slots,
                            cache_len=batcher.cache_len,
                            prompt_lens=len(lens)):
            for plen in lens:
                batcher._prefill(self.params, {"tokens": torch.zeros(
                    (1, plen), dtype=torch.int32, device=self.device)})
                synchronize(self.device)
            batcher._decode(self.params, batcher.state,
                            batcher._tokens[:, None])
            synchronize(self.device)
        _WARMED_DEPLOYMENTS.put(wkey, True)

    def intervene_batch(self, configs: List[Dict[str, Any]]
                        ) -> List[Tuple[Dict[str, float], float]]:
        """Measure a q-batch with one deployment per compile key.

        Members are grouped by ``(num_slots, cache_len, launch)``; each
        group builds ONE batcher, warms it directly (every distinct prompt
        length's prefill + the decode step), then replays every member
        against the warmed deployment — ``admit_chunk``/``interleave`` are
        per-replay knobs, and :func:`replay_trace`'s delta accounting keeps
        a reused batcher sound.  Groups differing only in ``num_slots``
        still share the prefill steps through the ``jitted_steps``
        cache.  A :class:`DrainStall` in one member records THAT member
        infeasible and rebuilds the batcher (steps stay cached) instead of
        aborting the round.  Results come back in input order.
        """
        from repro_torch.serving.scheduler import DrainStall

        bad = float("-inf" if self.maximize else "inf")
        results: List[Optional[Tuple[Dict[str, float], float]]] = \
            [None] * len(configs)
        groups: Dict[tuple, List[int]] = {}
        for i, cfg in enumerate(configs):
            if self.infeasible_reason(cfg):
                results[i] = (self._infeasible_counters(), bad)
                continue
            key = self._deploy_key(ServingPlan.from_config(cfg), cfg)
            groups.setdefault(key, []).append(i)

        for (num_slots, cache_len, paged, frozen), members in groups.items():
            with obs_trace.span("deployment", cat="env",
                                track=obs_trace.TRACK_ENV,
                                num_slots=num_slots, cache_len=cache_len,
                                paging=paged.paging, members=len(members)):
                batcher = self._fresh_batcher(num_slots, cache_len, paged,
                                              frozen)
                self._warm_deployment(batcher, frozen)
                for i in members:
                    plan = ServingPlan.from_config(configs[i])
                    batcher.interleave = plan.interleave
                    member_span = obs_trace.span(
                        "member_replay", cat="env",
                        track=obs_trace.TRACK_ENV, member=i,
                        interleave=plan.interleave,
                        admit_chunk=plan.admit_chunk)
                    with member_span:
                        try:
                            results[i] = self._member_result(
                                batcher, configs[i], plan)
                            member_span.set(y=results[i][1])
                        except DrainStall:
                            results[i] = (self._infeasible_counters(), bad)
                            member_span.set(stalled=True)
                            # a stalled replay leaves residents behind —
                            # rebuild (cheap: the steps are cached) and
                            # warm its decode step
                            batcher = self._fresh_batcher(
                                num_slots, cache_len, paged, frozen)
                            self._warm_deployment(batcher, frozen)

        for cfg, res in zip(configs, results):
            self._remember(cfg, res[0], res[1])
        return results

    # -- deployment -----------------------------------------------------

    plan_of = staticmethod(ServingEnv.plan_of)
    apply = ServingEnv.apply


def make_sim2real_pair(workload: Union[str, TraceWorkload, Trace],
                       model_cfg=None, *,
                       families: Optional[Iterable[str]] = None,
                       seed: int = 0, trace_seed: Optional[int] = None,
                       objective: str = "latency", slo_us: float = 2_000.0,
                       slo_ms: float = 1_000.0,
                       hardware: Optional[HardwareSpec] = None,
                       fleet: bool = False, num_devices: int = 8,
                       device: DeviceLike = None, **replay_kw: Any
                       ) -> Tuple[ServingEnv, ReplayServingEnv]:
    """(source, target) over the IDENTICAL trace realization: the simulator
    prices the trace analytically at the deployed model's kernel dimensions
    (cheap staging), the replay environment measures the real batcher on
    ``device`` (the deployment).  Identical configuration space; the
    paper's sim-to-real environment change with everything else held
    fixed.  ``fleet=True`` gives both halves the router/replica knobs (same
    ``fleet.*`` surface, same device budget)."""
    from repro_torch.launch.tune import launch_workload_for
    from repro_torch.tuner.space import launch_families_for

    model_cfg = model_cfg or default_replay_model()
    if families is None:
        modeled = measure_mod.modeled_families()
        families = [f for f in launch_families_for(model_cfg)
                    if f in modeled]
    families = tuple(sorted(families))
    cell = launch_workload_for(model_cfg, batch=1, seq_len=512, kind="serve")
    if isinstance(workload, str):
        workload = make_workload(workload)
    if not isinstance(workload, Trace):
        workload = workload.generate(seed if trace_seed is None
                                     else trace_seed)
    tgt = ReplayServingEnv(workload, model_cfg, families=families, cell=cell,
                           seed=seed + 2, objective=objective, slo_ms=slo_ms,
                           hardware=hardware, fleet=fleet,
                           num_devices=num_devices, device=device,
                           **replay_kw)
    src = ServingEnv(workload, cell, families, seed=seed + 1,
                     objective=objective, slo_us=slo_us, hardware=hardware,
                     fleet=fleet, num_devices=num_devices)
    return src, tgt
