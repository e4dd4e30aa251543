"""Deterministic discrete-event simulator of the continuous batcher.

The real :class:`repro_torch.serving.scheduler.ContinuousBatcher` keeps a fixed
number of decode slots, admits queued requests into free slots, and runs one
fused decode step per tick.  This module replays that control loop against
the analytic per-kernel cost model (:class:`repro_torch.envs.measure.
LaunchGeometry`), so the full serving stack — scheduler knobs AND kernel
launch geometry — is priceable in microseconds of modeled time on CPU CI:

- one admission costs the modeled prefill of that prompt at batch 1;
- one decode tick costs the modeled cost of the compiled decode shape
  ``(num_slots, cache_len)`` amortized per token — the compiled program runs
  at full batch whether slots are occupied or not, exactly like the real
  batcher;
- the footprint feasibility gate of the launch space ("vmem" in the
  reference's names) carries over, and a plan
  whose ``cache_len`` cannot hold every request of the trace is infeasible
  (you cannot deploy a cache too small for the workload).

The simulator is pure and seeded by its inputs: the same (trace, plan,
config) triple always yields the identical :class:`SimReport`.
"""

from __future__ import annotations

import dataclasses
import zlib
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.spaces import ConfigSpace, Option
from repro_torch.envs import measure as measure_mod
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.envs.measure import (HardwareSpec, KernelWorkload, LaunchGeometry,
                                family_params)
from repro_torch.serving.paging import PAGES_OPTIONS, PagedPlan
from repro_torch.serving.scheduler import DrainStall
from repro_torch.workloads.traces import Trace

SERVING_PREFIX = "serving."

#: The scheduler's tunable surface.  ``family.param`` launch options join it
#: in :func:`serving_space` — together they are the serving stack CAMEO tunes.
SCHEDULER_OPTIONS: Tuple[Option, ...] = (
    Option("serving.num_slots", (2, 4, 8, 16), default=8),
    Option("serving.admit_chunk", (1, 2, 4, 8), default=4),
    Option("serving.cache_len", (128, 256, 512, 1024, 2048), default=512),
    Option("serving.interleave", ("eager", "drain"), default="eager",
           kind="categorical"),
)


FLEET_PREFIX = "fleet."

#: selectable router policies of the fleet front-end
ROUTING_POLICIES: Tuple[str, ...] = (
    "round_robin", "join_shortest_queue", "power_of_two")

#: The fleet's tunable surface: replica count, routing policy, and the
#: per-replica data-vs-model mesh split (resolved through
#: ``runtime.elastic.viable_mesh_shape``).  Joined into :func:`serving_space`
#: with ``fleet=True``.
FLEET_OPTIONS: Tuple[Option, ...] = (
    Option("fleet.num_replicas", (1, 2, 4, 8), default=2),
    Option("fleet.routing", ROUTING_POLICIES, default="round_robin",
           kind="categorical"),
    Option("fleet.model_parallel", (1, 2, 4), default=1),
)


def serving_space(families: Optional[Iterable[str]] = None, *,
                  fleet: bool = False) -> ConfigSpace:
    """Scheduler options joined with the kernel-launch space — one flat
    ``ConfigSpace`` (``serving.*`` + ``family.param`` keys).  With
    ``fleet=True`` the router/replica knobs (``fleet.*`` keys) join too.
    When the served model dispatches the ``paged_attention`` family, the
    scheduler-level paging knobs (``pages.*``) join as well — the kernel-level
    paging knobs (page size, pages per slot, prefill chunk) already ride in
    via ``dispatch.launch_space``."""
    from repro_torch.kernels import dispatch

    options = list(SCHEDULER_OPTIONS)
    if fleet:
        options += list(FLEET_OPTIONS)
    fams = sorted(families) if families is not None else dispatch.families()
    if "paged_attention" in fams:
        options += list(PAGES_OPTIONS)
    return ConfigSpace(options + list(dispatch.launch_space(fams).options))


@dataclass(frozen=True)
class ServingPlan:
    """The scheduler half of a serving configuration."""

    num_slots: int = 8
    admit_chunk: int = 4
    cache_len: int = 512
    interleave: str = "eager"        # eager: admit every tick; drain: only
                                     # refill once the resident batch empties

    def __post_init__(self):
        if self.num_slots < 1 or self.admit_chunk < 1 or self.cache_len < 1:
            raise ValueError(f"malformed serving plan {self}")
        if self.interleave not in ("eager", "drain"):
            raise ValueError(
                f"unknown interleave policy {self.interleave!r}; "
                f"known: ['drain', 'eager']")

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> "ServingPlan":
        """Extract the ``serving.*`` keys of a flat tuner configuration,
        defaulting anything unspecified."""
        kw = {}
        for f in dataclasses.fields(cls):
            key = SERVING_PREFIX + f.name
            if key in config:
                v = config[key]
                kw[f.name] = v if f.name == "interleave" else int(v)
        return cls(**kw)


@dataclass(frozen=True)
class SimReport:
    """Counters from one simulated trace run (modeled time in us)."""

    feasible: bool
    reason: str                      # "" when feasible
    completed: int
    ticks: int
    makespan_us: float
    queue_depth_mean: float
    queue_depth_max: float
    occupancy_mean: float
    prefill_us: float
    decode_us: float
    p50_latency_us: float
    p99_latency_us: float
    mean_latency_us: float
    throughput_rps: float            # completed requests / modeled second
    tokens_per_s: float
    slo_violation_rate: float
    # paged-KV mediators (all 0.0 on the dense path, so pre-paging reports
    # and the infeasible sentinel stay field-compatible)
    page_pool_occupancy: float = 0.0   # mean used-pages / pool per tick
    page_faults: float = 0.0           # pool-exhaustion evictions
    prefill_chunks_inflight: float = 0.0  # mean inflight prefills per tick

    @property
    def prefill_decode_ratio(self) -> float:
        return self.prefill_us / max(self.decode_us, 1e-9)

    def counters(self) -> Dict[str, float]:
        """The measurement's metrics dict.  ``latency`` (p99) and
        ``throughput`` use the query engine's metric names so constrained
        queries ("... for which latency is less than X") bind directly —
        but they are NOT in :data:`SIM_COUNTER_NAMES`: each is (a copy of)
        an objective, and admitting an objective clone into the causal
        graph lets the CI machinery condition it away from the config
        options, collapsing the ACE ranking."""
        return {
            "queue_depth_mean": self.queue_depth_mean,
            "queue_depth_max": self.queue_depth_max,
            "occupancy_mean": self.occupancy_mean,
            "prefill_decode_ratio": self.prefill_decode_ratio,
            "latency": self.p99_latency_us,
            "throughput": self.throughput_rps,
            "slo_violation_rate": self.slo_violation_rate,
            "page_pool_occupancy": self.page_pool_occupancy,
            "page_faults": self.page_faults,
            "prefill_chunks_inflight": self.prefill_chunks_inflight,
        }


# The system events C used for causal discovery: genuine mediators between
# configuration and objective (queueing, occupancy, prefill/decode mix, and
# — with paging on — pool pressure and chunked-prefill interleaving).
# Declared in the obs metrics registry — the single source of truth sim,
# fleet, and replay all derive their counter-name tuples from — in the
# "serving" group; declaration order IS discovery-matrix column order.
obs_metrics.declare("queue_depth_mean", group="serving",
                    help="mean waiting-queue depth per tick")
obs_metrics.declare("queue_depth_max", group="serving",
                    help="max waiting-queue depth over the run")
obs_metrics.declare("occupancy_mean", group="serving",
                    help="mean seated-slot occupancy per tick")
obs_metrics.declare("prefill_decode_ratio", group="serving",
                    help="prefill time / decode time over the run")
obs_metrics.declare("slo_violation_rate", group="serving",
                    help="fraction of requests whose latency missed the SLO")
obs_metrics.declare("page_pool_occupancy", group="serving",
                    help="mean used-pages / pool per tick (paged KV)")
obs_metrics.declare("page_faults", group="serving", kind="counter",
                    help="pool-exhaustion evictions (paged KV)")
obs_metrics.declare("prefill_chunks_inflight", group="serving",
                    help="mean inflight chunked prefills per tick")
# objective clones: present in counters() so constrained queries bind, but
# discovery=False keeps them out of the causal graph's variable set
obs_metrics.declare("latency", group="serving", discovery=False,
                    help="p99 latency objective clone", unit="us")
obs_metrics.declare("throughput", group="serving", discovery=False,
                    help="throughput objective clone", unit="rps")

SIM_COUNTER_NAMES: Tuple[str, ...] = obs_metrics.discovery_names("serving")


def _infeasible(reason: str, n_requests: int) -> SimReport:
    return SimReport(feasible=False, reason=reason, completed=0, ticks=0,
                     makespan_us=0.0, queue_depth_mean=float(n_requests),
                     queue_depth_max=float(n_requests), occupancy_mean=0.0,
                     prefill_us=0.0, decode_us=0.0, p50_latency_us=0.0,
                     p99_latency_us=0.0, mean_latency_us=0.0,
                     throughput_rps=0.0, tokens_per_s=0.0,
                     slo_violation_rate=1.0)


class ServingSimulator:
    """Prices a (trace, plan, launch config) triple in modeled microseconds.

    ``cell`` fixes the model dimensions (heads, head_dim, d_model, ...); its
    batch/seq fields are overridden per event by the serving shapes the plan
    implies.  ``families`` are the kernel families the served model
    dispatches — their launch parameters (``family.param`` keys of the
    config) steer every prefill/decode price through the same
    :class:`LaunchGeometry` the kernel-launch environment uses.
    """

    def __init__(self, cell: KernelWorkload, families: Iterable[str], *,
                 hardware: Optional[HardwareSpec] = None,
                 slo_us: float = 2_000.0, max_ticks: int = 200_000):
        self.cell = cell
        self.families = tuple(sorted(families))
        measure_mod._check_modeled(self.families)
        self.hardware = hardware or HardwareSpec()
        self.slo_us = float(slo_us)
        self.max_ticks = int(max_ticks)
        self._cost_cache: Dict[Tuple, Tuple[float, bool]] = {}

    # -- pricing --------------------------------------------------------

    def _shape_cost(self, batch: int, seq_len: int, config: Dict[str, Any],
                    families: Optional[Tuple[str, ...]] = None
                    ) -> Tuple[float, bool]:
        """(modeled us, vmem-feasible) of one launch at (batch, seq_len)."""
        fams = self.families if families is None else families
        key = (fams, batch, seq_len,
               tuple(sorted((k, v) for k, v in config.items() if "." in k)))
        if key not in self._cost_cache:
            w = dataclasses.replace(self.cell, batch=batch, seq_len=seq_len)
            geo = LaunchGeometry(w, self.hardware)
            _, t, feasible = geo.totals(fams, config)
            self._cost_cache[key] = (t, feasible)
        return self._cost_cache[key]

    def _step_families(self, paged_step: bool) -> Tuple[str, ...]:
        """The families one serving step actually launches.  Attention is
        either the dense flash decode OR the paged-pool kernel, never both:
        a dense step (and every prefill — the paged kernel is decode-only)
        drops ``paged_attention``; a paged decode step drops
        ``flash_attention``.  An env without ``paged_attention`` in its
        family set is unaffected, so legacy pricing is bit-identical."""
        if "paged_attention" not in self.families:
            return self.families
        drop = "flash_attention" if paged_step else "paged_attention"
        return tuple(f for f in self.families if f != drop)

    def prefill_us(self, prompt_len: int, plan: ServingPlan,
                   config: Dict[str, Any]) -> Tuple[float, bool]:
        return self._shape_cost(1, max(int(prompt_len), 1), config,
                                self._step_families(paged_step=False))

    def decode_tick_us(self, plan: ServingPlan,
                       config: Dict[str, Any]) -> Tuple[float, bool]:
        """One fused decode step at the compiled shape, amortized per cache
        token: the batch runs at ``num_slots`` whatever the occupancy."""
        t, feasible = self._shape_cost(plan.num_slots, plan.cache_len, config,
                                       self._step_families(paged_step=False))
        return t / plan.cache_len, feasible

    def paged_decode_tick_us(self, plan: ServingPlan, paged: PagedPlan,
                             ctx_tokens: int, config: Dict[str, Any]
                             ) -> Tuple[float, bool]:
        """One paged decode tick, priced at the page-quantized context the
        resident batch actually occupies (the paged kernel skips pages past
        the live span wholesale, so the attended span — not a static
        ``cache_len`` — is what costs).  Priced over the step's real family
        set: the paged kernel replaces the dense flash decode, it does not
        run alongside it, so ``flash_attention`` is dropped here exactly as
        ``paged_attention`` is dropped from dense ticks and prefills.  The
        paged model is linear in context (one query token per slot) where
        the amortized dense tick carries the quadratic relaunch — that gap,
        plus paying the page-quantized span instead of the provisioned
        ``cache_len``, is the modeled paging win."""
        ctx = paged.pages_for(ctx_tokens) * paged.page_size
        t, feasible = self._shape_cost(plan.num_slots, ctx, config,
                                       self._step_families(paged_step=True))
        return t / ctx, feasible

    def resolved_launch(self, config: Dict[str, Any]
                        ) -> Dict[str, Dict[str, Any]]:
        """The launch parameters every price in this run derives from — the
        simulator-side audit mirroring ``dispatch.record_resolutions``."""
        return {f: family_params(f, config) for f in self.families}

    # -- the event loop -------------------------------------------------

    def capacity_reason(self, trace: Trace, plan: ServingPlan,
                        paged: PagedPlan) -> str:
        """"" when every request of the trace fits the deployed cache shape;
        the infeasibility reason otherwise.  Shared with the replay
        environment so the analytic gate and the real deployment agree."""
        if paged.paging:
            if (trace.max_context > paged.slot_capacity
                    or paged.pages_for(trace.max_context) > paged.pool_pages):
                return "pages"
        elif trace.max_context > plan.cache_len:
            return "cache_len"
        return ""

    def run(self, trace: Trace, plan: ServingPlan,
            config: Optional[Dict[str, Any]] = None,
            paged: Optional[PagedPlan] = None) -> SimReport:
        """Drive ONE :class:`_FleetReplica` through the trace — the same
        stepper the fleet loop drives N of, so the scheduler iteration
        (admission, paging, chunked prefill, decode tick) exists exactly
        once.  ``paged`` defaults to ``PagedPlan.from_config(config)``:
        a config with no ``pages.*`` keys resolves to the dense reference."""
        config = config or {}
        if paged is None:
            paged = PagedPlan.from_config(config)
        n = len(trace.requests)
        if n == 0:
            raise ValueError("cannot simulate an empty trace")
        reason = self.capacity_reason(trace, plan, paged)
        if reason:
            return _infeasible(reason, n)
        decode_us, feasible = self.decode_tick_us(plan, config)
        if not feasible:
            return _infeasible("vmem", n)

        reqs = trace.requests
        rep = _FleetReplica(self, plan, config, reqs, decode_us, paged=paged,
                            stall_label="serving simulation", stall_total=n)
        for k, req in enumerate(reqs):
            a_us = req.arrival_s * 1e6
            if not rep.advance_until(a_us):
                return _infeasible(rep.infeasible_reason, n)
            rep.enqueue(k, a_us)
        if not rep.drain():
            return _infeasible(rep.infeasible_reason, n)

        done = sorted(rep.completed)       # request-index order
        lat = np.array([l for _, l in done], np.float64)
        has_lat = lat.size > 0
        makespan = max(rep.clock - reqs[0].arrival_s * 1e6, 1e-9)
        ticks = rep.ticks
        return SimReport(
            feasible=True, reason="", completed=n, ticks=ticks,
            makespan_us=makespan,
            queue_depth_mean=rep.qd_sum / max(ticks, 1),
            queue_depth_max=rep.qd_max,
            occupancy_mean=rep.occ_sum / max(ticks, 1),
            prefill_us=rep.prefill_total, decode_us=rep.decode_total,
            p50_latency_us=float(np.percentile(lat, 50)) if has_lat else 0.0,
            p99_latency_us=float(np.percentile(lat, 99)) if has_lat else 0.0,
            mean_latency_us=float(lat.mean()) if has_lat else 0.0,
            throughput_rps=n / (makespan * 1e-6),
            tokens_per_s=rep.tokens / (makespan * 1e-6),
            slo_violation_rate=(float((lat > self.slo_us).mean())
                                if has_lat else 0.0),
            page_pool_occupancy=rep.pool_occ_sum / max(ticks, 1),
            page_faults=float(rep.page_faults),
            prefill_chunks_inflight=rep.chunks_inflight_sum / max(ticks, 1))


# --------------------------------------------------------------------------
# fleet: N replica batchers behind a router
# --------------------------------------------------------------------------

#: modeled strong-scaling exponent of tensor parallelism: TP over ``m``
#: devices speeds one replica's kernels by ``m ** TP_ALPHA`` (sub-linear —
#: collectives and launch overhead eat the rest), so replica count vs TP
#: degree is a genuine trade-off the tuner has to resolve per workload
TP_ALPHA = 0.75


def tp_speedup(model_parallel: int) -> float:
    return float(model_parallel) ** TP_ALPHA


@dataclass(frozen=True)
class FleetPlan:
    """The router/replica half of a fleet serving configuration."""

    num_replicas: int = 2
    routing: str = "round_robin"
    model_parallel: int = 1

    def __post_init__(self):
        if self.num_replicas < 1 or self.model_parallel < 1:
            raise ValueError(f"malformed fleet plan {self}")
        if self.routing not in ROUTING_POLICIES:
            raise ValueError(
                f"unknown routing policy {self.routing!r}; "
                f"known: {sorted(ROUTING_POLICIES)}")

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> "FleetPlan":
        """Extract the ``fleet.*`` keys of a flat tuner configuration,
        defaulting anything unspecified."""
        kw = {}
        for f in dataclasses.fields(cls):
            key = FLEET_PREFIX + f.name
            if key in config:
                v = config[key]
                kw[f.name] = v if f.name == "routing" else int(v)
        return cls(**kw)


@dataclass(frozen=True)
class FleetSpec:
    """The deployment substrate a fleet runs on: how many devices exist and
    which of them straggle.  This is ENVIRONMENT state (what a shift
    perturbs), not a tunable — the tuner picks how to carve the devices into
    replicas, the spec says what it has to carve."""

    num_devices: int = 8
    slow_devices: Tuple[int, ...] = ()
    slowdown: float = 1.0            # slow devices run at 1/slowdown rate

    def __post_init__(self):
        if self.num_devices < 1 or self.slowdown < 1.0:
            raise ValueError(f"malformed fleet spec {self}")
        if any(d < 0 or d >= self.num_devices for d in self.slow_devices):
            raise ValueError(
                f"slow_devices {self.slow_devices} out of range for "
                f"{self.num_devices} devices")


@dataclass(frozen=True)
class FleetReport(SimReport):
    """Pooled counters of one fleet run plus the router/replica view.

    The three fleet-level counters (``routing_imbalance``,
    ``replica_queue_depth_max``, ``straggler_flagged``) are genuine
    mediators — router decisions and fleet health between configuration and
    objective — so they join :data:`FLEET_COUNTER_NAMES`; the
    latency/throughput objective clones stay excluded exactly as in
    :data:`SIM_COUNTER_NAMES`."""

    num_replicas: int = 1
    routing: str = "round_robin"
    data_parallel: int = 1
    model_parallel: int = 1
    assignments: Tuple[Tuple[int, ...], ...] = ()  # request idx per replica
    replica_ticks: Tuple[int, ...] = ()
    replica_wall_us: Tuple[float, ...] = ()
    routing_imbalance: float = 1.0   # max replica load / perfectly-even load
    replica_queue_depth_max: float = 0.0  # chosen replica backlog at routing
    straggler_flagged: int = 0
    straggler_excluded: Tuple[int, ...] = ()

    def counters(self) -> Dict[str, float]:
        c = super().counters()
        c["routing_imbalance"] = self.routing_imbalance
        c["replica_queue_depth_max"] = self.replica_queue_depth_max
        c["straggler_flagged"] = float(self.straggler_flagged)
        return c


# Fleet causal-discovery counters: the single-sim mediators plus the
# router/straggler mediators, registered as their own "fleet" group so every
# fleet-shaped surface (sim fleet, replay fleet) composes the same trio —
# and, as with SIM_COUNTER_NAMES, none of the objective-metric copies that
# :meth:`SimReport.counters` also carries.
obs_metrics.declare("routing_imbalance", group="fleet",
                    help="max replica load / perfectly-even load")
obs_metrics.declare("replica_queue_depth_max", group="fleet",
                    help="chosen-replica backlog at routing time")
obs_metrics.declare("straggler_flagged", group="fleet", kind="counter",
                    help="replicas flagged straggling during the run")

FLEET_COUNTER_NAMES: Tuple[str, ...] = obs_metrics.discovery_names(
    "serving", "fleet")


def _fleet_infeasible(reason: str, n_requests: int,
                      fleet_plan: "FleetPlan") -> FleetReport:
    base = dataclasses.asdict(_infeasible(reason, n_requests))
    return FleetReport(**base, num_replicas=fleet_plan.num_replicas,
                       routing=fleet_plan.routing,
                       model_parallel=fleet_plan.model_parallel,
                       replica_queue_depth_max=float(n_requests))


def stalled_report(n_requests: int, fleet_plan: "Optional[FleetPlan]" = None):
    """The report for a deployment that could not drain its trace within the
    tick budget (a :class:`DrainStall` escaped the event loop) — priced
    infeasible, single-sim or fleet shaped.  Public so the serving
    environments can catch the stall and keep the tuning run alive."""
    if fleet_plan is not None:
        return _fleet_infeasible("stall", n_requests, fleet_plan)
    return _infeasible("stall", n_requests)


class _FleetReplica:
    """One replica's batcher state — THE scheduler loop of the simulator.

    ``_step`` is the single implementation of the continuous-batching
    iteration (admit under the interleave policy, then one decode tick):
    :meth:`ServingSimulator.run` drives one instance and
    :class:`FleetSimulator` drives N, so the paging/chunking logic exists
    exactly once and a 1-replica fleet stays bit-identical to the single
    simulator — the regression test this stepper is held to.

    With a paging :class:`PagedPlan`, resident slots carry
    ``[request_idx, remaining, ctx_tokens, pages_held]`` against a shared
    page pool: prompt pages are allocated at admission (admission defers
    while the pool is short), one page is allocated per page-boundary
    crossing during decode, and pool exhaustion is a **page fault** resolved
    by evicting the youngest resident (the faulter itself when it is the
    youngest) back to the queue head — the oldest resident is never evicted,
    so decode always progresses.  ``prefill_chunk > 0`` additionally splits
    admission prefill into chunks, one per scheduler step, with the resident
    batch decoding underneath (no head-of-line blocking on long prompts).
    """

    def __init__(self, sim: ServingSimulator, plan: ServingPlan,
                 config: Dict[str, Any], reqs, decode_us: float, *,
                 paged: Optional[PagedPlan] = None,
                 stall_label: str = "fleet replica",
                 stall_total: Optional[int] = None,
                 trace_tid: int = 0):
        self.sim = sim
        self.plan = plan
        self.config = config
        self.reqs = reqs
        self.decode_us = decode_us
        self.paged = paged if (paged is not None and paged.paging) else None
        self.stall_label = stall_label
        self.stall_total = stall_total
        self.queue: List[int] = []
        self.resident: List[List] = []  # [idx, remaining, ctx, pages]
        self.clock = 0.0
        self.ticks = 0
        self.qd_sum = self.qd_max = self.occ_sum = 0.0
        self.prefill_total = self.decode_total = 0.0
        self.tokens = 0
        self.assigned: List[int] = []
        self.completed: List[Tuple[int, float]] = []  # (req idx, latency us)
        self.infeasible_reason = ""
        # paged pool state (inert on the dense path)
        self.free_pages = self.paged.pool_pages if self.paged else 0
        self.page_faults = 0
        self.pool_occ_sum = 0.0          # used/pool sampled per decode tick
        self.chunks_inflight_sum = 0.0   # inflight prefills per decode tick
        self.prefilling: Optional[List[int]] = None  # [idx, done_tokens, pages]
        # modeled-time tracing: the simulator track's thread id (replica
        # index in a fleet) and the per-request admit clocks — populated
        # only while a tracer is active, so the untraced run is untouched
        self.trace_tid = trace_tid
        self._admit_clock: Dict[int, float] = {}

    @property
    def backlog(self) -> int:
        """Queued + resident requests — what the router load-balances on."""
        return (len(self.queue) + len(self.resident)
                + (1 if self.prefilling is not None else 0))

    @property
    def busy(self) -> bool:
        return bool(self.queue or self.resident
                    or self.prefilling is not None)

    def enqueue(self, idx: int, arrival_us: float) -> None:
        if not self.busy:
            # idle replica: jump its clock to the arrival, mirroring the
            # single simulator's idle fast-forward
            self.clock = max(self.clock, arrival_us)
        tr = obs_trace.active()
        if tr is not None:
            tr.async_begin("sim_request", self.reqs[idx].uid,
                           cat="sim_request", track=obs_trace.TRACK_SIM,
                           ts_us=arrival_us, replica=self.trace_tid,
                           prompt_len=self.reqs[idx].prompt_len,
                           output_len=self.reqs[idx].output_len)
        self.queue.append(idx)
        self.assigned.append(idx)

    # -- paging ---------------------------------------------------------

    def _evict(self, slot: List) -> None:
        """Preempt a resident: free its pages, re-queue it at the head.  It
        restarts from scratch on re-admission — the tokens it already
        emitted are recompute, which is exactly the cost a fault carries."""
        self.free_pages += slot[3]
        self.resident.remove(slot)
        self.queue.insert(0, slot[0])

    def _grow_pages(self) -> None:
        """Allocate the +1-token page growth of every resident, faulting
        (evict the youngest) when the pool runs dry."""
        paged = self.paged
        for slot in list(self.resident):
            if slot not in self.resident:
                continue               # evicted by an earlier fault
            need = paged.pages_for(slot[2] + 1)
            while need > slot[3]:
                if self.free_pages > 0:
                    self.free_pages -= 1
                    slot[3] += 1
                    continue
                self.page_faults += 1
                victim = self.resident[-1]  # youngest; may be `slot` itself
                self._evict(victim)
                if victim is slot:
                    break

    def _finish_prefill(self, idx: int, pages: int) -> None:
        """Prompt fully prefilled: emit the first token; retire or seat."""
        reqs = self.reqs
        self.tokens += 1               # prefill emits the first token
        if reqs[idx].output_len <= 1:
            self.completed.append(
                (idx, self.clock - reqs[idx].arrival_s * 1e6))
            self.free_pages += pages   # no-op on the dense path (pages=0)
            self._trace_retire(idx)
        else:
            tr = obs_trace.active()
            if tr is not None:
                self._admit_clock[idx] = self.clock
            self.resident.append(
                [idx, reqs[idx].output_len - 1, reqs[idx].prompt_len, pages])

    def _admit(self) -> bool:
        """The admission half of one scheduler step."""
        plan, reqs, paged = self.plan, self.reqs, self.paged
        chunked = paged is not None and paged.prefill_chunk > 0
        if chunked:
            if (self.prefilling is None and self.queue
                    and (plan.interleave == "eager" or not self.resident)
                    and len(self.resident) < plan.num_slots):
                idx = self.queue[0]
                need = paged.pages_for(reqs[idx].prompt_len)
                if need <= self.free_pages:
                    self.queue.pop(0)
                    self.free_pages -= need
                    self.prefilling = [idx, 0, need]
            if self.prefilling is not None:
                # one chunk per step; residents decode underneath
                idx, done, pages = self.prefilling
                step = min(paged.prefill_chunk, reqs[idx].prompt_len - done)
                t_pref, feasible = self.sim.prefill_us(step, plan, self.config)
                if not feasible:
                    self.infeasible_reason = "vmem"
                    return False
                self.clock += t_pref
                self.prefill_total += t_pref
                tr = obs_trace.active()
                if tr is not None:
                    tr.complete("prefill_chunk", self.clock - t_pref, t_pref,
                                cat="sim_request", track=obs_trace.TRACK_SIM,
                                tid=self.trace_tid, uid=reqs[idx].uid,
                                done=done + step)
                done += step
                if done >= reqs[idx].prompt_len:
                    self.prefilling = None
                    self._finish_prefill(idx, pages)
                else:
                    self.prefilling = [idx, done, pages]
            return True
        if self.queue and (plan.interleave == "eager" or not self.resident):
            admit = min(plan.admit_chunk, plan.num_slots - len(self.resident),
                        len(self.queue))
            for _ in range(admit):
                need = 0
                if paged is not None:
                    need = paged.pages_for(reqs[self.queue[0]].prompt_len)
                    if need > self.free_pages:
                        break          # defer until residents free pages
                idx = self.queue.pop(0)
                t_pref, feasible = self.sim.prefill_us(
                    reqs[idx].prompt_len, plan, self.config)
                if not feasible:
                    self.infeasible_reason = "vmem"
                    return False
                self.clock += t_pref
                self.prefill_total += t_pref
                tr = obs_trace.active()
                if tr is not None:
                    arrival = reqs[idx].arrival_s * 1e6
                    start = self.clock - t_pref
                    tr.complete("queue", arrival, max(start - arrival, 0.0),
                                cat="sim_request", track=obs_trace.TRACK_SIM,
                                tid=self.trace_tid, uid=reqs[idx].uid)
                    tr.complete("prefill", start, t_pref, cat="sim_request",
                                track=obs_trace.TRACK_SIM, tid=self.trace_tid,
                                uid=reqs[idx].uid,
                                prompt_len=reqs[idx].prompt_len)
                self.free_pages -= need
                self._finish_prefill(idx, need)
        return True

    def _step(self) -> bool:
        """One scheduler iteration; False on a vmem-infeasible launch."""
        reqs, paged = self.reqs, self.paged
        if not self._admit():
            return False
        if self.resident:
            if self.ticks >= self.sim.max_ticks:
                total = (self.stall_total if self.stall_total is not None
                         else len(self.assigned))
                noun = ("requests" if self.stall_total is not None
                        else "assigned requests")
                raise DrainStall(
                    f"{self.stall_label} exceeded {self.sim.max_ticks} ticks "
                    f"({len(self.completed)}/{total} {noun} completed)",
                    completed=len(self.completed),
                    pending=total - len(self.completed))
            self.ticks += 1
            if paged is not None:
                self._grow_pages()
                for slot in self.resident:
                    slot[2] += 1       # the new token joins the cache
                ctx = max(slot[2] for slot in self.resident)
                d_us, feasible = self.sim.paged_decode_tick_us(
                    self.plan, paged, ctx, self.config)
                if not feasible:
                    self.infeasible_reason = "vmem"
                    return False
                self.pool_occ_sum += ((paged.pool_pages - self.free_pages)
                                      / paged.pool_pages)
                self.chunks_inflight_sum += (
                    1.0 if self.prefilling is not None else 0.0)
            else:
                d_us = self.decode_us
            self.clock += d_us
            self.decode_total += d_us
            self.occ_sum += len(self.resident)
            self.qd_sum += len(self.queue)
            self.qd_max = max(self.qd_max, float(len(self.queue)))
            self.tokens += len(self.resident)
            for slot in list(self.resident):
                slot[1] -= 1
                if slot[1] == 0:
                    idx = slot[0]
                    self.completed.append(
                        (idx, self.clock - reqs[idx].arrival_s * 1e6))
                    self.resident.remove(slot)
                    self.free_pages += slot[3]
                    self._trace_retire(idx)
        return True

    def _trace_retire(self, idx: int) -> None:
        """Close a request's modeled-time lifecycle: a decode span from
        admission to retirement, then the async end (no-op untraced)."""
        tr = obs_trace.active()
        if tr is None:
            return
        uid = self.reqs[idx].uid
        admit = self._admit_clock.pop(idx, None)
        if admit is not None:
            tr.complete("decode_resident", admit, self.clock - admit,
                        cat="sim_request", track=obs_trace.TRACK_SIM,
                        tid=self.trace_tid, uid=uid)
        tr.async_end("sim_request", uid, cat="sim_request",
                     track=obs_trace.TRACK_SIM, ts_us=self.clock,
                     latency_us=self.clock - self.reqs[idx].arrival_s * 1e6)

    def advance_until(self, t_us: float) -> bool:
        """Run scheduler iterations until the replica clock reaches ``t_us``
        or the replica drains idle — the fleet loop calls this before every
        routing decision so backlogs reflect the state at arrival time."""
        while self.busy and self.clock < t_us:
            if not self._step():
                return False
        return True

    def drain(self) -> bool:
        while self.busy:
            if not self._step():
                return False
        return True


class FleetSimulator:
    """Prices a (trace, plan, fleet plan, launch config) quadruple.

    ``fleet`` (a :class:`FleetSpec`) fixes the deployment substrate; the
    :class:`FleetPlan` carves it: ``num_devices // num_replicas`` devices per
    replica, split data-vs-model by ``runtime.elastic.viable_mesh_shape``,
    with each replica's kernels priced through its own
    :class:`ServingSimulator` whose hardware is scaled by the TP speedup and
    (for replicas whose device block contains a slow device) the straggler
    slowdown.  Arrivals are processed in global time order: every replica is
    advanced to the arrival instant, then the router places the request on
    live backlogs — so ``join_shortest_queue``/``power_of_two`` see exactly
    the state a real router would.  Deterministic: the power-of-two sampler
    is seeded from the trace realization and replica count.
    """

    def __init__(self, cell: KernelWorkload, families: Iterable[str], *,
                 hardware: Optional[HardwareSpec] = None,
                 slo_us: float = 2_000.0, max_ticks: int = 200_000,
                 fleet: Optional[FleetSpec] = None):
        self.cell = cell
        self.families = tuple(sorted(families))
        measure_mod._check_modeled(self.families)
        self.hardware = hardware or HardwareSpec()
        self.slo_us = float(slo_us)
        self.max_ticks = int(max_ticks)
        self.fleet = fleet or FleetSpec()

    # -- replica construction -------------------------------------------

    def mesh_split(self, fleet_plan: FleetPlan) -> Tuple[int, int]:
        """(data, model) split of one replica's device block."""
        from repro_torch.runtime.elastic import viable_mesh_shape

        per_replica = self.fleet.num_devices // fleet_plan.num_replicas
        return viable_mesh_shape(per_replica, fleet_plan.model_parallel)

    def replica_hardware(self, fleet_plan: FleetPlan) -> List[HardwareSpec]:
        """Per-replica hardware: TP speedup, divided by the straggler
        slowdown for replicas whose contiguous device block
        ``[r*dpr, (r+1)*dpr)`` contains a slow device."""
        spec = self.fleet
        dpr = spec.num_devices // fleet_plan.num_replicas
        _, model = self.mesh_split(fleet_plan)
        slow = set(spec.slow_devices)
        out = []
        for r in range(fleet_plan.num_replicas):
            s = tp_speedup(model)
            if any(d in slow for d in range(r * dpr, (r + 1) * dpr)):
                s /= spec.slowdown
            out.append(self.hardware.scaled(s, s, s))
        return out

    # -- routing --------------------------------------------------------

    @staticmethod
    def _route(k: int, replicas: List[_FleetReplica], policy: str,
               rng: Optional[np.random.Generator]) -> int:
        n = len(replicas)
        if policy == "round_robin" or n == 1:
            return k % n
        if policy == "join_shortest_queue":
            # deterministic tie-break: lowest replica index
            return min(range(n), key=lambda r: (replicas[r].backlog, r))
        if policy == "power_of_two":
            pair = rng.choice(n, size=2, replace=False)
            lo, hi = int(min(pair)), int(max(pair))
            if replicas[hi].backlog < replicas[lo].backlog:
                return hi
            return lo                  # tie -> lower index
        raise ValueError(f"unknown routing policy {policy!r}; "
                         f"known: {sorted(ROUTING_POLICIES)}")

    # -- the fleet event loop -------------------------------------------

    def run(self, trace: Trace, plan: ServingPlan,
            fleet_plan: Optional[FleetPlan] = None,
            config: Optional[Dict[str, Any]] = None,
            paged: Optional[PagedPlan] = None) -> FleetReport:
        config = config or {}
        fleet_plan = fleet_plan or FleetPlan()
        if paged is None:
            paged = PagedPlan.from_config(config)
        n = len(trace.requests)
        if n == 0:
            raise ValueError("cannot simulate an empty trace")
        if fleet_plan.num_replicas > self.fleet.num_devices:
            return _fleet_infeasible("devices", n, fleet_plan)

        data, model = self.mesh_split(fleet_plan)
        sims = [ServingSimulator(self.cell, self.families, hardware=hw,
                                 slo_us=self.slo_us, max_ticks=self.max_ticks)
                for hw in self.replica_hardware(fleet_plan)]
        reason = sims[0].capacity_reason(trace, plan, paged)
        if reason:
            return _fleet_infeasible(reason, n, fleet_plan)
        decode_us = []
        for sim in sims:
            d_us, feasible = sim.decode_tick_us(plan, config)
            if not feasible:
                return _fleet_infeasible("vmem", n, fleet_plan)
            decode_us.append(d_us)

        reqs = trace.requests
        replicas = [_FleetReplica(sim, plan, config, reqs, d, paged=paged,
                                  trace_tid=r)
                    for r, (sim, d) in enumerate(zip(sims, decode_us))]
        # the po2 sampler is part of the environment realization: seed it
        # from the trace identity + replica count so the same (trace,
        # config) pair always draws the same probe sequence
        rng = (np.random.default_rng(
                   [trace.seed, zlib.crc32(trace.spec.encode()),
                    fleet_plan.num_replicas])
               if fleet_plan.routing == "power_of_two" else None)

        routed_backlog_max = 0.0
        for k, req in enumerate(reqs):
            a_us = req.arrival_s * 1e6
            for rep in replicas:
                if not rep.advance_until(a_us):
                    return _fleet_infeasible("vmem", n, fleet_plan)
            r = self._route(k, replicas, fleet_plan.routing, rng)
            routed_backlog_max = max(routed_backlog_max,
                                     float(replicas[r].backlog))
            replicas[r].enqueue(k, a_us)
        for rep in replicas:
            if not rep.drain():
                return _fleet_infeasible("vmem", n, fleet_plan)

        # -- pool the per-replica counters ------------------------------
        total_ticks = sum(rep.ticks for rep in replicas)
        done = sorted(pair for rep in replicas for pair in rep.completed)
        lat = np.array([l for _, l in done], np.float64)
        has_lat = lat.size > 0
        t0 = reqs[0].arrival_s * 1e6
        makespan = max(max(rep.clock for rep in replicas if rep.assigned)
                       - t0, 1e-9)
        tokens = sum(rep.tokens for rep in replicas)
        imbalance = (max(len(rep.assigned) for rep in replicas)
                     / (n / fleet_plan.num_replicas))

        # feed the straggler monitor the realized per-replica decode tick
        # times (replicas that never ticked are absent — partial reports)
        from repro_torch.runtime.straggler import StragglerMonitor  # lazy
        monitor = StragglerMonitor(fleet_plan.num_replicas)
        step_times = {r: rep.decode_total / rep.ticks
                      for r, rep in enumerate(replicas) if rep.ticks > 0}
        if step_times:
            for _ in range(monitor.patience):
                monitor.report(step_times)

        return FleetReport(
            feasible=True, reason="", completed=n, ticks=total_ticks,
            makespan_us=makespan,
            queue_depth_mean=sum(rep.qd_sum for rep in replicas)
            / max(total_ticks, 1),
            queue_depth_max=max(rep.qd_max for rep in replicas),
            occupancy_mean=sum(rep.occ_sum for rep in replicas)
            / max(total_ticks, 1),
            prefill_us=sum(rep.prefill_total for rep in replicas),
            decode_us=sum(rep.decode_total for rep in replicas),
            p50_latency_us=float(np.percentile(lat, 50)) if has_lat else 0.0,
            p99_latency_us=float(np.percentile(lat, 99)) if has_lat else 0.0,
            mean_latency_us=float(lat.mean()) if has_lat else 0.0,
            throughput_rps=n / (makespan * 1e-6),
            tokens_per_s=tokens / (makespan * 1e-6),
            slo_violation_rate=(float((lat > self.slo_us).mean())
                                if has_lat else 0.0),
            page_pool_occupancy=sum(rep.pool_occ_sum for rep in replicas)
            / max(total_ticks, 1),
            page_faults=float(sum(rep.page_faults for rep in replicas)),
            prefill_chunks_inflight=sum(rep.chunks_inflight_sum
                                        for rep in replicas)
            / max(total_ticks, 1),
            num_replicas=fleet_plan.num_replicas, routing=fleet_plan.routing,
            data_parallel=data, model_parallel=model,
            assignments=tuple(tuple(rep.assigned) for rep in replicas),
            replica_ticks=tuple(rep.ticks for rep in replicas),
            replica_wall_us=tuple(rep.clock for rep in replicas),
            routing_imbalance=imbalance,
            replica_queue_depth_max=routed_backlog_max,
            straggler_flagged=len(monitor.flagged()),
            straggler_excluded=tuple(monitor.excluded()))
