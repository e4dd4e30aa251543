"""Drive the real :class:`ContinuousBatcher` from a generated request trace.

This is the deployment end of the serving-workload loop: the simulator
(:mod:`repro_torch.workloads.sim`) tunes the serving stack against a trace, and
this module replays the same trace through the actual prefill/decode steps
of the port's batcher under the tuned plan.  Trace arrival times (seconds of modeled time)
map onto batcher ticks through ``ticks_per_s``; by default the span of the
trace maps to roughly the number of decode ticks its tokens need, so the
offered load is preserved.

The admission chunk is honored here — at most ``admit_chunk`` requests are
released into the batcher's queue per tick — because the batcher itself
admits greedily into every free slot.

All statistics are **per replay**: counters snapshot the batcher's lifetime
state (``completed``, ticks, occupancy, prefill/decode wall time) at entry
and report only this replay's deltas, so a reused batcher (e.g. a
default-vs-tuned comparison on one deployment) never counts pre-replay
completions.

Wall times cover the device's work: the port's batcher synchronizes the
device at the end of every prefill and decode step, and reads each tick's
tokens back to the host before it retires requests.
"""

from __future__ import annotations

from dataclasses import dataclass
from time import perf_counter
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import trace as obs_trace
from repro_torch.serving.scheduler import ContinuousBatcher, DrainStall, Request
from repro_torch.workloads.traces import Trace


@dataclass(frozen=True)
class ReplayReport:
    """Wall-clock statistics from one real-batcher trace replay.

    Every field covers only the replay that produced the report — a batcher
    that already served other traffic contributes nothing to these counts.
    """

    completed: int
    rejected: int                  # did not fit prompt+output in the cache
    ticks: int
    wall_s: float
    tokens: int
    mean_occupancy: float
    p50_latency_ms: float          # submit -> finish, wall clock
    p99_latency_ms: float
    queue_depth_mean: float = 0.0  # batcher queue depth sampled per tick
    queue_depth_max: float = 0.0
    prefill_s: float = 0.0         # wall time inside prefill launches
    decode_s: float = 0.0          # wall time inside decode launches
    latencies_ms: Tuple[float, ...] = ()  # per-request, completion order
    # paged-KV mediators, name-compatible with the simulator's; all zero for
    # dense deployments
    page_pool_occupancy: float = 0.0   # mean fraction of the pool in use
    page_faults: float = 0.0           # always 0: the real batcher defers
    prefill_chunks_inflight: float = 0.0
    rejected_too_long: int = 0     # batcher-side PromptTooLong rejections

    @property
    def prefill_decode_ratio(self) -> float:
        return self.prefill_s / max(self.decode_s, 1e-9)

    @property
    def throughput_rps(self) -> float:
        """Completed requests per wall-clock second of this replay."""
        return self.completed / max(self.wall_s, 1e-9)

    @property
    def rejected_rate(self) -> float:
        return self.rejected / max(self.rejected + self.completed, 1)

    def slo_violation_rate(self, slo_ms: float) -> float:
        if not self.latencies_ms:
            return 0.0
        return float(np.mean(np.asarray(self.latencies_ms) > slo_ms))

    def counters(self, slo_ms: float = float("inf")) -> Dict[str, float]:
        """The measurement's metrics dict, name-compatible with
        :meth:`repro_torch.workloads.sim.SimReport.counters` so a simulator-trained
        causal model transfers onto replay measurements.  ``latency`` /
        ``throughput`` are objective clones for query constraints — like the
        simulator's they stay OUT of the discovery counter names."""
        return {
            "queue_depth_mean": self.queue_depth_mean,
            "queue_depth_max": self.queue_depth_max,
            "occupancy_mean": self.mean_occupancy,
            "prefill_decode_ratio": self.prefill_decode_ratio,
            "slo_violation_rate": self.slo_violation_rate(slo_ms),
            "page_pool_occupancy": self.page_pool_occupancy,
            "page_faults": self.page_faults,
            "prefill_chunks_inflight": self.prefill_chunks_inflight,
            "rejected_rate": self.rejected_rate,
            "rejected_too_long": float(self.rejected_too_long),
            "latency": self.p99_latency_ms,
            "throughput": self.throughput_rps,
        }


def default_ticks_per_s(trace: Trace, num_slots: int) -> float:
    """Map the trace span onto roughly the decode ticks its tokens need, so
    the replayed arrival process keeps the trace's load shape."""
    est_ticks = max(trace.total_output_tokens / max(num_slots, 1), 1.0)
    span = max(trace.span_s, 1e-9)
    return est_ticks / span


def trace_requests(trace: Trace, vocab_size: int, cache_len: int,
                   seed: Optional[int] = None) -> List[Request]:
    """Materialize the trace as batcher ``Request``s with seeded random
    token prompts.  Requests that cannot fit (prompt + output > cache_len)
    are dropped here — the simulator calls such a plan infeasible; the
    replay counts them as rejected."""
    rng = np.random.default_rng(trace.seed if seed is None else seed)
    out: List[Request] = []
    for r in trace.requests:
        if r.prompt_len + r.output_len > cache_len:
            continue
        prompt = rng.integers(0, vocab_size, size=r.prompt_len,
                              dtype=np.int32)
        out.append(Request(uid=r.uid, prompt=prompt,
                           max_new_tokens=r.output_len))
    return out


def replay_trace(batcher: ContinuousBatcher, trace: Trace, *,
                 admit_chunk: int = 4, ticks_per_s: Optional[float] = None,
                 seed: Optional[int] = None,
                 max_ticks: int = 100_000) -> ReplayReport:
    """Feed ``trace`` through ``batcher`` tick by tick and drain it.

    Deterministic given (batcher state, trace, seed): arrivals release in
    trace order at their mapped tick, at most ``admit_chunk`` per tick.
    Raises :class:`DrainStall` if the trace does not finish in ``max_ticks``;
    the stall's ``completed``/``pending`` count only this replay's requests.
    """
    if ticks_per_s is None:
        ticks_per_s = default_ticks_per_s(trace, batcher.num_slots)
    requests = trace_requests(trace, batcher.model.cfg.vocab_size,
                              batcher.cache_len, seed=seed)
    rejected = len(trace.requests) - len(requests)
    fitting = {r.uid for r in requests}
    arrival_tick = {r.uid: int(r.arrival_s * ticks_per_s)
                    for r in trace.requests if r.uid in fitting}

    # entry snapshots: everything reported below is a delta against these,
    # so a reused batcher's earlier traffic never leaks into this report
    start_completed = len(batcher.completed)
    start_ticks = batcher.ticks
    start_occupancy = batcher._occupancy_sum
    start_prefill_s = batcher.prefill_s
    start_decode_s = batcher.decode_s
    start_too_long = batcher.rejected_too_long
    start_pool_occ = batcher._pool_occ_sum
    start_chunks = batcher._chunks_inflight_sum

    # repro: ignore[wall-clock] -- replay wall accounting (per-request latency, replay wall time), allow-listed in the reference's replay.py
    t0 = perf_counter()
    submit_wall: Dict[int, float] = {}
    qd_sum, qd_max = 0.0, 0.0
    i, tick = 0, 0
    replay_span = obs_trace.span("replay", cat="replay",
                                 n_requests=len(requests), rejected=rejected,
                                 admit_chunk=admit_chunk)
    with replay_span:
        while i < len(requests) or batcher.queue or \
                batcher._prefilling is not None or any(
                s is not None for s in batcher._slots):
            released = 0
            while (i < len(requests) and released < admit_chunk
                   and arrival_tick[requests[i].uid] <= tick):
                # repro: ignore[wall-clock] -- replay wall accounting (per-request latency, replay wall time), allow-listed in the reference's replay.py
                submit_wall[requests[i].uid] = perf_counter()
                batcher.submit(requests[i])
                i += 1
                released += 1
            stepped = batcher.tick()
            tick += 1
            if stepped:
                qd_sum += len(batcher.queue)
                qd_max = max(qd_max, float(len(batcher.queue)))
            elif not batcher.queue and batcher._prefilling is None \
                    and i < len(requests):
                # idle: jump to the next arrival instead of spinning
                tick = max(tick, arrival_tick[requests[i].uid])
            if tick > max_ticks:
                done_here = len(batcher.completed) - start_completed
                pending = (len(requests) - i + len(batcher.queue)
                           + (batcher._prefilling is not None)
                           + sum(s is not None for s in batcher._slots))
                raise DrainStall(
                    f"trace replay not drained after {max_ticks} ticks "
                    f"({done_here} completed, {pending} pending)",
                    completed=done_here, pending=pending)
        replay_span.set(completed=len(batcher.completed) - start_completed,
                        ticks=batcher.ticks - start_ticks)

    done = batcher.completed[start_completed:]
    ticks_replay = batcher.ticks - start_ticks
    lat_ms = tuple(
        float((rs.finished_at - submit_wall[rs.request.uid]) * 1e3)
        for rs in done if rs.request.uid in submit_wall)
    lat = np.asarray(lat_ms)
    tokens = sum(len(rs.generated) for rs in done)
    too_long_here = batcher.rejected_too_long - start_too_long
    return ReplayReport(
        completed=len(done), rejected=rejected + too_long_here,
        # repro: ignore[wall-clock] -- replay wall accounting (per-request latency, replay wall time), allow-listed in the reference's replay.py
        ticks=ticks_replay, wall_s=perf_counter() - t0,
        tokens=tokens,
        mean_occupancy=((batcher._occupancy_sum - start_occupancy)
                        / max(ticks_replay, 1)),
        p50_latency_ms=float(np.percentile(lat, 50)) if len(lat) else 0.0,
        p99_latency_ms=float(np.percentile(lat, 99)) if len(lat) else 0.0,
        queue_depth_mean=qd_sum / max(ticks_replay, 1),
        queue_depth_max=qd_max,
        prefill_s=batcher.prefill_s - start_prefill_s,
        decode_s=batcher.decode_s - start_decode_s,
        latencies_ms=lat_ms,
        page_pool_occupancy=((batcher._pool_occ_sum - start_pool_occ)
                             / max(ticks_replay, 1)),
        prefill_chunks_inflight=((batcher._chunks_inflight_sum - start_chunks)
                                 / max(ticks_replay, 1)),
        rejected_too_long=too_long_here)
