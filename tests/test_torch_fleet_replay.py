"""Fleet replay of the port against the JAX reference, on the CPU.

``ReplayServingEnv(fleet=True)``: the analytic fleet simulator routes the
pinned trace (``FleetReport.assignments``, ``routing_imbalance``,
``replica_queue_depth_max``), the trace splits into one sub-trace per
replica, each sub-trace replays on the deployed batcher, and the replicas'
reports pool into one measurement.  With the reference's tiny replay model
and its weights carried across, and the reference's kernel cell and
hardware constants handed to the port, the routing, the sub-traces, every
replica's schedule and tokens, and the pooled counters that do not read the
clock equal the reference's bit for bit.  The wall-clock counters
(``latency``, ``throughput``, ``prefill_decode_ratio``,
``straggler_flagged``) are held to be finite and well formed.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.envs.replay_env import _built_model as jbuilt_model
from repro.envs.replay_env import default_replay_model as jdefault_model
from repro.envs.replay_env import make_sim2real_pair as jmake_sim2real_pair
from repro.serving.replay import replay_trace as jreplay_trace
from repro.workloads.sim import FleetPlan as JFleetPlan
from repro.workloads.sim import ServingPlan as JServingPlan
from repro_torch.envs.measure import HardwareSpec, KernelWorkload
from repro_torch.envs.replay_env import (REPLAY_FLEET_COUNTER_NAMES,
                                         ReplayServingEnv,
                                         default_replay_model,
                                         make_sim2real_pair)
from repro_torch.envs.serving_env import ServingEnv
from repro_torch.models.interop import params_from_jax
from repro_torch.serving.replay import replay_trace
from repro_torch.workloads import FleetPlan, ServingPlan
from torch_reference_geometry import reference_geometry  # noqa: F401

# every test drives the module's parity pair, whose simulators cache the
# prices they take: all of them price through the reference's geometry
pytestmark = pytest.mark.usefixtures("reference_geometry")

torch.set_num_threads(1)

#: about 20 requests at trace seed 0: enough for the routers to differ
SPEC = ("poisson:rate=2000,horizon=0.01,mean_prompt=5,mean_output=3,"
        "max_len=12")
NUM_DEVICES = 4
#: report fields that are functions of the schedule alone
DETERMINISTIC = ("completed", "rejected", "ticks", "tokens",
                 "mean_occupancy", "queue_depth_mean", "queue_depth_max",
                 "page_pool_occupancy", "page_faults",
                 "prefill_chunks_inflight", "rejected_too_long")
#: pooled counters that read the clock
WALL = ("latency", "throughput", "prefill_decode_ratio", "straggler_flagged")
FLEETS = [
    dict(),
    {"fleet.num_replicas": 2, "fleet.routing": "join_shortest_queue"},
    {"fleet.num_replicas": 4, "fleet.routing": "power_of_two",
     "serving.num_slots": 2},
    {"fleet.num_replicas": 4, "fleet.routing": "round_robin",
     "fleet.model_parallel": 2, "serving.interleave": "drain"},
    {"fleet.num_replicas": 2, "fleet.routing": "join_shortest_queue",
     "pages.paging": "on", "pages.pool_pages": 64,
     "paged_attention.page_size": 32, "paged_attention.pages_per_slot_max": 4},
]


@pytest.fixture(scope="module")
def pair():
    """The reference's fleet target, and the port's over the same trace,
    kernel cell, hardware constants and weights."""
    _, jtgt = jmake_sim2real_pair(SPEC, seed=0, trace_seed=0, repeats=1,
                                  fleet=True, num_devices=NUM_DEVICES)
    _, _, jparams = jbuilt_model(jdefault_model(), 0)
    params = params_from_jax(jax.tree.map(np.array, jparams),
                             default_replay_model(), device="cpu")
    tgt = ReplayServingEnv(
        SPEC, families=jtgt.families, seed=2, trace_seed=0,
        cell=KernelWorkload(**dataclasses.asdict(jtgt.cell)),
        hardware=HardwareSpec(**dataclasses.asdict(jtgt.hardware)),
        repeats=1, fleet=True, num_devices=NUM_DEVICES, device="cpu",
        params=params)
    assert [dataclasses.astuple(r) for r in tgt.trace.requests] == \
        [dataclasses.astuple(r) for r in jtgt.trace.requests]
    return jtgt, tgt


def _config(env, over):
    return dict(env.space.default_config(), **over)


def _fields(report):
    return {k: getattr(report, k) for k in DETERMINISTIC}


def _ref_fleet_replay(jtgt, cfg):
    """The reference's ``_member_result`` fleet branch, taken apart: the
    route, and each replica's report on one warmed batcher."""
    plan = JServingPlan.from_config(cfg)
    route = jtgt._fleet_route(cfg, plan, JFleetPlan.from_config(cfg))
    key = jtgt._deploy_key(plan, cfg)
    batcher = jtgt._fresh_batcher(*key)
    jtgt._warm_deployment(batcher, key[3])
    batcher.interleave = plan.interleave
    reports = [jreplay_trace(batcher, st, admit_chunk=plan.admit_chunk,
                             ticks_per_s=jtgt.ticks_per_s, seed=0,
                             max_ticks=jtgt.max_ticks)
               for st in jtgt._subtraces(route.assignments)
               if st is not None]
    return route, reports, batcher


@pytest.mark.parametrize("over", FLEETS, ids=range(len(FLEETS)))
def test_fleet_routing_subtraces_and_replicas_match_reference(pair, over):
    jtgt, tgt = pair
    cfg = _config(jtgt, over)
    assert tgt.infeasible_reason(cfg) == jtgt.infeasible_reason(cfg) == ""
    plan = ServingPlan.from_config(cfg)
    route = tgt._fleet_route(cfg, plan, FleetPlan.from_config(cfg))
    jroute, jreports, jbatcher = _ref_fleet_replay(jtgt, cfg)
    assert route.feasible and jroute.feasible
    assert route.assignments == jroute.assignments
    assert route.routing_imbalance == jroute.routing_imbalance
    assert route.replica_queue_depth_max == jroute.replica_queue_depth_max
    assert sum(map(len, route.assignments)) == len(tgt.trace.requests)
    subs, jsubs = tgt._subtraces(route.assignments), \
        jtgt._subtraces(jroute.assignments)
    assert [None if s is None else s.spec for s in subs] == \
        [None if s is None else s.spec for s in jsubs]
    assert [None if s is None else
            [dataclasses.astuple(r) for r in s.requests] for s in subs] == \
        [None if s is None else
         [dataclasses.astuple(r) for r in s.requests] for s in jsubs]

    key = tgt._deploy_key(plan, cfg)
    batcher = tgt._fresh_batcher(*key)
    tgt._warm_deployment(batcher, key[3])
    batcher.interleave = plan.interleave
    got_route, reports = tgt.fleet_replay(batcher, cfg, plan)
    assert got_route.assignments == route.assignments
    assert [_fields(r) for r in reports] == [_fields(r) for r in jreports]
    assert [rs.request.uid for rs in batcher.completed] == \
        [rs.request.uid for rs in jbatcher.completed]
    assert [rs.generated for rs in batcher.completed] == \
        [[int(t) for t in rs.generated] for rs in jbatcher.completed]
    # the monitor reads each replica's measured decode time per tick
    assert all(r.decode_s > 0 and r.ticks > 0 for r in reports)


@pytest.mark.parametrize("over", FLEETS[:4], ids=range(4))
def test_fleet_intervene_pooled_counters_match_reference(pair, over):
    jtgt, tgt = pair
    cfg = _config(jtgt, over)
    jc, jy = jtgt.intervene(cfg)
    c, y = tgt.intervene(cfg)
    assert set(c) == set(jc)
    assert {k: v for k, v in c.items() if k not in WALL} == \
        {k: v for k, v in jc.items() if k not in WALL}
    assert np.isfinite(y) and y > 0 and y == c["latency"]
    for k in WALL:
        assert np.isfinite(c[k]) and c[k] >= 0, k
    assert c["straggler_flagged"] == int(c["straggler_flagged"]) <= \
        FleetPlan.from_config(cfg).num_replicas
    assert tgt.measured_captures == 0


def test_fleet_surface_and_devices_gate_match_reference(pair):
    jtgt, tgt = pair
    assert tuple(tgt.counter_names) == tuple(jtgt.counter_names) == \
        REPLAY_FLEET_COUNTER_NAMES
    assert tgt.space.names == jtgt.space.names
    assert tgt.batch_share_dims == jtgt.batch_share_dims
    assert not any(d.startswith("fleet.") for d in tgt.batch_share_dims)
    for over in ({"fleet.num_replicas": 4}, {"fleet.num_replicas": 8},
                 {"fleet.num_replicas": 8, "serving.cache_len": 128}):
        cfg = _config(jtgt, over)
        assert tgt.infeasible_reason(cfg) == jtgt.infeasible_reason(cfg)
    cfg = _config(jtgt, {"fleet.num_replicas": 8})
    assert tgt.infeasible_reason(cfg) == "devices"
    c, y = tgt.intervene(cfg)
    jc, jy = jtgt.intervene(cfg)
    assert y == jy == float("inf") and c == jc
    assert c["routing_imbalance"] == 1.0
    assert c["replica_queue_depth_max"] == len(tgt.trace.requests)


def test_fleet_intervene_batch_matches_sequential(pair):
    _, tgt = pair
    configs = [_config(tgt, over) for over in FLEETS[:4]]
    configs.append(_config(tgt, {"fleet.num_replicas": 8}))
    seq = [tgt._measure(c) for c in configs]
    bat = tgt.intervene_batch(configs)
    for (c1, y1), (c2, y2) in zip(seq, bat):
        assert {k: v for k, v in c1.items() if k not in WALL} == \
            {k: v for k, v in c2.items() if k not in WALL}
        assert np.isfinite(y1) == np.isfinite(y2)
    assert bat[-1][1] == float("inf")


def test_fleet_pair_shares_space_trace_and_devices(pair):
    jtgt, _ = pair
    src, tgt = make_sim2real_pair(SPEC, seed=0, trace_seed=0, device="cpu",
                                  params=pair[1].params, repeats=1,
                                  fleet=True, num_devices=NUM_DEVICES)
    assert isinstance(src, ServingEnv) and isinstance(tgt, ReplayServingEnv)
    assert src.fleet and tgt.fleet
    assert src.fleet_spec.num_devices == tgt.num_devices == NUM_DEVICES
    assert src.space.names == tgt.space.names == jtgt.space.names
    assert src.trace == tgt.trace
    assert [dataclasses.astuple(r) for r in tgt.trace.requests] == \
        [dataclasses.astuple(r) for r in jtgt.trace.requests]
