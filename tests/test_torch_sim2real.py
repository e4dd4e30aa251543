"""The sim-to-real loop of the port against the JAX reference, on the CPU.

Trace replay through the port's continuous batcher gives the reference's
completion order, tick count, generated tokens and every deterministic
counter (wall-clock fields excluded) — dense, paged with chunked prefill,
and drain admission — with the reference's ``default_replay_model``
weights carried across.  Then the environments: ``make_sim2real_pair``
shares space and trace, the infeasibility gates are analytic and
direction-aware, ``intervene_batch`` measures what sequential intervention
measures, simulator-source -> replay-target ``transfer_tune`` runs end to
end, and the serve launcher's ``--workload ... --sim2real-eval`` prints
both sides (its predicted half is the port simulator's own ``run``) and
refuses to fall back to the CPU when no GPU is asked for.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.envs.replay_env import _built_model as jbuilt_model
from repro.envs.replay_env import default_replay_model as jdefault_model
from repro.envs.replay_env import make_sim2real_pair as jmake_sim2real_pair
from repro.serving.paging import PagedPlan as JPagedPlan
from repro.serving.replay import replay_trace as jreplay_trace
from repro.serving.scheduler import ContinuousBatcher as JBatcher
from repro.workloads import make_workload as jmake_workload
from repro_torch.envs import measure as measure_mod
from repro_torch.envs.measure import KernelWorkload
from repro_torch.envs.replay_env import (REPLAY_COUNTER_NAMES,
                                         REPLAY_FLEET_COUNTER_NAMES,
                                         ReplayServingEnv,
                                         default_replay_model,
                                         make_sim2real_pair)
from repro_torch.envs.serving_env import ServingEnv
from repro_torch.models.interop import params_from_jax
from repro_torch.serving.paging import PagedPlan
from repro_torch.serving.replay import default_ticks_per_s, replay_trace
from repro_torch.serving.scheduler import ContinuousBatcher
from repro_torch.tuner.runner import transfer_tune
from repro_torch.workloads import (SIM_COUNTER_NAMES, RequestSpec,
                                   ServingPlan, Trace, make_workload)
from torch_reference_geometry import reference_geometry  # noqa: F401

torch.set_num_threads(1)

SPEC = ("poisson:rate=1200,horizon=0.003,mean_prompt=5,mean_output=3,"
        "max_len=12")
#: report fields that are functions of the schedule alone
DETERMINISTIC = ("completed", "rejected", "ticks", "tokens",
                 "mean_occupancy", "queue_depth_mean", "queue_depth_max",
                 "page_pool_occupancy", "page_faults",
                 "prefill_chunks_inflight", "rejected_too_long")


@pytest.fixture(scope="module")
def weights():
    """The reference's replay deployment, and its weights on the port."""
    jmodel, jrun, jparams = jbuilt_model(jdefault_model(), 0)
    params = params_from_jax(jax.tree.map(np.array, jparams),
                             default_replay_model(), device="cpu")
    return (jmodel, jrun, jparams), params


def _env(weights, spec=SPEC, **kw):
    kw.setdefault("repeats", 1)
    return ReplayServingEnv(spec, seed=0, trace_seed=0, device="cpu",
                            params=weights[1], **kw)


def _report_fields(report):
    return {k: getattr(report, k) for k in DETERMINISTIC}


@pytest.mark.parametrize("plan,paged", [
    (dict(num_slots=2, cache_len=32), None),
    (dict(num_slots=4, cache_len=32, interleave="drain"), None),
    (dict(num_slots=2, cache_len=32),
     dict(paging="on", pool_pages=12, page_size=8, pages_per_slot_max=4,
          prefill_chunk=4)),
])
def test_replay_is_the_reference_schedule_and_tokens(weights, plan, paged):
    (jmodel, jrun, jparams), params = weights
    env = _env(weights)
    spec = "poisson:rate=2000,horizon=0.005,mean_prompt=6,mean_output=4," \
           "max_len=14"
    jpaged = JPagedPlan(**paged) if paged else None
    tpaged = PagedPlan(**paged) if paged else None
    jb = JBatcher(jmodel, jrun, jparams, paged=jpaged, on_too_long="reject",
                  **plan)
    tb = ContinuousBatcher(env.model, env.run, params, paged=tpaged,
                           on_too_long="reject", **plan)
    ref = jreplay_trace(jb, jmake_workload(spec).generate(4), admit_chunk=2,
                        seed=4)
    out = replay_trace(tb, make_workload(spec).generate(4), admit_chunk=2,
                       seed=4)
    assert _report_fields(out) == _report_fields(ref)
    assert out.completed > 5
    assert [rs.request.uid for rs in tb.completed] == \
        [rs.request.uid for rs in jb.completed]
    assert [rs.generated for rs in tb.completed] == \
        [[int(t) for t in rs.generated] for rs in jb.completed]
    assert tb.prefill_chunks == jb.prefill_chunks
    # the wall-clock fields exist and are sane
    assert out.wall_s > 0 and len(out.latencies_ms) == out.completed
    assert out.p99_latency_ms >= out.p50_latency_ms > 0


@pytest.mark.usefixtures("reference_geometry")
def test_env_replay_counters_match_the_reference_env(weights):
    _, tgt = jmake_sim2real_pair(SPEC, seed=0, trace_seed=0, repeats=1)
    env = _env(weights)
    for over in ({}, {"serving.num_slots": 2},
                 {"serving.num_slots": 2, "serving.interleave": "drain"}):
        cfg = dict(tgt.space.default_config(), **over)
        ref, out = tgt.replay(cfg), env.replay(cfg)
        assert _report_fields(out) == _report_fields(ref), over


def test_pair_shares_space_and_trace(weights):
    src, tgt = make_sim2real_pair(SPEC, seed=0, trace_seed=0, device="cpu",
                                  params=weights[1], repeats=1)
    jsrc, jtgt = jmake_sim2real_pair(SPEC, seed=0, trace_seed=0, repeats=1)
    assert isinstance(src, ServingEnv) and isinstance(tgt, ReplayServingEnv)
    assert src.space.names == tgt.space.names == jtgt.space.names
    assert src.trace == tgt.trace
    assert [dataclasses.astuple(r) for r in tgt.trace.requests] == \
        [dataclasses.astuple(r) for r in jtgt.trace.requests]
    assert set(SIM_COUNTER_NAMES) <= set(tgt.counter_names)
    assert tgt.counter_names == REPLAY_COUNTER_NAMES == jtgt.counter_names
    assert tgt.batch_share_dims == jtgt.batch_share_dims
    assert tgt.ticks_per_s == jtgt.ticks_per_s == default_ticks_per_s(
        tgt.trace, ServingPlan().num_slots)
    assert tgt.query_text == "minimize latency within {budget} samples"


def test_replay_counter_names_match_the_reference():
    from repro.envs.replay_env import REPLAY_COUNTER_NAMES as JREPLAY
    from repro.envs.replay_env import REPLAY_FLEET_COUNTER_NAMES as JFLEET

    assert REPLAY_COUNTER_NAMES == JREPLAY
    assert REPLAY_FLEET_COUNTER_NAMES == JFLEET


def test_measurement_is_finite_and_its_schedule_deterministic(weights):
    env = _env(weights)
    cfg = env.space.default_config()
    c1, y1 = env.intervene(cfg)
    c2, y2 = env.intervene(cfg)
    assert np.isfinite(y1) and y1 > 0 and np.isfinite(y2)
    assert set(REPLAY_COUNTER_NAMES) <= set(c1)
    for name in ("queue_depth_mean", "queue_depth_max", "occupancy_mean",
                 "rejected_rate"):
        assert c1[name] == c2[name], name


def test_infeasible_gates_are_analytic_and_direction_aware(weights):
    long_trace = Trace("k", "k", 0, (RequestSpec(0, 0.0, 120, 20),))
    tgt = _env(weights, spec=long_trace)
    small = dict(tgt.space.default_config(), **{"serving.cache_len": 128})
    assert tgt.infeasible_reason(small) == "cache_len"
    counters, y = tgt.intervene(small)       # gated before any batcher runs
    assert y == float("inf") and counters["rejected_rate"] == 1.0
    tgt_max = _env(weights, spec=long_trace, objective="throughput")
    assert tgt_max.intervene(small)[1] == float("-inf")
    assert "maximize throughput" in tgt_max.query_text
    tiny = _env(weights, spec=long_trace,
                cell=dataclasses.replace(KernelWorkload(), vmem_limit=1))
    big = dict(tgt.space.default_config(), **{"serving.cache_len": 2048})
    assert tiny.infeasible_reason(big) == "vmem"
    with pytest.raises(ValueError, match="unknown serving objective"):
        _env(weights, spec=long_trace, objective="energy")


def test_intervene_batch_matches_sequential_intervention(weights):
    env_b = _env(weights)
    base = env_b.space.default_config()
    cfgs = [dict(base, **{"serving.num_slots": 4}),
            dict(base, **{"serving.num_slots": 8, "serving.admit_chunk": 2}),
            dict(base, **{"serving.num_slots": 4,
                          "serving.interleave": "drain"})]
    got = env_b.intervene_batch(cfgs)
    for cfg, (cnt_b, y_b) in zip(cfgs, got):
        cnt_s, y_s = _env(weights).intervene(cfg)
        assert np.isfinite(y_b) and np.isfinite(y_s)
        for name in ("occupancy_mean", "queue_depth_mean", "queue_depth_max",
                     "rejected_rate", "prefill_chunks_inflight"):
            assert cnt_b[name] == cnt_s[name], name


def test_deployment_is_shared_across_env_seeds(weights):
    a = ReplayServingEnv(SPEC, seed=3, trace_seed=0, device="cpu")
    b = ReplayServingEnv(SPEC, seed=4, trace_seed=0, device="cpu")
    assert a.model is b.model and a.params is b.params
    assert a.trace == b.trace


def test_transfer_tune_sim_source_replay_target(weights):
    src, tgt = make_sim2real_pair(SPEC, seed=0, trace_seed=0, device="cpu",
                                  params=weights[1], repeats=1)
    res = transfer_tune("cameo", src, tgt, budget=2, n_source=24,
                        n_target_init=2, query_text=tgt.query_text, seed=0)
    assert res.best_config is not None
    assert np.isfinite(res.best_y) and res.best_y > 0
    assert len(res.trace_best_y) == 2
    plan = ReplayServingEnv.plan_of(res.best_config)
    assert plan.num_slots >= 1
    assert all(not k.startswith("serving.") for k in res.launch_config)
    assert tgt.replay(res.best_config).completed > 0


def test_fleet_replay_and_wallclock_name_what_they_wait_for(weights):
    # fleet replay is ported: it routes, replays each replica and pools
    env = _env(weights, fleet=True, num_devices=4)
    assert tuple(env.counter_names) == REPLAY_FLEET_COUNTER_NAMES
    cfg = dict(env.space.default_config(), **{"fleet.num_replicas": 2})
    counters, y = env.intervene(cfg)
    assert np.isfinite(y) and y > 0
    assert set(env.counter_names) <= set(counters)
    cfg["fleet.num_replicas"] = 8
    assert env.infeasible_reason(cfg) == "devices"
    # the wall-clock backend is ported: it builds, here on the CPU
    backend = measure_mod.make_backend("wallclock", KernelWorkload(),
                                       ["rmsnorm"], device="cpu")
    assert isinstance(backend, measure_mod.WallClockBackend)
    assert backend.families == ("rmsnorm",)
    assert measure_mod.resolve_backend_name("wallclock") == "wallclock"


def _tiny_served():
    from repro_torch.models.model import build_model
    from repro_torch.utils.config import RunConfig, ShapeConfig

    cfg = default_replay_model()
    run = RunConfig(model=cfg, shape=ShapeConfig("s", 64, 4, "decode"))
    model = build_model(cfg, device="cpu")
    return model, run, model.init(0)


def test_serve_sim2real_eval_prints_both_sides(capsys):
    from repro_torch.launch.serve import serve_workload
    from repro_torch.launch.tune import predicted_serving_report
    from repro_torch.workloads import ServingSimulator

    model, run, params = _tiny_served()
    spec = ("poisson:rate=2000,horizon=0.005,mean_prompt=5,mean_output=3,"
            "max_len=12")
    plan, launch, report = serve_workload(model, run, params, spec,
                                          tune_budget=2, seed=0,
                                          sim2real_eval=True)
    out = capsys.readouterr().out
    assert "sim-predicted" in out and "replayed-actual" in out
    assert report.completed > 0 and launch is not None
    # the predicted half is the port simulator's own run of the deployed
    # configuration
    trace = make_workload(spec).generate(0)
    line = next(ln for ln in out.splitlines() if "sim-predicted" in ln)
    from repro_torch.tuner.space import launch_families_for
    from repro_torch.launch.tune import launch_workload_for

    fams = [f for f in launch_families_for(model.cfg)
            if f in measure_mod.modeled_families()]
    sim = ServingSimulator(launch_workload_for(model.cfg, 1, 512), fams)
    cfg = {**{f"serving.{k}": v for k, v in
              dataclasses.asdict(plan).items()}, **launch}
    own = sim.run(trace, plan, cfg)
    pred = predicted_serving_report(model.cfg, trace, cfg)
    assert dataclasses.asdict(pred) == dataclasses.asdict(own)
    assert f"sim-predicted p99={own.p99_latency_us:.0f} us" in line


def test_serve_cli_workload_on_cpu_and_no_silent_cpu_fallback(capsys,
                                                              monkeypatch):
    from repro_torch.launch import serve

    spec = ("poisson:rate=2000,horizon=0.004,mean_prompt=5,mean_output=3,"
            "max_len=12")
    assert serve.main(["--device", "cpu", "--workload", spec,
                       "--tune-serving", "2", "--sim2real-eval"]) == 0
    out = capsys.readouterr().out
    assert "tuned serving config" in out
    assert "sim-predicted" in out and "replayed-actual" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--workload", spec, "--sim2real-eval"])
