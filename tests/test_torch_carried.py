"""The modules the port carries over from the reference (pure Python, no
jax) against their originals: config dataclasses, configuration spaces,
the paging plan, the synthetic data, the llama3.2-1b config, the tracer's
JSON and the metrics registry.  Every comparison is exact.
"""

import dataclasses

import numpy as np
import pytest

from repro.configs import llama3p2_1b as jllama
from repro.core import spaces as jspaces
from repro.data import pipeline as jpipeline
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro.serving import paging as jpaging
from repro.utils import config as jconfig
from repro_torch.configs import llama3p2_1b as tllama
from repro_torch.configs import registry as tregistry
from repro_torch.core import spaces as tspaces
from repro_torch.data import pipeline as tpipeline
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.serving import paging as tpaging
from repro_torch.utils import config as tconfig

CONFIG_CLASSES = ["ModelConfig", "ShapeConfig", "MeshConfig",
                  "ParallelConfig", "TrainConfig", "RunConfig"]


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            out[f.name] = dataclasses.asdict(f.default_factory())
        else:
            out[f.name] = "<required>"
    return out


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_dataclass_fields_equal(name):
    jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
    assert [f.name for f in dataclasses.fields(tcls)] == \
        [f.name for f in dataclasses.fields(jcls)]
    assert _defaults(tcls) == _defaults(jcls)


def test_run_config_json_round_trip_equal():
    kw = dict(num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
              sliding_window=8)
    jrun = jconfig.RunConfig(model=jconfig.ModelConfig(**kw),
                             parallel=jconfig.ParallelConfig(tp=2))
    trun = tconfig.RunConfig(model=tconfig.ModelConfig(**kw),
                             parallel=tconfig.ParallelConfig(tp=2))
    assert trun.to_json() == jrun.to_json()
    assert tconfig.RunConfig.from_json(jrun.to_json()) == trun
    assert trun.model.head_dim == jrun.model.head_dim == 16


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_llama_config_equal(which):
    assert getattr(tllama, which).to_dict() == getattr(jllama, which).to_dict()
    assert tllama.default_parallel("train") == tconfig.ParallelConfig(
        **dataclasses.asdict(jllama.default_parallel("train")))
    assert tregistry.list_archs() == ["falcon-mamba-7b", "zamba2-2.7b",
                                      "llama3.2-1b"]
    assert tregistry.get_model_config("llama3.2-1b") is tllama.CONFIG
    with pytest.raises(KeyError, match="unknown arch"):
        tregistry.get_model_config("deepseek-v3-671b")


def _space(mod):
    return mod.ConfigSpace([
        mod.Option("a", (1, 2, 4, 8), default=2),
        mod.Option("b", ("x", "y", "z"), kind="categorical"),
        mod.Option("c", (True, False), kind="boolean"),
        mod.Option("d", (0.5, 1.5, 3.0)),
    ])


def test_config_space_seeded_behaviour_equal():
    js, ts = _space(jspaces), _space(tspaces)
    assert ts.names == js.names and ts.size() == js.size()
    assert ts.sample(np.random.default_rng(4), 16) == \
        js.sample(np.random.default_rng(4), 16)
    cfg = js.default_config()
    assert ts.default_config() == cfg
    np.testing.assert_array_equal(ts.encode(cfg), js.encode(cfg))
    x = np.random.default_rng(5).random(4)
    assert ts.decode(x) == js.decode(x)
    assert ts.neighbors(cfg, np.random.default_rng(6), 12) == \
        js.neighbors(cfg, np.random.default_rng(6), 12)
    assert ts.grid() == js.grid()
    assert ts.grid(max_points=5, rng=np.random.default_rng(7)) == \
        js.grid(max_points=5, rng=np.random.default_rng(7))
    assert tspaces.Option("n", (1, 2, 4)).index_of(3) == \
        jspaces.Option("n", (1, 2, 4)).index_of(3)


@pytest.mark.parametrize("config", [
    {}, {"pages.paging": "on"},
    {"pages.paging": "on", "pages.pool_pages": 256,
     "paged_attention.page_size": 32, "paged_attention.prefill_chunk": 128},
])
def test_paged_plan_resolves_equal(config):
    assert dataclasses.asdict(tpaging.PagedPlan.from_config(config)) == \
        dataclasses.asdict(jpaging.PagedPlan.from_config(config))
    plan = tpaging.PagedPlan.from_config(config)
    assert plan.slot_capacity == jpaging.PagedPlan.from_config(
        config).slot_capacity
    assert [plan.pages_for(n) for n in (0, 1, 63, 64, 65)] == \
        [jpaging.PagedPlan.from_config(config).pages_for(n)
         for n in (0, 1, 63, 64, 65)]
    assert [o.name for o in tpaging.PAGES_OPTIONS] == \
        [o.name for o in jpaging.PAGES_OPTIONS]


@pytest.mark.parametrize("arch_cfg", ["SMOKE", "CONFIG"])
def test_make_data_batches_equal(arch_cfg):
    jcfg = getattr(jllama, arch_cfg)
    tcfg = getattr(tllama, arch_cfg)
    jshape = jconfig.ShapeConfig("s", 24, 4, "train")
    tshape = tconfig.ShapeConfig("s", 24, 4, "train")
    jd = jpipeline.make_data(jcfg, jshape, seed=3, num_shards=2, shard_id=1)
    td = tpipeline.make_data(tcfg, tshape, seed=3, num_shards=2, shard_id=1)
    for step in (0, 5):
        a, b = jd.batch_at(step), td.batch_at(step)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


class _Clock:
    """A deterministic clock: each read advances 250 us."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 250e-6
        return self.t


def _drive(trace_mod):
    tr = trace_mod.Tracer(clock=_Clock())
    with tr.span("prefill", cat="request", uid=3, prompt_len=np.int64(7)):
        tr.instant("admit", cat="request", uid=3, slot=0)
    tr.counter("queue_depth", 2)
    tr.async_begin("request", 3, prompt_len=7)
    tr.async_end("request", 3, generated=4)
    tr.complete("sim", 10.0, 5.5, cat="sim", track=trace_mod.TRACK_SIM)
    tr.tuner_event("round", k=2, configs=({"a": 1},))
    return tr.to_json()


def test_trace_json_schema_equal():
    a, b = _drive(ttrace), _drive(jtrace)
    assert a["otherData"].pop("exporter") == "repro_torch.obs"
    assert b["otherData"].pop("exporter") == "repro.obs"
    assert a == b
    assert ttrace.TRACK_NAMES == jtrace.TRACK_NAMES


def test_module_tracer_is_zero_cost_when_disabled():
    assert not ttrace.enabled()
    assert ttrace.span("x") is ttrace.NULL_SPAN
    with ttrace.trace_to(None) as tr:
        assert ttrace.enabled() and ttrace.active() is tr
        ttrace.instant("x")
    assert not ttrace.enabled() and len(tr.events()) == 1


def test_metrics_registry_behaviour_equal():
    regs = (tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry())
    for reg in regs:
        reg.declare("a", group="g1")
        reg.declare("b", group="g2", discovery=False)
        reg.declare("c", group="g1", kind="counter")
        reg.inc("c", 2, slot=1)
        reg.inc("hits")
        reg.set("a", 0.5)
        reg.observe("lat", 3.0)
        reg.observe("lat", 1.0)
    t, j = regs
    assert t.discovery_names("g2", "g1") == j.discovery_names("g2", "g1")
    assert t.names() == j.names() and t.groups() == j.groups()
    assert t.snapshot() == j.snapshot()
    with pytest.raises(ValueError, match="conflicting"):
        t.declare("a", group="other")
