"""The port's kernel-launch environment against the JAX reference on the CPU.

- The generic router ``dispatch.dispatch``: launch parameters the plain
  version does not take are dropped by signature, its outputs equal the
  reference's router's, and its profile (resolution counts, wall time, the
  obs span and registry counters) has the reference's shape.
- ``WallClockBackend`` under the reference's ``FakeClock`` on the
  reference's ``TINY`` cell and ``LEGACY_FAMS``, on the CPU in fp32: the
  same representative inputs bit for bit, outputs within 1e-5, and the
  same counters and ``y`` as the reference's backend for the same config
  dict.  Infeasible configurations short-circuit without a clock tick,
  ``paged_attention`` raises ``KeyError``, the candidate outranks an
  active ``use_launch_config``, ``measure_batch`` measures once per
  distinct launch tuple.
- ``KernelLaunchEnv``: delegation, the backend-instance and family rules,
  a real (host-clock) measurement of the plain versions.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.envs.kernel_launch import KernelLaunchEnv as JKernelLaunchEnv
from repro.envs.measure import FakeClock as JFakeClock
from repro.envs.measure import KernelWorkload as JKernelWorkload
from repro.envs.measure import WallClockBackend as JWallClockBackend
from repro.kernels import dispatch as jdispatch
from repro.obs import metrics as jobs_metrics
from repro.obs import trace as jobs_trace
from repro_torch.envs import KernelLaunchEnv, WallClockBackend
from repro_torch.envs import measure as measure_mod
from repro_torch.envs.measure import (AnalyticBackend, FakeClock,
                                      KernelWorkload, make_backend)
from repro_torch.kernels import dispatch
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from torch_reference_geometry import reference_geometry  # noqa: F401

torch.set_num_threads(1)

JTINY = JKernelWorkload(name="tiny", batch=1, seq_len=64, heads=2,
                        kv_heads=1, head_dim=16, d_model=32, channels=64,
                        scan_state=4, ssm_heads=2, ssm_head_dim=16,
                        ssm_state=8, noise=0.0)
TINY = KernelWorkload(**dataclasses.asdict(JTINY))
LEGACY_FAMS = ["flash_attention", "mamba_scan", "rmsnorm", "ssd"]
OUT_TOL = dict(atol=1e-5, rtol=1e-5)  # fp32; sums in other orders
CLOCK = (1e-3, 3e-3, 2e-3)

#: config dicts both registries accept (the values are each package's
#: defaults or either domain's; the plain versions take any)
CONFIGS = {
    "reference_defaults": jdispatch.launch_space().default_config(),
    "port_defaults": dispatch.launch_space().default_config(),
    "mixed": {"flash_attention.q_block": 32, "flash_attention.kv_block": 64,
              "mamba_scan.chunk": 16, "mamba_scan.c_block": 32,
              "ssd.chunk": 32, "rmsnorm.row_block": 2},
}


def _launch(family, config):
    return {k.split(".", 1)[1]: v for k, v in config.items()
            if k.split(".", 1)[0] == family}


def _backends(**kw):
    kw = {"warmup": 1, "repeats": 3, **kw}
    ref = JWallClockBackend(JTINY, LEGACY_FAMS, seed=0,
                            clock=JFakeClock(CLOCK), **kw)
    out = WallClockBackend(TINY, LEGACY_FAMS, seed=0, device="cpu",
                           dtype=torch.float32, clock=FakeClock(CLOCK), **kw)
    return ref, out


# --------------------------------------------------------------------------
# the generic router
# --------------------------------------------------------------------------

def test_router_drops_what_the_plain_version_does_not_take():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    ref = np.array(jdispatch.dispatch("rmsnorm", x, w, mode="ref",
                                      launch={"row_block": 64}))
    out = dispatch.dispatch("rmsnorm", torch.from_numpy(x),
                            torch.from_numpy(w), launch={"row_block": 2})
    np.testing.assert_allclose(out.numpy(), ref, **OUT_TOL)
    with dispatch.record_resolutions() as rec:
        dispatch.dispatch("rmsnorm", torch.from_numpy(x),
                          torch.from_numpy(w), launch={"row_block": 2})
    assert [(r.family, r.mode, r.launch) for r in rec] == \
        [("rmsnorm", "ref", {"row_block": 2})]
    for pkg, arr in ((jdispatch, x), (dispatch, torch.from_numpy(x))):
        with pytest.raises(KeyError):
            pkg.dispatch("rmsnorm", arr, arr[0, 0], launch={"nope": 1})


def test_router_profile_matches_the_reference():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(1, 16, 2, 8)).astype(np.float32)
    k = rng.normal(size=(1, 16, 1, 8)).astype(np.float32)
    calls = [("flash_attention", (q, k, k)),
             ("rmsnorm", (q[0, 0], q[0, 0, 0])),
             ("rmsnorm", (q[0, 1], q[0, 1, 0]))]
    summaries = []
    for pkg, conv in ((jdispatch, lambda a: a),
                      (dispatch, torch.from_numpy)):
        with pkg.profile_dispatches() as prof:
            for fam, args in calls:
                pkg.dispatch(fam, *map(conv, args),
                             **({"mode": "ref"} if pkg is jdispatch else {}))
        summaries.append(prof.summary())
    ref, out = summaries
    assert set(out) == set(ref) == {"flash_attention [ref]",
                                    "rmsnorm [ref]"}
    for key in ref:
        assert out[key]["resolutions"] == ref[key]["resolutions"]
        assert out[key]["wall_s"] > 0 and ref[key]["wall_s"] > 0


def test_router_exports_the_span_and_counters_the_reference_does():
    x = np.ones((2, 8), np.float32)
    spans = []
    for pkg, tr, met, conv in (
            (jdispatch, jobs_trace, jobs_metrics, lambda a: a),
            (dispatch, obs_trace, obs_metrics, torch.from_numpy)):
        before = met.REGISTRY.value("dispatch_resolutions_total",
                                    family="rmsnorm", mode="ref") or 0.0
        tracer = tr.start()
        try:
            pkg.dispatch("rmsnorm", conv(x), conv(x[0]),
                         **({"mode": "ref"} if pkg is jdispatch else {}))
        finally:
            tr.stop()
        after = met.REGISTRY.value("dispatch_resolutions_total",
                                   family="rmsnorm", mode="ref")
        assert after == before + 1
        assert (met.REGISTRY.value("dispatch_wall_s", family="rmsnorm",
                                   mode="ref") or 0.0) > 0
        (ev,) = [e for e in tracer.events() if e.get("cat") == "dispatch"]
        spans.append((ev["name"], ev["ph"], ev["pid"], ev["args"]))
    assert spans[0] == spans[1]


# --------------------------------------------------------------------------
# WallClockBackend against the reference's
# --------------------------------------------------------------------------

@pytest.mark.usefixtures("reference_geometry")
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_wallclock_counters_and_y_match_the_reference(name):
    config = CONFIGS[name]
    ref, out = _backends()
    assert out.measure(config) == ref.measure(config)
    # one sample a family: four clock deltas of the cycle 1, 2, 3, 1 ms
    ref, out = _backends(warmup=0, repeats=1)
    jc, jy = ref.measure(config)
    c, y = out.measure(config)
    assert (c, y) == (jc, jy) and y == pytest.approx(7e3)


def test_wallclock_inputs_and_outputs_match_the_reference():
    ref, out = _backends()
    config = CONFIGS["mixed"]
    for fam in LEGACY_FAMS:
        jargs = ref._family_inputs(fam)
        args = out.inputs(fam)
        assert all(a.dtype == torch.float32 and a.device.type == "cpu"
                   for a in args)
        for ja, a in zip(jargs, args):
            np.testing.assert_array_equal(np.array(ja), a.numpy())
        jy = np.array(ref._jitted_for(fam, _launch(fam, config))(*jargs))
        y = out.call(fam, _launch(fam, config))
        np.testing.assert_allclose(y.numpy(), jy, **OUT_TOL)


def test_wallclock_default_inputs_take_the_model_paths_dtypes():
    b = WallClockBackend(TINY, LEGACY_FAMS, seed=0, device="cpu")
    bf, f32 = torch.bfloat16, torch.float32
    assert [a.dtype for a in b.inputs("mamba_scan")] == \
        [bf, f32, f32, bf, bf, f32]
    assert [a.dtype for a in b.inputs("ssd")] == [bf, f32, f32, bf, bf, f32]
    assert {a.dtype for a in b.inputs("flash_attention")} == {bf}
    assert {a.dtype for a in b.inputs("rmsnorm")} == {bf}


@pytest.mark.usefixtures("reference_geometry")
def test_wallclock_infeasible_short_circuits_without_a_clock_tick():
    clk = FakeClock([1e-3])
    tight = dataclasses.replace(TINY, vmem_limit=1)
    b = WallClockBackend(tight, ["rmsnorm"], device="cpu", clock=clk)
    jclk = JFakeClock([1e-3])
    jb = JWallClockBackend(dataclasses.replace(JTINY, vmem_limit=1),
                           ["rmsnorm"], clock=jclk)
    counters, y = b.measure({"rmsnorm.row_block": 4})
    assert np.isinf(y) and clk.calls == 0 and not b._inputs
    assert (counters, y) == jb.measure({"rmsnorm.row_block": 4})
    assert jclk.calls == 0


def test_wallclock_paged_attention_raises_key_error():
    b = WallClockBackend(TINY, ["paged_attention"], device="cpu",
                         warmup=0, repeats=1, clock=FakeClock([1e-3]))
    with pytest.raises(KeyError, match="ReplayServingEnv"):
        b.measure(dispatch.launch_space().default_config())


def test_wallclock_candidate_outranks_the_active_config():
    b = WallClockBackend(TINY, ["rmsnorm", "ssd"], device="cpu", warmup=0,
                         repeats=1, clock=FakeClock([1e-3]))
    with dispatch.use_launch_config({"rmsnorm.row_block": 8,
                                     "ssd.chunk": 16}):
        with dispatch.record_resolutions() as rec:
            b.measure({"rmsnorm.row_block": 2})
    got = {(r.family, tuple(sorted(r.launch.items()))) for r in rec}
    # ssd takes its registry default, not the outer config's 16
    assert got == {("rmsnorm", (("row_block", 2),)),
                   ("ssd", (("chunk", 64),))}


def test_measure_batch_measures_once_per_distinct_launch_tuple():
    configs = [{"rmsnorm.row_block": 2}, {"rmsnorm.row_block": 4},
               {"rmsnorm.row_block": 2, "paged_attention.page_size": 32},
               {"rmsnorm.row_block": 4}]
    clk = FakeClock([1e-3, 2e-3])
    b = WallClockBackend(TINY, ["rmsnorm"], device="cpu", warmup=0,
                         repeats=2, clock=clk)
    jclk = JFakeClock([1e-3, 2e-3])
    jb = JWallClockBackend(JTINY, ["rmsnorm"], warmup=0, repeats=2,
                           clock=jclk)
    res = b.measure_batch(configs)
    assert clk.calls == 2 * 2 * 2  # 2 distinct tuples x 2 repeats x 2 ticks
    assert res[0] is res[2] and res[1] is res[3]
    # the reference's jit cache would run the unknown paged key; compare
    # the configs both registries resolve alike
    assert [y for _, y in res] == [y for _, y in jb.measure_batch(
        [configs[i] for i in (0, 1, 0, 1)])]


def test_wallclock_measure_exports_a_measure_span():
    b = WallClockBackend(TINY, ["rmsnorm"], device="cpu", warmup=0,
                         repeats=1, clock=FakeClock([1e-3]))
    tracer = obs_trace.start()
    try:
        _, y = b.measure({"rmsnorm.row_block": 2})
    finally:
        obs_trace.stop()
    (ev,) = [e for e in tracer.events() if e["name"] == "measure"]
    (setup,) = [e for e in tracer.events() if e["name"] == "inputs"]
    assert setup["args"]["families"] == ["rmsnorm"]
    assert ev["cat"] == "env" and ev["pid"] == obs_trace.TRACK_ENV
    assert ev["args"]["y"] == y and ev["args"]["family_us"] == \
        {"rmsnorm": y}
    assert ev["args"]["config"] == {"rmsnorm.row_block": 2}


def test_wallclock_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        assert make_backend("wallclock", TINY, ["rmsnorm"]).device.type \
            == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_backend("wallclock", TINY, ["rmsnorm"])
    b = make_backend("wallclock", TINY, ["rmsnorm"], device="cpu")
    assert isinstance(b, WallClockBackend) and b.device.type == "cpu"


# --------------------------------------------------------------------------
# KernelLaunchEnv
# --------------------------------------------------------------------------

@pytest.mark.usefixtures("reference_geometry")
def test_env_delegates_to_the_analytic_backend_as_the_reference():
    env = KernelLaunchEnv(TINY, seed=3)
    assert env.families == sorted(
        f for f in dispatch.families() if f in measure_mod.modeled_families())
    backend = AnalyticBackend(TINY, env.families, seed=3)
    jenv = JKernelLaunchEnv(JTINY, seed=3)
    assert env.families == jenv.families
    assert env.counter_names == jenv.counter_names
    rng = np.random.default_rng(11)
    for config in env.space.sample(rng, 8):
        got = env.intervene(config)
        assert got == backend.measure(config)
        # the geometry's counters need no hardware: the reference's
        assert got[0] == jenv.intervene(config)[0]


def test_env_backend_instance_and_family_rules():
    inst = AnalyticBackend(TINY, ["rmsnorm"], seed=0)
    env = KernelLaunchEnv(TINY, backend=inst)
    assert env.backend is inst and env.families == ["rmsnorm"]
    assert env.space.names == ["rmsnorm.row_block"]
    with pytest.raises(ValueError, match="backend_opts"):
        KernelLaunchEnv(TINY, backend=inst, backend_opts={"repeats": 2})
    with pytest.raises(ValueError, match="conflict"):
        KernelLaunchEnv(TINY, families=["rmsnorm", "ssd"], backend=inst)
    with pytest.raises(ValueError, match="launch-geometry"):
        KernelLaunchEnv(TINY, families=["flash_attention", "nope"])
    wc = WallClockBackend(TINY, ["ssd"], device="cpu", warmup=0, repeats=1,
                          clock=FakeClock([1e-3]))
    env = KernelLaunchEnv(TINY, backend=wc)
    assert env.space.names == ["ssd.chunk"]
    with env.apply({"ssd.chunk": 16}):
        assert dispatch.resolve("ssd").launch == {"chunk": 16}


def test_env_intervene_batch_goes_through_measure_batch():
    clk = FakeClock([1e-3])
    env = KernelLaunchEnv(TINY, families=["rmsnorm", "ssd"],
                          backend="wallclock",
                          backend_opts={"device": "cpu", "warmup": 0,
                                        "repeats": 1, "clock": clk})
    cfgs = [{"rmsnorm.row_block": 2, "ssd.chunk": 32}] * 3
    res = env.intervene_batch(cfgs)
    assert len(res) == 3 and clk.calls == 2 * 2  # one timing, 2 families
    assert res[0][1] == pytest.approx(2e3)


def test_env_wallclock_measures_the_plain_versions_on_the_cpu():
    env = KernelLaunchEnv(TINY, families=LEGACY_FAMS, backend="wallclock",
                          backend_opts={"device": "cpu", "warmup": 1,
                                        "repeats": 3})
    tracer = obs_trace.start()
    try:
        c1, y1 = env.intervene(env.space.default_config())
    finally:
        obs_trace.stop()
    assert np.isfinite(y1) and y1 > 0
    (ev,) = [e for e in tracer.events() if e["name"] == "measure"]
    assert set(ev["args"]["family_us"]) == set(LEGACY_FAMS)
    c2, y2 = env.intervene({"flash_attention.q_block": 32,
                            "mamba_scan.chunk": 16})
    assert np.isfinite(y2) and y2 > 0
    assert c1 != c2  # the geometry's counters move with the config
