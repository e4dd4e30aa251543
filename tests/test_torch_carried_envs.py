"""The environments and modules carried over from the JAX reference (numpy
or pure Python), bit for bit: the paper's sandbox SCM, the analytic TPU
environment and its padded variant, every ``environment_pair`` change,
the hardware table; and the trace report, which must accept every trace
the port exports.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.envs import analytic as janalytic
from repro.envs import sandbox as jsandbox
from repro.obs import report as jreport
from repro.utils import hardware as jhardware
from repro_torch.envs import analytic, sandbox
from repro_torch.envs import measure as measure_mod
from repro_torch.obs import report
from repro_torch.obs import trace as obs_trace
from repro_torch.utils import hardware

torch.set_num_threads(1)

CHANGES = ("hardware", "workload", "software", "topology", "severe")


def _same_measurements(jenv, env, n=24, seed=0):
    assert env.space.names == jenv.space.names
    assert env.counter_names == jenv.counter_names
    rng = np.random.default_rng(seed)
    for cfg in env.space.sample(rng, n):
        assert env.intervene(cfg) == jenv.intervene(cfg), cfg


# --------------------------------------------------------------------------
# the sandbox SCM
# --------------------------------------------------------------------------

@pytest.mark.parametrize("memory", ["small", "large"])
def test_sandbox_scm_is_the_reference_bit_for_bit(memory):
    jenv = jsandbox.SandboxSCMEnv(memory, seed=3)
    env = sandbox.SandboxSCMEnv(memory, seed=3)
    _same_measurements(jenv, env)
    assert env.optimum() == jenv.optimum()
    jd, d = jenv.dataset(16, seed=5), env.dataset(16, seed=5)
    assert d.configs == jd.configs and d.ys == jd.ys
    assert d.counters == jd.counters


def test_sandbox_pair_is_the_reference_bit_for_bit():
    for jenv, env in zip(jsandbox.make_sandbox_pair(seed=2),
                         sandbox.make_sandbox_pair(seed=2)):
        assert env.env_memory == jenv.env_memory
        _same_measurements(jenv, env, n=8)


# --------------------------------------------------------------------------
# the analytic TPU environment
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(janalytic.ARCH_DIMS))
@pytest.mark.parametrize("hw", ["tpu_v5e", "tpu_v4_like"])
def test_analytic_tpu_env_is_the_reference_bit_for_bit(arch, hw):
    spec = janalytic.TPUEnvSpec(arch=arch, hardware=hw)
    jenv = janalytic.AnalyticTPUEnv(spec, seed=1)
    env = analytic.AnalyticTPUEnv(
        analytic.TPUEnvSpec(**dataclasses.asdict(spec)), seed=1)
    _same_measurements(jenv, env)
    assert env.optimum(max_points=256) == jenv.optimum(max_points=256)
    env.objective = jenv.objective = "energy"
    _same_measurements(jenv, env, n=8, seed=1)


@pytest.mark.parametrize("change", CHANGES)
def test_environment_pairs_are_the_reference_bit_for_bit(change):
    for padded in (16, 0):
        jpair = janalytic.environment_pair(change, seed=4, padded=padded)
        pair = analytic.environment_pair(change, seed=4, padded=padded)
        for jenv, env in zip(jpair, pair):
            assert type(env).__name__ == type(jenv).__name__
            assert dataclasses.asdict(env.spec) == \
                dataclasses.asdict(jenv.spec)
            _same_measurements(jenv, env, n=12)
    with pytest.raises(ValueError):
        analytic.environment_pair("bogus")


def test_tpu_config_spaces_match_the_reference():
    for arch in janalytic.ARCH_DIMS:
        jspace = janalytic.tpu_config_space(arch)
        space = analytic.tpu_config_space(arch)
        assert [(o.name, tuple(o.values), o.default, o.kind)
                for o in space.options] == \
            [(o.name, tuple(o.values), o.default, o.kind)
             for o in jspace.options]


# --------------------------------------------------------------------------
# the hardware table
# --------------------------------------------------------------------------

def test_hardware_table_carries_the_reference_and_names_the_h100():
    for name, jspec in jhardware.HARDWARE.items():
        spec = hardware.HARDWARE[name]
        assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
        args = (3e15, 2e12, 5e10, 64)
        assert spec.roofline_time(*args) == jspec.roofline_time(*args)
        assert spec.roofline_time(*args, cross_pod=True) == \
            jspec.roofline_time(*args, cross_pod=True)
    assert set(hardware.HARDWARE) == set(jhardware.HARDWARE) | {"h100_sxm"}
    h100 = hardware.HARDWARE["h100_sxm"]
    # the constants the launch geometry prices the card with
    assert h100.peak_flops_bf16 == measure_mod.TENSOR_FLOPS_PER_US * 1e6
    assert h100.hbm_bandwidth == measure_mod.HBM_BYTES_PER_US * 1e6
    assert h100.vmem_bytes == measure_mod.SMEM_LIMIT_BYTES
    assert analytic.AnalyticTPUEnv(
        analytic.TPUEnvSpec(hardware="h100_sxm")).hw is h100


# --------------------------------------------------------------------------
# the trace report
# --------------------------------------------------------------------------

def _check_report(path):
    events = report.load_trace(str(path))
    jevents = jreport.load_trace(str(path))
    assert events == jevents
    summary = report.summarize(events, slo_ms=50.0)
    assert summary == jreport.summarize(jevents, slo_ms=50.0)
    json.dumps(summary)
    assert report.main([str(path)]) == 0
    return summary


def test_report_accepts_the_serve_clis_trace(tmp_path, capsys):
    from repro_torch.launch import serve

    path = tmp_path / "serve.json"
    spec = ("poisson:rate=2000,horizon=0.005,mean_prompt=5,mean_output=3,"
            "max_len=12")
    assert serve.main(["--device", "cpu", "--workload", spec,
                       "--tune-serving", "2", "--trace-out",
                       str(path)]) == 0
    summary = _check_report(path)
    names = {s["name"] for s in summary["top_spans"]}
    assert "decode_tick" in names and summary["slo"]["requests"] > 0
    assert summary["tuner_rounds"]
    assert report.main([str(path), "--json"]) == 0
    assert "top_spans" in capsys.readouterr().out


def test_report_accepts_the_kernel_launch_tuning_trace(tmp_path):
    """The trace ``chip_smoke.py``'s tuning phases export: the tuner's
    events, the wall-clock backend's ``measure`` spans and the router's
    dispatch spans (here on the CPU's plain versions)."""
    from repro_torch.tuner.runner import tune_kernel_launch

    cell = measure_mod.KernelWorkload(
        name="tiny", batch=1, seq_len=64, heads=2, kv_heads=1, head_dim=16,
        d_model=32)
    path = tmp_path / "tune.json"
    with obs_trace.trace_to(str(path)):
        tune_kernel_launch(cell, families=("flash_attention", "rmsnorm"),
                           budget=2, n_source=16, n_target_init=2,
                           target_backend="wallclock",
                           target_opts={"device": "cpu", "warmup": 0,
                                        "repeats": 1})
    summary = _check_report(path)
    names = {s["name"] for s in summary["top_spans"]}
    assert {"measure", "flash_attention", "rmsnorm"} <= names
    assert summary["tuner_rounds"]


@pytest.mark.parametrize("doc,match", [
    ({"events": []}, "traceEvents"),
    ({"traceEvents": [{"ph": "Z", "ts": 0}]}, "invalid phase"),
    ({"traceEvents": [{"ph": "X", "name": "a", "ts": 0}]}, "dur"),
    ({"traceEvents": [{"ph": "b", "name": "r", "ts": 0}]}, "id"),
    (3, "object or array"),
])
def test_validate_trace_doc_refuses_what_the_reference_refuses(doc, match):
    with pytest.raises(ValueError, match=match):
        report.validate_trace_doc(doc)
    with pytest.raises(ValueError, match=match):
        jreport.validate_trace_doc(doc)
