"""The port's kernel-launch tuning and transfer sweeps against the JAX
reference on the CPU.

The two packages size their launch domains for their own kernels, so the
proposals are compared on spaces both share: the paged-attention family's
knobs (the same domains in both registries), or one space handed to both —
the port's registry entries given the reference's domains for the length of
a test (the geometry and the simulators price any value).  Both price with
the reference's constants, passed explicitly (the port's defaults are the
H100's).  Measurements are bit for bit; the tuner's trajectories within
the GP's 1e-4.

Also: ``gate_summary``, ``measure_backend_arg``, ``tune_launch_config``
deploying into the port's train step, and the serve and train CLIs'
``--tune-launch`` on smoke configs on the CPU.
"""

import argparse
import dataclasses

import numpy as np
import pytest
import torch

from repro.envs.kernel_launch import KernelLaunchEnv as JKernelLaunchEnv
from repro.envs.measure import HardwareSpec as JHardwareSpec
from repro.envs.measure import KernelWorkload as JKernelWorkload
from repro.kernels import dispatch as jdispatch
from repro.launch.tune import measure_backend_arg as jmeasure_backend_arg
from repro.tuner import bench as jbench
from repro.tuner.runner import tune_kernel_launch as jtune_kernel_launch
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.spaces import Option
from repro_torch.envs.kernel_launch import KernelLaunchEnv
from repro_torch.envs.measure import (HardwareSpec, KernelWorkload,
                                      backend_names)
from repro_torch.kernels import dispatch
from repro_torch.launch.tune import measure_backend_arg, tune_launch_config
from repro_torch.tuner import bench
from repro_torch.tuner.runner import tune_kernel_launch
from torch_reference_geometry import reference_geometry  # noqa: F401

torch.set_num_threads(1)

GP_TOL = 1e-4
JCELL = JKernelWorkload(name="tiny", batch=2, seq_len=512, heads=4,
                        kv_heads=2, head_dim=16, d_model=64, channels=64,
                        scan_state=4, ssm_heads=2, ssm_head_dim=16,
                        ssm_state=8)
CELL = KernelWorkload(**dataclasses.asdict(JCELL))
REF_HW = HardwareSpec(**dataclasses.asdict(JHardwareSpec()))
PAGED = ("paged_attention",)
SRC = ("poisson:rate=2500,horizon=0.02,mean_prompt=32,mean_output=16,"
       "max_len=96")
TGT = ("bursty:rate=2500,burst=6,horizon=0.02,mean_prompt=32,"
       "mean_output=16,max_len=96")


@pytest.fixture
def reference_domains(monkeypatch):
    """The port's registry with the reference's launch domains, for the
    length of one test."""
    for name in dispatch.families():
        jfam = jdispatch.get_family(name)
        opts = tuple(Option(o.name, tuple(o.values), default=o.default,
                            kind=o.kind) for o in jfam.launch_options)
        monkeypatch.setitem(dispatch._REGISTRY, name, dataclasses.replace(
            dispatch.get_family(name), launch_options=opts))


def _close(a, b):
    if a is None or b is None:
        return a is b
    return abs(a - b) <= GP_TOL * max(1.0, abs(b))


def _same_runs(ref_doc, doc, best_config=False):
    assert ref_doc["gate"]["checked"] == doc["gate"]["checked"]
    assert ref_doc["gate"]["passed"] == doc["gate"]["passed"]
    assert len(ref_doc["cells"]) == len(doc["cells"])
    for jc, c in zip(ref_doc["cells"], doc["cells"]):
        assert c["y_opt"] == jc["y_opt"]
        assert c.get("y_default") == jc.get("y_default")
        assert set(c["methods"]) == set(jc["methods"])
        for m, jstats in jc["methods"].items():
            for jr, r in zip(jstats["runs"], c["methods"][m]["runs"]):
                assert all(map(_close, r["regret"], jr["regret"])), m
                assert all(map(_close, r["best_y_trace"],
                               jr["best_y_trace"])), m
                assert _close(r["final_regret"], jr["final_regret"])
                if best_config:
                    assert r["best_config"] == jr["best_config"], m


# --------------------------------------------------------------------------
# tune_kernel_launch and the kernel-launch sweep
# --------------------------------------------------------------------------

@pytest.mark.usefixtures("reference_geometry")
@pytest.mark.parametrize("query_batch", [1, 2])
def test_tune_kernel_launch_makes_the_reference_proposals(monkeypatch,
                                                          query_batch):
    seen = {"ref": [], "port": []}

    def recorder(cls, key):
        orig = cls._measure

        def measure(self, config):
            out = orig(self, config)
            seen[key].append((dict(config), out[1]))
            return out
        monkeypatch.setattr(cls, "_measure", measure)

    recorder(JKernelLaunchEnv, "ref")
    recorder(KernelLaunchEnv, "port")
    kw = dict(families=PAGED, budget=6, n_source=24, n_target_init=3,
              target_backend="shifted:hardware", query_batch=query_batch,
              seed=0)
    jres = jtune_kernel_launch(JCELL, **kw)
    res = tune_kernel_launch(CELL, hardware=REF_HW,
                             target_opts={"hardware": REF_HW}, **kw)
    assert [c for c, _ in seen["port"]] == [c for c, _ in seen["ref"]]
    assert [y for _, y in seen["port"]] == [y for _, y in seen["ref"]]
    assert res.best_config == jres.best_config
    assert res.launch_config == jres.launch_config
    assert all(map(_close, res.trace_best_y, jres.trace_best_y))
    assert res.extras["reduced_space"] == jres.extras["reduced_space"]
    assert [r["size"] for r in res.rounds] == \
        [r["size"] for r in jres.rounds]


@pytest.mark.usefixtures("reference_geometry")
def test_transfer_bench_matches_the_reference_on_the_paged_space():
    kw = dict(shifts=("hardware", "feasibility", "noise"),
              methods=("cameo", "random"), budget=5, n_source=24,
              n_target_init=3, seeds=(0, 1), pool=64)
    jdoc = jbench.run_transfer_bench(
        cells=(jbench.BenchCell("tiny", JCELL, PAGED),), **kw)
    doc = bench.run_transfer_bench(
        cells=(bench.BenchCell("tiny", CELL, PAGED, REF_HW),), **kw)
    assert doc["meta"]["cells"] == ["tiny"] and len(doc["cells"]) == 3
    _same_runs(jdoc, doc)
    assert doc["gate"] == jdoc["gate"] or all(
        _close(doc["gate"][k], jdoc["gate"][k])
        for k in ("champion_mean_final_regret",
                  "reference_mean_final_regret"))


@pytest.mark.usefixtures("reference_geometry")
def test_transfer_bench_matches_the_reference_on_one_space(
        reference_domains):
    fams = ("flash_attention", "mamba_scan", "rmsnorm", "ssd")
    kw = dict(shifts=("workload",), methods=("cameo", "random"), budget=4,
              n_source=24, n_target_init=2, seeds=(0,), pool=48)
    jdoc = jbench.run_transfer_bench(
        cells=(jbench.BenchCell("tiny", JCELL, fams),), **kw)
    doc = bench.run_transfer_bench(
        cells=(bench.BenchCell("tiny", CELL, fams, REF_HW),), **kw)
    _same_runs(jdoc, doc)


def test_shifted_pair_and_cells():
    src, tgt = bench.make_shifted_pair(bench.BenchCell("t", CELL, PAGED),
                                       "hardware")
    assert src.space.names == tgt.space.names
    assert tgt.backend.shift_names == ("hardware",)
    assert bench.cell_by_name("serve-8b").workload == KernelWorkload()
    with pytest.raises(ValueError, match="unknown bench cell"):
        bench.cell_by_name("nope")
    assert bench.target_optimum(bench.BenchCell("t", CELL, PAGED),
                                "hardware", pool=32) > 0
    assert [c.name for c in bench.DEFAULT_CELLS] == \
        [c.name for c in jbench.DEFAULT_CELLS]
    assert bench.DEFAULT_SHIFTS == jbench.DEFAULT_SHIFTS


# --------------------------------------------------------------------------
# the serving and fleet sweeps
# --------------------------------------------------------------------------

@pytest.mark.usefixtures("reference_geometry")
def test_serving_bench_matches_the_reference(reference_domains):
    kw = dict(methods=("cameo", "random"), budget=4, n_source=24,
              n_target_init=2, seeds=(0,), pool=16)
    fams = ("flash_attention", "rmsnorm")
    jdoc = jbench.run_serving_bench(
        cells=(jbench.ServingCell("tiny", JCELL, fams, source=SRC),),
        targets=(TGT,), **kw)
    doc = bench.run_serving_bench(
        cells=(bench.ServingCell("tiny", CELL, fams, source=SRC,
                                 hardware=REF_HW),), targets=(TGT,), **kw)
    assert doc["meta"]["targets"] == [TGT] and not doc["meta"]["paged"]
    _same_runs(jdoc, doc, best_config=True)


@pytest.mark.usefixtures("reference_geometry")
def test_fleet_bench_matches_the_reference(reference_domains):
    kw = dict(shifts=("straggler",), methods=("cameo", "random"), budget=4,
              n_source=24, n_target_init=2, seeds=(0,), pool=16)
    fams = ("flash_attention", "rmsnorm")
    jdoc = jbench.run_fleet_bench(
        cells=(jbench.FleetCell("tiny", JCELL, fams, workload=TGT),), **kw)
    doc = bench.run_fleet_bench(
        cells=(bench.FleetCell("tiny", CELL, fams, workload=TGT,
                               hardware=REF_HW),), **kw)
    assert doc["meta"]["shifts"] == ["straggler"]
    _same_runs(jdoc, doc, best_config=True)


def test_paged_surface_joins_every_cell():
    cells = bench.paged_serving_surface(bench.DEFAULT_SERVING_CELLS
                                        + bench.DEFAULT_FLEET_CELLS)
    assert all("paged_attention" in c.families for c in cells)
    assert bench.serving_cell_by_name("serve-8b").cell == KernelWorkload()
    assert bench.fleet_cell_by_name("serve-8b").num_devices == 8
    assert bench.sim2real_cell_by_name("tiny-poisson").workload == \
        jbench.sim2real_cell_by_name("tiny-poisson").workload


def test_sim2real_bench_replays_on_the_cpu():
    import json

    cell = bench.Sim2RealCell("tiny", bench.DEFAULT_SIM2REAL_WORKLOADS[0])
    doc = bench.run_sim2real_bench(cells=(cell,), methods=("cameo", "random"),
                                   budget=2, n_source=16, n_target_init=2,
                                   seeds=(0,), pool=2, repeats=1,
                                   device="cpu")
    json.dumps(doc)  # JSON-clean
    (out,) = doc["cells"]
    assert out["workload"] == cell.workload and out["y_opt"] > 0
    for stats in out["methods"].values():
        (run,) = stats["runs"]
        assert len(run["regret"]) == len(run["best_y_trace"]) == 2
        assert all(r >= 0 for r in run["regret"] if r is not None)
        assert run["best_config"] is not None
    assert doc["gate"]["checked"]
    src, tgt = bench.make_sim2real_bench_pair(cell, device="cpu")
    assert src.space.names == tgt.space.names and src.trace == tgt.trace
    assert tgt.device.type == "cpu"


# --------------------------------------------------------------------------
# the gate, the backend flag, the launchers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("regrets", [(0.1, 0.5), (0.9, 0.2), (0.3, 0.3),
                                     None])
def test_gate_summary_matches_the_reference(regrets):
    if regrets is None:
        doc = {"cells": [{"methods": {"cameo": {"runs": []}}}]}
    else:
        doc = {"cells": [{"cell": "c", "shift": "s", "methods": {
            "cameo": {"runs": [{"final_regret": regrets[0]}]},
            "random": {"runs": [{"final_regret": regrets[1]}]}}}]}
    assert bench.gate_summary(doc) == jbench.gate_summary(doc)


def test_measure_backend_arg_accepts_what_the_reference_does():
    for name in backend_names():
        assert measure_backend_arg(name) == jmeasure_backend_arg(name)
    for bad in ("bogus", "shifted:bogus"):
        with pytest.raises(argparse.ArgumentTypeError):
            measure_backend_arg(bad)


def test_tune_launch_config_deploys_into_the_train_step():
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    from repro_torch.utils.config import RunConfig, ShapeConfig

    cfg = get_smoke_config("llama3.2-1b")
    lc = tune_launch_config(cfg, 2, 16, budget=2,
                            backend="shifted:hardware", kind="train",
                            seed=0)
    assert {k.split(".")[0] for k in lc} == {"rmsnorm", "flash_attention"}
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 16, 2, "train"))
    model = build_model(cfg, device="cpu")
    opt = make_optimizer(run.train)
    step = make_train_step(model, run, opt, launch_config=lc)
    state = init_train_state(model, run, opt, seed=0)
    batch = {"inputs": np.zeros((2, 16), np.int32),
             "targets": np.zeros((2, 16), np.int32)}
    with dispatch.record_resolutions() as rec:
        state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    tuned = dispatch.split_launch_config(lc)
    seen = {r.family for r in rec}
    assert seen >= {"rmsnorm", "flash_attention"}
    for r in rec:
        for p, v in tuned.get(r.family, {}).items():
            assert r.launch[p] == v, (r.family, p)


def _tuned(monkeypatch, module):
    got = []

    def wrapper(*a, **kw):
        got.append(tune_launch_config(*a, **kw))
        return got[-1]
    monkeypatch.setattr(module, "tune_launch_config", wrapper)
    return got


@pytest.mark.parametrize("backend", [None, "wallclock"])
def test_serve_cli_tunes_the_launch_and_serves_with_it(monkeypatch, capsys,
                                                       backend):
    from repro_torch.launch import serve

    got = _tuned(monkeypatch, serve)
    argv = ["--device", "cpu", "--gen", "4", "--tune-launch", "2"]
    if backend:
        argv += ["--measure-backend", backend]
    with dispatch.record_resolutions() as rec:
        assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "[serve] tuned launch config (cameo, budget=2" in out
    assert "[serve] decode p50=" in out
    (lc,) = got
    rows = dispatch.split_launch_config(lc)["rmsnorm"]["row_block"]
    served = [r.launch["row_block"] for r in rec if r.family == "rmsnorm"]
    assert served and served[-1] == rows


@pytest.mark.parametrize("arch,backend", [
    ("falcon-mamba-7b", "wallclock"), ("zamba2-2.7b", "shifted:hardware")])
def test_train_cli_tunes_the_launch_and_trains_with_it(monkeypatch, capsys,
                                                       tmp_path, arch,
                                                       backend):
    from repro_torch.launch import train

    got = _tuned(monkeypatch, train)
    argv = ["--device", "cpu", "--arch", arch, "--steps", "2", "--seq",
            "32", "--batch", "2", "--tune-launch", "2",
            "--measure-backend", backend, "--ckpt-dir", str(tmp_path)]
    assert train.main(argv) == 0
    out = capsys.readouterr().out
    assert "[train] tuned launch config (cameo, budget=2" in out
    assert "[train] finished at step 2" in out
    (lc,) = got
    want = {"falcon-mamba-7b": {"rmsnorm", "mamba_scan"},
            "zamba2-2.7b": {"rmsnorm", "flash_attention", "ssd"}}[arch]
    assert {k.split(".")[0] for k in lc} == want
