"""The per-layer readers and the trace's reduction, on synthetic events
and on traced runs at the smoke sizes (the CPU has no device events, so
only the batcher's counters are read there)."""

import json
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

import bench_smoke_setup as S
from bench_smoke_setup import one_thread  # noqa: F401
from benchkit import cell_run, spec, trace
from benchkit.driver import Tick, Window
from benchkit.measure import Run
from benchkit.traffic import Planned

BENCH = json.loads((S.ROOT / "BENCHMARK.json").read_text())

pytestmark = pytest.mark.usefixtures("one_thread")


def _ev(name, a, b, dev=DeviceType.CUDA):
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=a, end=b))


def _events():
    cpu = DeviceType.CPU
    return [
        _ev("bench.subwindow", 0.0, 1000.0, cpu),
        _ev("bench.tick", 0.0, 500.0, cpu),
        _ev("bench.prefill", 10.0, 300.0, cpu),
        _ev("bench.tick", 600.0, 1000.0, cpu),
        _ev("bench.subwindow", 0.0, 1000.0),     # its device-side range
        _ev("k_a", 50.0, 150.0),
        _ev("k_a", 120.0, 200.0),                # overlaps the first
        _ev("selective_scan_kernel<float>", 400.0, 520.0),
        _ev("k_b", 950.0, 1200.0),               # clipped at the close
        _ev("void repro::decode_attention_kernel<__nv_bfloat16, true>"
            "(repro::DecodeArgs)", 960.0, 990.0),
    ]


def test_trace_reduces_busy_idle_and_time_by_operation():
    tr = trace.read(_events())
    assert tr.window_s == pytest.approx(1e-3)
    # busy: [50, 200], [400, 520], [950, 1000]
    assert tr.busy_s == pytest.approx(320e-6)
    assert tr.kernels["k_a"] == pytest.approx(180e-6)
    assert tr.time_of("selective_scan_kernel") == pytest.approx(120e-6)
    # each gap goes to the innermost span that holds its start: [0, 50)
    # the first tick, [200, 400) its prefill, [520, 950) no span
    idle = {k: v[0] for k, v in tr.idle.items()}
    assert idle["bench.tick"] == pytest.approx(50e-6)
    assert idle["bench.prefill"] == pytest.approx(200e-6)
    assert idle["bench.driver"] == pytest.approx(430e-6)
    assert sum(idle.values()) + tr.busy_s == pytest.approx(tr.window_s)
    b = trace.breakdown(tr)
    assert b["device_ops"][0][0] == "k_a"
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_trace_without_device_events_reads_nothing():
    cpu = DeviceType.CPU
    assert trace.read([_ev("bench.subwindow", 0.0, 10.0, cpu)]) is None


def _run(cell_name, with_trace=True):
    cell = spec.load_cell(cell_name)
    sizes = cell.config["port"]
    w = Window(t0=0.0, t1=10.0)
    for u, n in enumerate((100, 200)):
        w.planned[u] = Planned(u, torch.zeros(n).numpy(), 4)
        w.times[u] = [1.0, 2.0]
    slots = int(cell.mix["num_slots"])
    # a tick before the window, and two inside it at half the slots
    w.ticks = [Tick(-0.5, slots, [64] * 4, []),
               Tick(5.1, slots // 2, [2048], [300, 400]),
               Tick(9.1, slots // 2, [], [301, 401])]
    tr = trace.read(_events()) if with_trace else None
    sub = trace.Sub(4.0, 10.0, tr)
    spans = trace.Spans(torch.device("cpu"), lambda: 0.0)
    # (end, seconds, prompt tokens); the first of each ended before the
    # window and is not read
    spans.calls["decode"] = [(-0.2, 9.0, 0), (5.0, 0.02, 0), (9.0, 0.02, 0)]
    spans.calls["prefill"] = [(-0.4, 9.0, 64), (5.0, 0.03, 100),
                              (9.0, 0.02, 200)]
    return Run(cell, sizes, w, sub, spans)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_metric_of_every_cell_has_a_reader_that_reads(cell):
    run = _run(cell)
    c = spec.load_cell(cell)
    for m in c.per_layer:
        value = c.module("metrics", m["name"]).read(run)
        assert value is not None and value > 0, m["name"]
    for m in c.per_layer:
        if m["source"] == "device_trace":
            assert c.module("metrics", m["name"]).read(
                _run(cell, with_trace=False)) is None, m["name"]


def test_counter_readers():
    run = _run("falcon-mamba-7b.batch-decode")
    c = spec.load_cell("falcon-mamba-7b.batch-decode")
    read = lambda n: c.module("metrics", n).read(run)
    assert read("slot_occupancy.batch") == pytest.approx(50.0)
    assert read("decode_step_ms.batch") == pytest.approx(20.0)
    assert read("prefill_ms.batch") == pytest.approx(25.0)
    assert read("device_idle_share.batch") == pytest.approx(68.0)
    long = _run("falcon-mamba-7b.long-prompt")
    c = spec.load_cell("falcon-mamba-7b.long-prompt")
    assert c.module("metrics", "prefill_us_per_token.long").read(long) == \
        pytest.approx(1e6 * 0.05 / 300)


@pytest.mark.parametrize("mix", sorted(S.SMOKE_MIXES))
def test_a_traced_run_reports_its_per_layer_metrics(tmp_path, mix):
    root = S.smoke_checkout(tmp_path)
    cell = f"falcon-mamba-7b-smoke.{mix}"
    r = cell_run.run_cell(cell, 77, 3.0, True, torch.device("cpu"), 0.0,
                          root, root / "bench", log=lambda m: None)
    assert r["correct"]
    got = set(r["metrics"])
    counters = {m["name"] for m in spec.load_cell(cell, root,
                                                  root / "bench").per_layer
                if m["source"] != "device_trace"}
    assert counters and counters <= got
    assert "setup_s" not in got
