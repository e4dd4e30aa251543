"""The batcher's request lifecycle (``serving/scheduler.py``): the records
on each ``RequestState``, the serve spans built from the same readings,
and the ``serve.*`` profiler ranges the live spans open while a tracer is
active.  CPU, the tiny served model of ``tests/test_torch_serve.py`` with
the port's own seeded weights; no jax is imported here.
"""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.analysis import engine
from repro_torch.models.model import build_model
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.paging import PagedPlan
from repro_torch.serving.scheduler import ContinuousBatcher, Request
from repro_torch.train.serve_step import jitted_steps
from repro_torch.utils.config import ModelConfig, RunConfig, ShapeConfig

torch.set_num_threads(1)

TINY = dict(vocab_size=64, d_model=32, num_heads=4, num_kv_heads=2, d_ff=64,
            num_layers=2, dtype="float32")

#: dense slots, and a paged pool with chunked prefill (requests leave the
#: queue ticks before their prefill)
GEOMETRIES = {
    "dense": None,
    "paged_chunked": dict(pool_pages=8, page_size=4, pages_per_slot_max=8,
                          prefill_chunk=2),
}

#: the request's spans, in lifecycle order, and the readings bounding each
SPANS = (("queue", "submitted_at", "dequeued_at"),
         ("chunking", "dequeued_at", "prefill_started_at"),
         ("prefill", "prefill_started_at", "prefill_done_at"),
         ("prefill.enqueue", "prefill_started_at", "prefill_enqueued_at"),
         ("prefill.sync", "prefill_enqueued_at", "prefill_done_at"),
         ("seat", "prefill_done_at", "admitted_at"))
ORDER = ("submitted_at", "dequeued_at", "prefill_started_at",
         "prefill_enqueued_at", "prefill_done_at", "admitted_at",
         "finished_at")


@pytest.fixture(scope="module")
def served():
    cfg = ModelConfig(**TINY)
    run = RunConfig(model=cfg, shape=ShapeConfig("s", 64, 4, "decode"))
    model = build_model(cfg, device="cpu")
    return model, run, model.init(0)


def _serve(served, geometry, n_requests=5, max_new=4):
    """Five requests on two slots (three wait in the queue), drained."""
    model, run, params = served
    g = GEOMETRIES[geometry]
    b = ContinuousBatcher(model, run, params, num_slots=2, cache_len=32,
                          paged=None if g is None else PagedPlan(paging=True,
                                                                 **g))
    rng = np.random.default_rng(2)
    for i in range(n_requests):
        b.submit(Request(uid=i, prompt=rng.integers(
            0, TINY["vocab_size"], (5, 3, 4)[i % 3]).astype(np.int32),
            max_new_tokens=max_new))
    done = b.run_until_drained()
    return b, done


def _counters(b):
    return (b.ticks, b.prefill_chunks, b.rejected_too_long, b.mean_occupancy,
            b._pool_occ_sum, b._chunks_inflight_sum)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_lifecycle_records_are_ordered(served, geometry):
    _, done = _serve(served, geometry)
    assert len(done) == 5
    for rs in done:
        readings = [getattr(rs, k) for k in ORDER]
        assert all(t > 0.0 for t in readings), rs.request.uid
        assert readings == sorted(readings), rs.request.uid
    queued = [rs for rs in done if rs.dequeued_at > rs.submitted_at]
    assert queued  # some requests waited for a slot
    if geometry == "dense":
        # popped for its prefill: one reading is both boundaries
        assert all(rs.dequeued_at == rs.prefill_started_at for rs in done)
    else:
        assert all(rs.dequeued_at < rs.prefill_started_at for rs in done)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_spans_are_the_records(served, geometry):
    with obs_trace.trace_to(None) as tr:
        _, done = _serve(served, geometry)
    spans, begins = {}, {}
    for ev in tr.events():
        uid = ev["args"].get("uid")
        if ev["ph"] == "X" and ev["cat"] == "request":
            assert (ev["name"], uid) not in spans
            spans[(ev["name"], uid)] = ev
        elif ev["ph"] == "b" and ev["name"] == "request":
            begins[int(ev["id"])] = ev["ts"]
    for rs in done:
        uid = rs.request.uid
        assert begins[uid] == pytest.approx(tr.us_at(rs.submitted_at),
                                            abs=1e-3)
        for name, a, b in SPANS:
            ev = spans.get((name, uid))
            if name == "chunking" and geometry == "dense":
                assert ev is None
                continue
            assert ev is not None, (name, uid)
            assert ev["pid"] == obs_trace.TRACK_SERVE
            t0, t1 = tr.us_at(getattr(rs, a)), tr.us_at(getattr(rs, b))
            assert ev["ts"] == pytest.approx(t0, abs=1e-3), (name, uid)
            assert ev["ts"] + ev["dur"] == pytest.approx(t1, abs=2e-3), \
                (name, uid)
        # queue, chunking, prefill and seat tile submit -> admission
        tiles = sum(spans[(name, uid)]["dur"] for name in
                    ("queue", "chunking", "prefill", "seat")
                    if (name, uid) in spans)
        assert tiles == pytest.approx(
            (rs.admitted_at - rs.submitted_at) * 1e6, abs=1.0)
    assert {uid for _, uid in spans} == {rs.request.uid for rs in done}


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_tracer_on_and_off_serve_alike(served, geometry):
    off, done_off = _serve(served, geometry)
    with obs_trace.trace_to(None):
        on, done_on = _serve(served, geometry)
    assert [(rs.request.uid, rs.generated) for rs in done_on] == \
        [(rs.request.uid, rs.generated) for rs in done_off]
    assert _counters(on) == _counters(off)


def _profiled(served, traced):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if traced:
            with obs_trace.trace_to(None):
                _serve(served, "dense", n_requests=3, max_new=3)
        else:
            _serve(served, "dense", n_requests=3, max_new=3)
    return [e for e in prof.events()
            if e.name.startswith(obs_trace.PROFILER_PREFIX)]


def test_profiler_sees_serve_ranges_only_while_tracing(served):
    assert _profiled(served, traced=False) == []
    ranges = _profiled(served, traced=True)
    names = {e.name for e in ranges}
    assert {"serve.prefill", "serve.prefill.enqueue", "serve.prefill.sync",
            "serve.prefill.state", "serve.prefill.forward", "serve.seat",
            "serve.decode_tick", "serve.sample"} <= names
    prefills = [e.time_range for e in ranges if e.name == "serve.prefill"]
    enqueues = [e.time_range for e in ranges
                if e.name == "serve.prefill.enqueue"]
    assert len(prefills) == len(enqueues) == 3
    for inner in enqueues:
        assert any(outer.start <= inner.start and inner.end <= outer.end
                   for outer in prefills)


def test_jitted_steps_emits_nothing_on_the_kernel_track(served):
    model, run, _ = served
    with obs_trace.trace_to(None) as tr:
        a = jitted_steps(model, run, cache_len=24)
        assert jitted_steps(model, run, cache_len=24) is a
    assert [e for e in tr.events()
            if e["pid"] == obs_trace.TRACK_KERNEL] == []


def test_null_span_is_entered_by_nothing():
    """With no tracer active a span is the shared no-op: it opens no
    profiler range, and ``end`` hands its reading back."""
    assert not obs_trace.enabled()
    sp = obs_trace.span("prefill", t0=1.0)
    assert sp is obs_trace.NULL_SPAN
    with sp:
        assert sp.end(2.5) == 2.5


def test_analysis_gate_over_the_port_is_clean(monkeypatch):
    """Every clock read of the lifecycle carries its suppression, and
    every span is entered (``span-balance``)."""
    monkeypatch.chdir(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    rep = engine.run_analysis(["src/repro_torch"], kernels=False,
                              audits=False)
    assert rep.errors == [], [f"{f.path}:{f.line} [{f.rule}] {f.message}"
                              for f in rep.errors]
    assert not [f for f, _ in rep.suppressed if f.rule == "span-balance"]
