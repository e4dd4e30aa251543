"""The arithmetic of the rate and the tails (the end-to-end metrics and
the ``itl_p99_ms.batch`` reader), and the rule on forbidden modules."""

import sys
from types import SimpleNamespace

import pytest

import bench_smoke_setup as S
from benchkit import cell_run, spec, stats


ITL = spec.load_module(S.BENCH / "metrics" / "itl_p99_ms.batch.py")


def _itl_p99_ms(times, t0, t1):
    """The per-layer reader ``itl_p99_ms.batch`` over these token times."""
    window = SimpleNamespace(times=dict(enumerate(times)), t0=t0, t1=t1)
    return ITL.read(SimpleNamespace(window=window))


def _steady(n_req=4, ticks=100, dt=0.02, stall_at=None, stall=0.0):
    """Token times of ``n_req`` requests decoding together, one token a
    tick, with one tick stalled by ``stall`` seconds."""
    times, t = [[] for _ in range(n_req)], 0.0
    for k in range(ticks):
        t += dt + (stall if k == stall_at else 0.0)
        for ts in times:
            ts.append(t)
    return times


def test_rate_and_tail_of_a_steady_window():
    times = _steady()
    assert stats.output_tokens_per_s(times, 0.0, 1.0) == pytest.approx(
        4 * 49 / 1.0)
    assert _itl_p99_ms(times, 0.0, 2.5) == pytest.approx(20.0)


def test_a_stall_inside_the_window_lowers_the_rate_and_raises_the_tail():
    calm, stalled = _steady(), _steady(stall_at=30, stall=0.5)
    for k in (10, 60):
        stalled_k = _steady(stall_at=k, stall=0.5)
        assert stats.output_tokens_per_s(stalled_k, 0.0, 1.5) < \
            stats.output_tokens_per_s(calm, 0.0, 1.5)
    assert _itl_p99_ms(stalled, 0.0, 2.5) > \
        _itl_p99_ms(calm, 0.0, 2.5)
    # a stall after the window's close changes neither
    late = _steady(stall_at=90, stall=0.5)
    assert stats.output_tokens_per_s(late, 0.0, 1.5) == \
        stats.output_tokens_per_s(calm, 0.0, 1.5)
    assert _itl_p99_ms(late, 0.0, 1.5) == \
        _itl_p99_ms(calm, 0.0, 1.5)


def test_gaps_count_where_their_later_token_lands():
    times = [[0.9, 1.05, 1.1, 2.2]]
    assert stats.gaps_in(times, 1.0, 2.0) == pytest.approx([0.15, 0.05])
    assert stats.tokens_in(times, 1.0, 2.0) == 2


def test_ttft_percentile_is_over_every_request():
    ttft = [0.1] * 88 + [1.0] * 12
    assert stats.ttft_p90_ms(ttft) > 100.0
    assert stats.ttft_p90_ms([0.1] * 100) == pytest.approx(100.0)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in cell_run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert cell_run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.kernels", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert cell_run.forbidden_modules() == ["jax", "repro"]
