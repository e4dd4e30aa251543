"""The driver's loops on a batcher that stands in for the port's: one
token a tick for every resident, admissions at the tick's start, on a
clock that each tick moves on by a fixed step (and every reading by a
microsecond, as a real clock moves between two readings)."""

from dataclasses import dataclass, field
from typing import List

import numpy as np

import bench_smoke_setup as S  # noqa: F401  (puts bench/ and src/ on the path)
from benchkit import driver, stats, traffic
from benchkit.traffic import Planned


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 1e-6
        return self.t


@dataclass
class State:
    request: object
    admitted_at: float
    generated: List[int] = field(default_factory=list)

    @property
    def done(self):
        return len(self.generated) >= self.request.max_new_tokens


class Batcher:
    """Seats every queued request in a free slot at the tick's start
    (``PREFILL`` seconds each, first token included), then steps every
    resident by one token (``STEP`` seconds)."""
    PREFILL, STEP = 0.09, 0.03

    def __init__(self, slots, clock):
        self._slots = [None] * slots
        self.queue, self.completed = [], []
        self.rejected_too_long = 0
        self.clock = clock

    def submit(self, req):
        self.queue.append(req)

    def _finish(self, i):
        self.completed.append(self._slots[i])
        self._slots[i] = None

    def tick(self):
        for i in range(len(self._slots)):
            if self._slots[i] is None and self.queue:
                self.clock.t += self.PREFILL
                self._slots[i] = State(self.queue.pop(0), self.clock.t, [0])
                if self._slots[i].done:
                    self._finish(i)
        live = [i for i, s in enumerate(self._slots) if s is not None]
        if live:
            self.clock.t += self.STEP
        for i in live:
            self._slots[i].generated.append(0)
            if self._slots[i].done:
                self._finish(i)
        return len(live)


def _mix(**kw):
    mix = {"loop": "closed", "clients": 32, "num_slots": 32, "rounds": 6,
           "prompt_len": {"dist": "uniform", "lo": 8, "hi": 24},
           "output_len": {"dist": "uniform", "lo": 40, "hi": 160}}
    mix.update(kw)
    return mix


def test_closed_loop_opens_in_steady_state():
    clock = Clock()
    b = Batcher(32, clock)
    drv = driver.Driver(b, clock)
    w = drv.closed(traffic.closed_loop(_mix(), 11, 100), 20.0)
    # every client's first request was seated before the window opened
    assert all(w.times[u][0] <= w.t0 for u in range(32))
    # the window holds no stall of 32 prefills: admissions are spread
    # over it, at most a few a tick
    inside = [t for t in w.ticks if w.t0 <= t.end < w.t1]
    assert max(len(t.prefills) for t in inside) <= 4
    halves = [sum(len(t.prefills) for t in inside
                  if (t.end < w.t0 + 10.0) == first) for first in (1, 0)]
    assert min(halves) >= 0.6 * max(halves)
    assert stats.output_tokens_per_s(w.times.values(), w.t0, w.t1) > 0


def test_open_loop_counts_only_requests_due_in_the_window(monkeypatch):
    clock = Clock()
    b = Batcher(4, clock)
    # the stand-in clock moves on ticks, and on the driver's sleeps
    monkeypatch.setattr(driver.time, "sleep",
                        lambda s: setattr(clock, "t", clock.t + s))
    sched = [Planned(i, np.zeros(8, np.int32), 3, due_s=d)
             for i, d in enumerate([-2.0, -1.0, 0.5, 1.0, 4.0])]
    w = driver.Driver(b, clock).open(sched, 5.0, warm_s=2.0)
    assert w.attempted == 5 and w.failed == 0
    assert set(w.times) == {0, 1, 2, 3, 4}
    # the two requests due before the window are served, and their
    # times to first token are not counted
    assert len(w.ttft_s) == 3
    assert all(t >= 0.0 for t in w.ttft_s)
