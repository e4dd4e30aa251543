"""The traced sub-window: ``torch.profiler`` over the last seconds of a
``--trace 1`` run's window, and what the per-layer readers take from it.

Spans come from the benchmark's own wrappers around the batcher
(``bench.tick`` around ``tick``, ``bench.prefill`` around each admission's
prefill and scatter, ``bench.decode`` around the decode step's call) and
``bench.subwindow`` around the whole traced stretch; the device's
operations are the profiler's device events inside it.  The prefill and
decode wrappers also time each call on the host clock, between two
synchronizes of the device, over the whole window.
"""

from __future__ import annotations

import bisect
import functools
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

#: seconds at the end of the window that the profiler covers
TRACE_SECONDS = 3.0
SPANS = ("bench.subwindow", "bench.tick", "bench.prefill", "bench.decode")


class Spans:
    """The benchmark's own spans around the batcher's steps: each is a
    ``record_function`` for the profiler, and the timed ones also keep,
    for every call, when it ended, its seconds on the host clock between
    two synchronizes of the device, and (for a prefill) its prompt's
    tokens."""

    def __init__(self, device: torch.device,
                 clock: Callable[[], float]):
        self.cuda = device.type == "cuda"
        self.device = device
        self.clock = clock
        self.calls: Dict[str, List[Tuple[float, float, int]]] = {
            "prefill": [], "decode": []}

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def wrap(self, fn: Callable, name: str,
             timed: Optional[str] = None) -> Callable:
        from torch.autograd.profiler import record_function

        @functools.wraps(fn)
        def run(*args, **kwargs):
            with record_function(name):
                if timed is None:
                    return fn(*args, **kwargs)
                self._sync()
                t = self.clock()
                out = fn(*args, **kwargs)
                self._sync()
                end = self.clock()
                tokens = len(args[0].prompt) if timed == "prefill" else 0
                self.calls[timed].append((end, end - t, tokens))
                return out
        return run


def instrument(batcher, clock: Callable[[], float]) -> Spans:
    """Put the benchmark's spans around the batcher's tick, its
    admissions' prefills (``_prefill_and_seat(request, slot, pages)``:
    the batch-1 prefill, the scatter into the slot and the first token
    read back) and its decode step (instance attributes; the program is
    not changed)."""
    spans = Spans(batcher.device, clock)
    batcher.tick = spans.wrap(batcher.tick, "bench.tick")
    batcher._prefill_and_seat = spans.wrap(batcher._prefill_and_seat,
                                           "bench.prefill", "prefill")
    batcher._decode = spans.wrap(batcher._decode, "bench.decode", "decode")
    return spans


@dataclass
class Trace:
    """The device's side of the sub-window, in seconds."""
    window_s: float
    busy_s: float
    kernels: Dict[str, float]              # device seconds by name
    idle: Dict[str, Tuple[float, int]]     # host span -> (seconds, gaps)

    def time_of(self, *patterns: str) -> float:
        """Device seconds of the operations whose names hold every
        pattern."""
        return sum(t for k, t in self.kernels.items()
                   if all(p in k for p in patterns))


@dataclass
class Sub:
    """One traced sub-window: its bounds on the host clock and the device
    trace (None where the profiler recorded no device operation)."""
    t0: float
    t1: float
    trace: Optional[Trace] = None


class Profiled:
    """Starts the profiler at the first tick that ends ``seconds`` before
    the window closes and stops it at the first that ends after the
    close (or when :meth:`finish` is called).  The window's close is read
    from ``window`` once the driver has opened it."""

    def __init__(self, batcher, window, clock: Callable[[], float],
                 seconds: float = TRACE_SECONDS):
        self.b = batcher
        self.cuda = batcher.device.type == "cuda"
        self.w = window
        self.seconds = seconds
        self.clock = clock
        self.prof = None
        self.span = None
        self.done = False
        self.sub: Optional[Sub] = None

    def __call__(self, now: float) -> None:
        if not self.w.t1:
            return
        if self.prof is None and now >= self.w.t1 - self.seconds:
            self._start()
        elif self.prof is not None and not self.done and now >= self.w.t1:
            self.finish()

    def _start(self) -> None:
        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        self.prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.cuda else []))
        self.prof.start()
        self.span = record_function("bench.subwindow")
        self.span.__enter__()
        self.sub = Sub(self.clock(), 0.0)

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.b.device)

    def finish(self) -> Optional[Sub]:
        if self.prof is None or self.done:
            return self.sub
        self.done = True
        self._sync()
        self.sub.t1 = self.clock()
        self.span.__exit__(None, None, None)
        self.prof.stop()
        self.sub.trace = read(self.prof.events())
        return self.sub


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def read(events) -> Optional[Trace]:
    """Busy time, time by operation and idle gaps by host span, from the
    profiler's events (microseconds), inside ``bench.subwindow``."""
    from torch.autograd import DeviceType

    spans, device = [], []
    for e in events:
        name = e.name
        if e.device_type == DeviceType.CUDA:
            if not name.startswith(("bench.", "ProfilerStep")):
                device.append((e.time_range.start, e.time_range.end, name))
        elif name in SPANS:
            spans.append((e.time_range.start, e.time_range.end, name))
    win = [s for s in spans if s[2] == "bench.subwindow"]
    if not win or not device:
        return None
    w0, w1 = win[0][0], win[0][1]
    kernels: Dict[str, float] = {}
    clipped = []
    for a, b, name in device:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        clipped.append((a, b))
        kernels[name] = kernels.get(name, 0.0) + (b - a) * 1e-6
    busy = _union(clipped)
    idle: Dict[str, Tuple[float, int]] = {}
    # the spans nest, so the innermost one holding a moment is the latest
    # started of those that hold it
    inner = sorted(s for s in spans if s[2] != "bench.subwindow")
    starts = [s[0] for s in inner]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        label = "bench.driver"
        for j in range(bisect.bisect_right(starts, g0) - 1, -1, -1):
            if inner[j][1] > g0:
                label = inner[j][2]
                break
            if inner[j][2] == "bench.tick":
                break
        t, n = idle.get(label, (0.0, 0))
        idle[label] = (t + (g1 - g0) * 1e-6, n + 1)
    return Trace((w1 - w0) * 1e-6, sum(b - a for a, b in busy) * 1e-6,
                 kernels, idle)


def breakdown(trace: Trace) -> Dict[str, List]:
    """The ten operations that took most device time, and idle time by
    what the host was doing, longest first."""
    ops = sorted(trace.kernels.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace.idle.items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_ops": [[k[:200], v] for k, v in ops],
            "idle_gaps": [[f"{k} ({n} gaps)", t] for k, (t, n) in gaps]}
