"""Span tracer: monotonic nested spans, zero-cost when disabled, exported as
Chrome trace-event / Perfetto JSON.

Design constraints, in order:

1. **Zero cost disabled.**  No tracer is installed by default; every
   instrumentation site guards on :func:`enabled` (one global read) or calls
   a module helper that returns a shared no-op span.  Instrumented code
   paths draw no RNG, allocate nothing, and take no locks when tracing is
   off — the serving counters, replayed tokens, and tuned trajectories are
   bit-identical with and without the tracer compiled in.
2. **One event vocabulary.**  Everything exports to the Chrome trace-event
   format (the ``{"traceEvents": [...]}`` JSON object Perfetto and
   ``chrome://tracing`` load): complete spans (``ph: "X"``), instants
   (``"i"``), counters (``"C"``), async request lifecycles (``"b"``/``"e"``
   keyed by request uid), and process/thread-name metadata (``"M"``).
3. **Two clocks.**  Wall spans (the real batcher, env measurements, kernel
   dispatch) timestamp from a monotonic epoch captured at tracer start; the
   discrete-event simulator emits spans at *modeled* microseconds on its own
   process track (:data:`TRACK_SIM`), so one trace file holds both the real
   and the modeled view of a serving run.

Tracks are logical Chrome "processes" (integer pids with name metadata):
serving wall time, simulator modeled time, tuner rounds, kernel dispatch,
and environment measurements.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

#: logical process ids of the exported trace (named via "M" metadata events)
TRACK_SERVE = 1     # real batcher / replay wall time
TRACK_SIM = 2       # discrete-event simulator, modeled microseconds
TRACK_TUNER = 3     # per-round tuner events
TRACK_KERNEL = 4    # kernel dispatch resolutions / jit cache
TRACK_ENV = 5       # environment measurements (deploy / warmup / replay)

TRACK_NAMES = {
    TRACK_SERVE: "serving (wall)",
    TRACK_SIM: "simulator (modeled us)",
    TRACK_TUNER: "tuner rounds",
    TRACK_KERNEL: "kernel dispatch",
    TRACK_ENV: "env measurements",
}


class _NullSpan:
    """The shared disabled-path span: every method is a no-op."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, **args: Any) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class _Span:
    """One live complete-event span; records duration on ``__exit__``."""

    __slots__ = ("_tracer", "name", "cat", "track", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, track: int,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.track = track
        self.args = args
        self._t0 = 0.0

    def set(self, **args: Any) -> "_Span":
        """Attach (or overwrite) args on the open span."""
        self.args.update(args)
        return self

    def __enter__(self) -> "_Span":
        self._t0 = self._tracer.now_us()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        self._tracer.complete(self.name, self._t0,
                              self._tracer.now_us() - self._t0,
                              cat=self.cat, track=self.track, **self.args)
        return False


class Tracer:
    """Collects trace events; thread-safe; bounded.

    ``max_events`` caps memory for long traced sweeps — once full, further
    events are counted (``dropped``) instead of stored, and the export
    records the drop count in ``otherData`` so a truncated trace is never
    mistaken for a complete one.
    """

    def __init__(self, clock=time.perf_counter, max_events: int = 1_000_000):
        self._clock = clock
        self._epoch = clock()
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self.max_events = int(max_events)
        self.dropped = 0
        #: structured per-round tuner introspection records, in emission
        #: order — the programmatic dual of the exported tuner track
        self.tuner_rounds: List[Dict[str, Any]] = []

    # -- clocks ---------------------------------------------------------

    def now_us(self) -> float:
        """Microseconds since tracer start (monotonic)."""
        return (self._clock() - self._epoch) * 1e6

    # -- event sinks ----------------------------------------------------

    def _push(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(ev)

    def complete(self, name: str, ts_us: float, dur_us: float, *,
                 cat: str = "span", track: int = TRACK_SERVE,
                 tid: int = 0, **args: Any) -> None:
        """A finished span at an explicit timestamp (``ph: "X"``) — the
        entry point for modeled-time spans, whose clock is the simulator's."""
        self._push({"name": name, "cat": cat, "ph": "X",
                    "ts": round(ts_us, 3), "dur": round(max(dur_us, 0.0), 3),
                    "pid": track, "tid": tid, "args": args})

    def span(self, name: str, *, cat: str = "span",
             track: int = TRACK_SERVE, **args: Any) -> _Span:
        """A context-managed wall-clock span."""
        return _Span(self, name, cat, track, dict(args))

    def instant(self, name: str, *, cat: str = "event",
                track: int = TRACK_SERVE, tid: int = 0,
                ts_us: Optional[float] = None, **args: Any) -> None:
        self._push({"name": name, "cat": cat, "ph": "i", "s": "t",
                    "ts": round(self.now_us() if ts_us is None else ts_us, 3),
                    "pid": track, "tid": tid, "args": args})

    def counter(self, name: str, value: float, *,
                track: int = TRACK_SERVE, tid: int = 0,
                ts_us: Optional[float] = None, series: str = "value") -> None:
        self._push({"name": name, "cat": "counter", "ph": "C",
                    "ts": round(self.now_us() if ts_us is None else ts_us, 3),
                    "pid": track, "tid": tid, "args": {series: float(value)}})

    def async_begin(self, name: str, uid: Any, *, cat: str = "request",
                    track: int = TRACK_SERVE,
                    ts_us: Optional[float] = None, **args: Any) -> None:
        self._push({"name": name, "cat": cat, "ph": "b", "id": str(uid),
                    "ts": round(self.now_us() if ts_us is None else ts_us, 3),
                    "pid": track, "tid": 0, "args": args})

    def async_end(self, name: str, uid: Any, *, cat: str = "request",
                  track: int = TRACK_SERVE,
                  ts_us: Optional[float] = None, **args: Any) -> None:
        self._push({"name": name, "cat": cat, "ph": "e", "id": str(uid),
                    "ts": round(self.now_us() if ts_us is None else ts_us, 3),
                    "pid": track, "tid": 0, "args": args})

    def tuner_event(self, kind: str, **payload: Any) -> None:
        """One structured tuner event: kept as a Python record on
        :attr:`tuner_rounds` AND exported as an instant on the tuner track,
        so the trajectory is inspectable both programmatically and in the
        trace viewer."""
        rec = {"kind": kind, **payload}
        with self._lock:
            self.tuner_rounds.append(rec)
        self.instant(kind, cat="tuner", track=TRACK_TUNER, **_jsonable(payload))

    # -- export ---------------------------------------------------------

    def to_json(self) -> Dict[str, Any]:
        """The Chrome trace-event document (JSON Object Format)."""
        meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                 "args": {"name": label}}
                for pid, label in TRACK_NAMES.items()]
        with self._lock:
            events = list(self._events)
            dropped = self.dropped
        return {
            "traceEvents": meta + [_jsonable_event(e) for e in events],
            "displayTimeUnit": "ms",
            "otherData": {"exporter": "repro_torch.obs", "dropped": dropped,
                          "num_events": len(events)},
        }

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)
        return path

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)


def _jsonable(obj: Any) -> Any:
    """Coerce numpy scalars / tuples / nested dicts to plain JSON types."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if hasattr(obj, "item"):           # numpy scalar
        return obj.item()
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def _jsonable_event(ev: Dict[str, Any]) -> Dict[str, Any]:
    if "args" in ev:
        ev = dict(ev)
        ev["args"] = _jsonable(ev["args"])
    return ev


# --------------------------------------------------------------------------
# the global tracer — one per process, None (disabled) by default
# --------------------------------------------------------------------------

_ACTIVE: Optional[Tracer] = None


def active() -> Optional[Tracer]:
    return _ACTIVE


def enabled() -> bool:
    """The guard every instrumentation site checks first — one global read,
    so the disabled path costs a single attribute load."""
    return _ACTIVE is not None


def start(clock=time.perf_counter, max_events: int = 1_000_000) -> Tracer:
    """Install a fresh global tracer (replacing any active one)."""
    global _ACTIVE
    _ACTIVE = Tracer(clock=clock, max_events=max_events)
    return _ACTIVE


def stop() -> Optional[Tracer]:
    """Uninstall and return the active tracer (None if none was active)."""
    global _ACTIVE
    t, _ACTIVE = _ACTIVE, None
    return t


@contextmanager
def trace_to(path: Optional[str] = None,
             max_events: int = 1_000_000) -> Iterator[Tracer]:
    """Trace everything underneath; export to ``path`` on exit (even when
    the body raises — a partial trace of a failed run is exactly when you
    want one).  Restores the previously-active tracer afterwards."""
    global _ACTIVE
    prev = _ACTIVE
    tracer = start(max_events=max_events)
    try:
        yield tracer
    finally:
        _ACTIVE = prev
        if path:
            tracer.export(path)


# -- module-level helpers: no-ops when disabled -----------------------------

def span(name: str, *, cat: str = "span", track: int = TRACK_SERVE,
         **args: Any):
    t = _ACTIVE
    if t is None:
        return NULL_SPAN
    return t.span(name, cat=cat, track=track, **args)


def instant(name: str, **kw: Any) -> None:
    t = _ACTIVE
    if t is not None:
        t.instant(name, **kw)


def counter(name: str, value: float, **kw: Any) -> None:
    t = _ACTIVE
    if t is not None:
        t.counter(name, value, **kw)


def tuner_event(kind: str, **payload: Any) -> None:
    t = _ACTIVE
    if t is not None:
        t.tuner_event(kind, **payload)
