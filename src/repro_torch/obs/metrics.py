"""Unified metrics registry: the single source of truth for discovery
variables, plus labeled counter / gauge / histogram instruments.

CAMEO's causal discovery runs over *named mediating variables* — the
serving counters sampled by the simulator, the fleet, and the real-batcher
replay.  Before this module those names lived in hand-maintained tuples
(``SIM_COUNTER_NAMES`` et al.) that sim and replay had to keep in sync by
convention.  Now each subsystem **declares** its metrics here once, in a
named group, and the legacy tuples are *derived*:

    ``SIM_COUNTER_NAMES``          = ``discovery_names("serving")``
    ``FLEET_COUNTER_NAMES``        = serving + fleet
    ``REPLAY_COUNTER_NAMES``       = serving + replay
    ``REPLAY_FLEET_COUNTER_NAMES`` = serving + replay + fleet

Group concatenation (not global registration order) defines each composite
tuple, so the derived orders are exactly the historical ones — column order
feeds the discovery matrix, so it is part of the numerical contract.

New subsystems register a new group (``declare(..., group="mygroup")``)
and compose it into their environment's counter names instead of appending
to a tuple in someone else's module.

The registry also carries *live* instruments (labeled counters, gauges,
histograms) used by the runtime telemetry (kernel dispatch profiling, jit
cache hit/miss accounting, ``MetricsLogger`` routing).  Instruments are
process-global, thread-safe, and cheap; they are bookkeeping only and never
feed back into scheduling or tuning decisions.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

KINDS = ("counter", "gauge", "histogram")


@dataclass(frozen=True)
class MetricSpec:
    """One declared metric.

    ``discovery=True`` marks a *mediating variable*: it joins the derived
    discovery-name tuple of its group.  ``discovery=False`` declares a
    bookkeeping metric (objective clones like ``latency``/``throughput``,
    runtime telemetry) that reports may include but the causal graph must
    never treat as a mediator.
    """

    name: str
    kind: str = "gauge"
    help: str = ""
    group: str = "default"
    discovery: bool = True
    unit: str = ""

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"metric kind must be one of {KINDS}: {self.kind!r}")


def _labels_key(labels: Mapping[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


@dataclass
class _Histogram:
    count: int = 0
    total: float = 0.0
    vmin: float = math.inf
    vmax: float = -math.inf

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    def summary(self) -> Dict[str, float]:
        mean = self.total / self.count if self.count else 0.0
        return {"count": float(self.count), "sum": self.total,
                "min": self.vmin if self.count else 0.0,
                "max": self.vmax if self.count else 0.0, "mean": mean}


class MetricsRegistry:
    """Declarations (ordered, per group) + live instrument values."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._specs: Dict[str, MetricSpec] = {}
        self._order: List[str] = []
        self._counters: Dict[Tuple[str, Tuple], float] = {}
        self._gauges: Dict[Tuple[str, Tuple], float] = {}
        self._hists: Dict[Tuple[str, Tuple], _Histogram] = {}

    # -- declarations ---------------------------------------------------

    def declare(self, name: str, *, kind: str = "gauge", help: str = "",
                group: str = "default", discovery: bool = True,
                unit: str = "") -> MetricSpec:
        """Register a metric.  Re-declaring with an identical spec is a
        no-op (modules re-import under pytest); a conflicting re-declare
        raises — silent drift between two declarations of one name is the
        exact failure mode this registry exists to prevent."""
        spec = MetricSpec(name=name, kind=kind, help=help, group=group,
                          discovery=discovery, unit=unit)
        with self._lock:
            prev = self._specs.get(name)
            if prev is not None:
                if prev != spec:
                    raise ValueError(
                        f"metric {name!r} already declared as {prev}, "
                        f"conflicting re-declaration {spec}")
                return prev
            self._specs[name] = spec
            self._order.append(name)
            return spec

    def spec(self, name: str) -> MetricSpec:
        with self._lock:
            return self._specs[name]

    def names(self, group: Optional[str] = None) -> Tuple[str, ...]:
        """All declared names, in declaration order (optionally one group)."""
        with self._lock:
            return tuple(n for n in self._order
                         if group is None or self._specs[n].group == group)

    def discovery_names(self, *groups: str) -> Tuple[str, ...]:
        """The discovery-variable tuple: for each group in the order given,
        its ``discovery=True`` metrics in declaration order.  Composite
        surfaces (fleet replay, …) are concatenations of groups — group
        order is the caller's contract, column order is the matrix
        contract."""
        out: List[str] = []
        with self._lock:
            for g in groups:
                out.extend(n for n in self._order
                           if self._specs[n].group == g
                           and self._specs[n].discovery)
        return tuple(out)

    def groups(self) -> Tuple[str, ...]:
        with self._lock:
            seen: List[str] = []
            for n in self._order:
                g = self._specs[n].group
                if g not in seen:
                    seen.append(g)
            return tuple(seen)

    # -- live instruments ----------------------------------------------

    def _known(self, name: str, kind: str) -> None:
        spec = self._specs.get(name)
        if spec is None:
            # auto-declare bookkeeping metrics on first touch; discovery
            # variables must be declared explicitly up front
            self.declare(name, kind=kind, group="runtime", discovery=False)
        elif spec.kind != kind:
            raise ValueError(f"metric {name!r} is a {spec.kind}, not a {kind}")

    def inc(self, name: str, value: float = 1.0, **labels: Any) -> float:
        self._known(name, "counter")
        key = (name, _labels_key(labels))
        with self._lock:
            cur = self._counters.get(key, 0.0) + float(value)
            self._counters[key] = cur
            return cur

    def set(self, name: str, value: float, **labels: Any) -> None:
        self._known(name, "gauge")
        key = (name, _labels_key(labels))
        with self._lock:
            self._gauges[key] = float(value)

    def observe(self, name: str, value: float, **labels: Any) -> None:
        self._known(name, "histogram")
        key = (name, _labels_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = _Histogram()
            h.observe(float(value))

    def value(self, name: str, **labels: Any) -> Optional[float]:
        key = (name, _labels_key(labels))
        with self._lock:
            if key in self._counters:
                return self._counters[key]
            if key in self._gauges:
                return self._gauges[key]
            return None

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """All live instrument values: ``{name: {label_repr: value}}``."""
        def fmt(key: Tuple) -> str:
            return ",".join(f"{k}={v}" for k, v in key) or ""

        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            for (name, lk), v in self._counters.items():
                out.setdefault(name, {})[fmt(lk)] = v
            for (name, lk), v in self._gauges.items():
                out.setdefault(name, {})[fmt(lk)] = v
            for (name, lk), h in self._hists.items():
                out.setdefault(name, {})[fmt(lk)] = h.summary()
        return out

    def reset_values(self) -> None:
        """Clear live instrument values (declarations persist)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


#: the process-global registry every subsystem declares into
REGISTRY = MetricsRegistry()


def declare(name: str, **kw: Any) -> MetricSpec:
    return REGISTRY.declare(name, **kw)


def discovery_names(*groups: str) -> Tuple[str, ...]:
    return REGISTRY.discovery_names(*groups)
