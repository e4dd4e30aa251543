"""Observability subsystem: span tracing and the unified metrics registry.

Carried over from :mod:`repro.obs` (pure Python, no jax).

- :mod:`repro_torch.obs.trace` — nested span tracer with Chrome trace-event /
  Perfetto JSON export; zero-cost (and bit-identical) when disabled.
- :mod:`repro_torch.obs.metrics` — the metrics registry that is the single
  source of truth for discovery-variable names, plus labeled runtime
  instruments.
- :mod:`repro_torch.obs.report` — summaries of an exported trace and the
  schema check every exported trace must pass
  (``python -m repro_torch.obs.report trace.json``).
"""

from repro_torch.obs import trace
from repro_torch.obs.metrics import REGISTRY, MetricSpec, MetricsRegistry, declare, discovery_names
from repro_torch.obs.trace import (
    NULL_SPAN,
    TRACK_ENV,
    TRACK_KERNEL,
    TRACK_SERVE,
    TRACK_SIM,
    TRACK_TUNER,
    Tracer,
    active,
    enabled,
    span,
    start,
    stop,
    trace_to,
)

__all__ = [
    "trace",
    "REGISTRY",
    "MetricSpec",
    "MetricsRegistry",
    "declare",
    "discovery_names",
    "NULL_SPAN",
    "TRACK_ENV",
    "TRACK_KERNEL",
    "TRACK_SERVE",
    "TRACK_SIM",
    "TRACK_TUNER",
    "Tracer",
    "active",
    "enabled",
    "span",
    "start",
    "stop",
    "trace_to",
]
