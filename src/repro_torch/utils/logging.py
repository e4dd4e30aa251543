"""Structured run logging (stderr + JSONL metrics file) — the port of
:mod:`repro.utils.logging`.

``MetricsLogger`` is a context manager — ``with MetricsLogger(path=...) as
log:`` releases the JSONL handle on exceptions — and every numeric metric
it logs is mirrored into the process-wide observability registry
(:data:`repro_torch.obs.metrics.REGISTRY`) as a gauge labelled with the
logger name.  A record is ``{"step", "t", metrics...}`` with every
metric that has an ``item`` (a 0-d tensor, a numpy scalar) as a float; the
stderr line is ``[name] k=v ...``.  ``close()`` is idempotent.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional

from repro_torch.obs import metrics as obs_metrics


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, name: str = "run"):
        self.name = name
        self.path = path
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        # repro: ignore[wall-clock] -- the record's "t", as the reference's logger writes it
        self._t0 = time.time()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def log(self, step: int, **metrics: Any) -> None:
        # repro: ignore[wall-clock] -- the record's "t", as the reference's logger writes it
        t = round(time.time() - self._t0, 3)
        rec: Dict[str, Any] = {"step": step, "t": t}
        rec.update({k: (float(v) if hasattr(v, "item") else v)
                    for k, v in metrics.items()})
        for k, v in rec.items():
            if k not in ("step", "t") and isinstance(v, (int, float)) \
                    and not isinstance(v, bool):
                try:
                    obs_metrics.REGISTRY.set(k, float(v), logger=self.name)
                except ValueError:
                    # name declared as a non-gauge elsewhere: logging must
                    # never fail over a registry kind collision
                    pass
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
        msg = " ".join(f"{k}={_fmt(v)}" for k, v in rec.items())
        print(f"[{self.name}] {msg}", file=sys.stderr)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.6g}"
    return v
