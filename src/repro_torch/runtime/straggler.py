"""Straggler detection for multi-host training and fleet serving.

Each host reports its per-step wall time; the monitor keeps an EWMA per host
and flags hosts whose smoothed time exceeds ``threshold`` x the fleet median.
On a real deployment the report is an all-gather of scalars (microseconds of
overhead); here the same logic is driven by the driver loop / the fleet
serving simulator (``repro_torch.workloads.sim.FleetSimulator``) / tests.

Reports may be PARTIAL: a host that did no work this step (an idle serving
replica, a host mid-restart) is simply absent from ``step_times``.  Seeding
is therefore per-host — the first report *from that host* seeds its EWMA —
and the fleet median is computed only over hosts that have reported at
least once, so silent hosts neither drag the median toward zero nor get
spuriously flagged.

Mitigation hooks:
- ``flagged()`` — hosts to alert on / drain,
- ``should_exclude(host)`` — persistent stragglers (flagged ``patience``
  consecutive checks) that elastic re-meshing should drop (see
  ``runtime.elastic``).
"""

from __future__ import annotations

from typing import Dict, List


class StragglerMonitor:
    def __init__(self, num_hosts: int, alpha: float = 0.2,
                 threshold: float = 1.5, patience: int = 3):
        self.num_hosts = num_hosts
        self.alpha = alpha
        self.threshold = threshold
        self.patience = patience
        self._ewma: List[float] = [0.0] * num_hosts
        self._seen: List[bool] = [False] * num_hosts
        self._flag_streak: List[int] = [0] * num_hosts

    def report(self, step_times: Dict[int, float]) -> None:
        """step_times: host_id -> seconds for this step (hosts that did no
        work this step are absent — a late joiner's first report seeds its
        EWMA instead of being blended from 0.0)."""
        for h, t in step_times.items():
            if not self._seen[h]:
                self._ewma[h] = t
                self._seen[h] = True
            else:
                self._ewma[h] = (1 - self.alpha) * self._ewma[h] + self.alpha * t
        med = self._median()
        for h in range(self.num_hosts):
            if (self._seen[h] and med > 0
                    and self._ewma[h] > self.threshold * med):
                self._flag_streak[h] += 1
            else:
                self._flag_streak[h] = 0

    def _median(self) -> float:
        """Median EWMA over hosts with at least one report (0.0 before any
        report) — never-reporting hosts hold EWMA 0.0 and would otherwise
        bias the fleet median down, flagging healthy hosts."""
        xs = sorted(e for e, seen in zip(self._ewma, self._seen) if seen)
        n = len(xs)
        if n == 0:
            return 0.0
        return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])

    def flagged(self) -> List[int]:
        return [h for h in range(self.num_hosts) if self._flag_streak[h] >= 1]

    def should_exclude(self, host: int) -> bool:
        return self._flag_streak[host] >= self.patience

    def excluded(self) -> List[int]:
        return [h for h in range(self.num_hosts) if self.should_exclude(h)]
