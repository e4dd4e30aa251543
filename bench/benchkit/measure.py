"""What a per-layer reader (``metrics/<name>.py``) is handed, and the
reckoning that several of them share.

A reader is a module with ``read(run: Run) -> float | None``.  It returns
None where it finds nothing to read (no trace, no prefill in the traced
sub-window), and the harness leaves the metric out of the line.  Readers
of the ticks and of the benchmark's timed spans read them over the
traced run's whole window (``Run.in_window``, ``Run.timed``), where every
cell has prefills and ticks; readers of the device read the traced
sub-window: the ticks that ended inside it and the device's events
inside it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from benchkit import peaks, spec
from benchkit.driver import Tick, Window
from benchkit.trace import Spans, Sub


@dataclass
class Run:
    cell: spec.Cell
    sizes: Dict            # the configuration's ``port`` sizes
    window: Window
    sub: Optional[Sub]
    spans: Optional[Spans]

    def in_window(self) -> List[Tick]:
        """The ticks that ended inside the window and stepped a row."""
        w = self.window
        return [t for t in w.ticks if w.t0 <= t.end < w.t1 and t.rows]

    def timed(self, kind: str) -> List[Tuple[float, float, int]]:
        """The benchmark's timed ``kind`` spans (``prefill``, ``decode``)
        that ended inside the window: (end, seconds, prompt tokens)."""
        if self.spans is None:
            return []
        w = self.window
        return [c for c in self.spans.calls[kind] if w.t0 <= c[0] < w.t1]

    @property
    def num_slots(self) -> int:
        return int(self.cell.mix["num_slots"])

    def ticks(self) -> List[Tick]:
        """The ticks that ended inside the traced sub-window."""
        if self.sub is None:
            return []
        return [t for t in self.window.ticks
                if self.sub.t0 <= t.end <= self.sub.t1]

    def prefills(self) -> List[int]:
        return [n for t in self.ticks() for n in t.prefills]

    def contexts(self) -> List[int]:
        return [c for t in self.ticks() for c in t.contexts]

    def roofline(self, kernel: str, calls: List[tuple],
                 *patterns: str) -> Optional[float]:
        """Percent of its roofline that ``kernel`` reached: the least time
        of ``calls`` (argument tuples of ``roofline/<kernel>.py::work``)
        over the device time of the operations whose names hold every
        pattern."""
        if self.sub is None or self.sub.trace is None or not calls:
            return None
        device = self.sub.trace.time_of(*patterns)
        if device <= 0.0:
            return None
        mod = self.cell.module("roofline", kernel)
        least = sum(peaks.least_seconds(*mod.work(*c), mod.PRECISION)
                    for c in calls)
        return 100.0 * least / device

    def mfu(self) -> Optional[float]:
        """Percent of the chip's bf16 peak: the model FLOPs of the prompts
        prefilled and the rows decoded in the sub-window
        (``roofline/model_<family>.py``) over its length."""
        if self.sub is None or self.sub.trace is None:
            return None
        mod = self.cell.module("roofline",
                               f"model_{self.cell.config['family']}")
        flops = sum(mod.prefill_flops(self.sizes, n) for n in self.prefills())
        flops += sum(mod.decode_flops(self.sizes, c) for c in self.contexts())
        if flops == 0:
            return None
        return 100.0 * flops / (self.sub.trace.window_s * peaks.FLOPS["bf16"])

    def idle_share(self) -> Optional[float]:
        """Percent of the sub-window in which no operation ran on the
        device."""
        if self.sub is None or self.sub.trace is None:
            return None
        tr = self.sub.trace
        return 100.0 * (1.0 - tr.busy_s / tr.window_s)
