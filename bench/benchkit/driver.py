"""Deploy the port's continuous batcher for one cell and drive its traffic
for the window.

Everything timed goes through ``ContinuousBatcher.submit`` and
``tick``: batch-1 prefill on admission, then one decode step (the
captured CUDA graph at ``num_slots`` rows) for every resident.  The
driver reads the batcher from outside: its lifetime counters, the
``RequestState`` of each request (``admitted_at`` is set once the first
token is on the host) and its tokens after each tick.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchkit import traffic
from benchkit.traffic import Planned

#: seconds past the window's close allowed for every request due in it to
#: reach its first token (an open loop's time to first token counts them)
FIRST_TOKEN_GRACE_S = 60.0


@dataclass
class Tick:
    """One tick as the host saw it: when it returned, and what it did."""
    end: float
    rows: int                     # live requests its decode step stepped
    prefills: List[int]           # prompt lengths admitted in it
    contexts: List[int]           # cache rows each decoded row attended


@dataclass
class Window:
    """What the window served, on the host clock."""
    t0: float = 0.0
    t1: float = 0.0
    times: Dict[int, List[float]] = field(default_factory=dict)
    planned: Dict[int, Planned] = field(default_factory=dict)
    states: Dict[int, object] = field(default_factory=dict)
    ticks: List[Tick] = field(default_factory=list)
    ttft_s: List[float] = field(default_factory=list)
    lateness_s: List[float] = field(default_factory=list)
    attempted: int = 0
    failed: int = 0


def deploy(cfg, config: Dict, mix: Dict, params, device: torch.device,
           seed: int):
    """The batcher of the configuration's serving plan at the mix's slot
    count: dense, or paged with a pool that holds every slot's worst case
    (no admission is ever deferred for pages)."""
    from repro_torch.models.model import build_model
    from repro_torch.serving.paging import PagedPlan
    from repro_torch.serving.scheduler import ContinuousBatcher
    from repro_torch.utils.config import MeshConfig, RunConfig, ShapeConfig

    slots = int(mix["num_slots"])
    rows = traffic.longest(mix)
    run = RunConfig(model=cfg, shape=ShapeConfig("bench", rows, slots,
                                                 "decode"),
                    mesh=MeshConfig(shape=(1,), axes=("data",)))
    model = build_model(cfg, run.parallel, device=device)
    serving = config["serving"]
    plan = None
    if serving["paged"]:
        page = int(serving["page_size"])
        per_slot = -(-rows // page)
        plan = PagedPlan(paging=True, pool_pages=slots * per_slot,
                         page_size=page, pages_per_slot_max=per_slot)
    return ContinuousBatcher(model, run, params, num_slots=slots,
                             cache_len=rows, paged=plan, seed=seed)


def warm_up(batcher, mix: Dict, vocab: int) -> None:
    """Prefill the mix's shortest, middle and longest prompt and decode
    two steps at the cell's slot count: the decode graph is captured and
    replayed, every prefill shape the window starts from has run."""
    from repro_torch.serving.scheduler import Request

    rng = np.random.default_rng(0)
    for i, n in enumerate(traffic.warmup_lengths(mix)):
        batcher.submit(Request(uid=-1 - i, prompt=rng.integers(
            0, vocab, n).astype(np.int32), max_new_tokens=3))
    batcher.run_until_drained(max_ticks=100)
    batcher.completed.clear()


class Driver:
    """Drives one window through ``batcher``; ``on_tick(now)`` runs after
    every tick (the traced run starts and stops its profiler there)."""

    def __init__(self, batcher, clock: Callable[[], float] = time.perf_counter,
                 on_tick: Optional[Callable[[float], None]] = None):
        self.b = batcher
        self.clock = clock
        self.on_tick = on_tick
        self.w = Window()
        self._done = 0

    def _submit(self, req: Planned) -> None:
        from repro_torch.serving.scheduler import Request

        self.w.planned[req.uid] = req
        self.w.attempted += 1
        before = self.b.rejected_too_long
        self.b.submit(Request(uid=req.uid, prompt=req.prompt,
                              max_new_tokens=req.max_new_tokens))
        self.w.failed += self.b.rejected_too_long - before

    def _tick(self) -> List[object]:
        """One tick; records each request's new tokens and returns the
        requests that finished in it."""
        rows = self.b.tick()
        end = self.clock()
        finished = self.b.completed[self._done:]
        self._done = len(self.b.completed)
        live = [s for s in self.b._slots if s is not None]
        prefills, contexts = [], []
        for rs in live + finished:
            uid = rs.request.uid
            ts = self.w.times.get(uid)
            if ts is None:
                ts = self.w.times[uid] = [rs.admitted_at]
                self.w.states[uid] = rs
                prefills.append(len(rs.request.prompt))
            if len(rs.generated) > max(len(ts), 1):
                contexts.append(len(rs.request.prompt)
                                + len(rs.generated) - 1)
            ts.extend([end] * (len(rs.generated) - len(ts)))
        self.w.ticks.append(Tick(end, rows, prefills, contexts))
        if self.on_tick is not None:
            self.on_tick(end)
        return finished

    def closed(self, queues: List[List[Planned]], seconds: float) -> Window:
        """Each client sends its first request (part of the way through,
        ``traffic.closed_loop``) before the window and its next one as
        soon as its last one finishes.  The window opens once every
        client's first request has its first token, and closes
        ``seconds`` later."""
        nxt = [0] * len(queues)
        client_of: Dict[int, int] = {}
        first = set()
        for c, q in enumerate(queues):
            if q:
                self._submit(q[0])
                client_of[q[0].uid] = c
                first.add(q[0].uid)
                nxt[c] = 1
        t1 = None
        while t1 is None or self.clock() < t1:
            for rs in self._tick():
                c = client_of[rs.request.uid]
                if nxt[c] < len(queues[c]):
                    req = queues[c][nxt[c]]
                    nxt[c] += 1
                    client_of[req.uid] = c
                    self._submit(req)
            if t1 is None and first <= set(self.w.times):
                self.w.t0 = self.clock()
                self.w.t1 = t1 = self.w.t0 + seconds
        return self.w

    def open(self, schedule: List[Planned], seconds: float,
             warm_s: float = 0.0) -> Window:
        """Each request is submitted at its due time (at the first tick
        boundary after it) whatever is in flight, from ``warm_s`` before
        the window opens; after the close, ticks go on until every
        request due in the window has its first token.  Each request's
        time to first token is counted from its due time, for those due
        inside the window."""
        self.w.t0 = t0 = self.clock() + warm_s
        self.w.t1 = t1 = t0 + seconds
        due = [(t0 + r.due_s, r) for r in schedule if r.due_s < seconds]
        i = 0
        while True:
            now = self.clock()
            while i < len(due) and due[i][0] <= now:
                self._submit(due[i][1])
                self.w.lateness_s.append(now - due[i][0])
                i += 1
            waiting = [r.uid for _, r in due[:i]
                       if r.uid not in self.w.times]
            if now >= t1 and i == len(due) and not waiting:
                break
            if now >= t1 + FIRST_TOKEN_GRACE_S:
                break
            busy = self.b.queue or any(s is not None for s in self.b._slots)
            if busy:
                self._tick()
            elif i < len(due):
                time.sleep(max(due[i][0] - now, 0.0))
            elif now < t1:
                time.sleep(t1 - now)
        for d, r in due:
            ts = self.w.times.get(r.uid)
            if ts is None:
                self.w.failed += 1
            elif r.due_s >= 0.0:
                self.w.ttft_s.append(ts[0] - d)
        return self.w


def finished(w: Window) -> Dict[int, int]:
    """uid -> tokens served, of every request that finished."""
    return {uid: len(rs.generated) for uid, rs in w.states.items()
            if rs.done}
