"""Continuous-batching serving scheduler — the port of
:mod:`repro.serving.scheduler`.

The batcher keeps a fixed number of SLOTS (the decode batch), admits new
requests into free slots as running ones finish, and runs one decode step
per tick for whatever is resident; empty slots carry a pad token and their
outputs are ignored.  Prefill runs per admitted request (batch 1) and its
cache is scattered into the slot's rows of the shared stacked cache — or,
for a paged deployment, into the pool pages reserved for the request.

The shared state is the model's decode-state tree (KV caches, recurrent
SSM states, the hybrid's ``{"mixer", "shared_kv"}`` dicts, every leaf
stacked over the super-blocks); the scatters walk it as the reference's
``jax.tree.map`` does.

Scheduling decisions (admission, page reservation, chunked prefill,
retirement, tick counts) are the reference's, step for step, so at
temperature 0 the port reproduces the reference's tokens, completion order
and counters.  Differences: the shared state is updated in place, and
sampled (temperature > 0) rows draw from the batcher's own seeded
``torch.Generator`` — the reference's ``jax.random`` stream cannot be
reproduced.  Step times are taken around a ``torch.cuda.synchronize()``
where the reference blocks on the result.

Each request's lifecycle is recorded on its :class:`RequestState`, one
``time.perf_counter()`` reading a boundary, whether or not a tracer is
on: submitted, dequeued, prefill started, prefill enqueued (every kernel
of the forward queued), prefill done (after the synchronize), admitted
(slot scattered, first token on the host), finished.  With a tracer
active the request's serve spans are built from the same readings:
``queue`` (submitted -> dequeued), ``chunking`` (dequeued -> prefill
started, chunked prefill only), ``prefill`` (started -> done) with its
children ``prefill.enqueue`` and ``prefill.sync``, and ``seat`` (done ->
admitted); a tick's ``decode_tick`` is followed by ``sample`` (token
choice and readback).  The spans place the readings on the tracer's
clock, which is ``time.perf_counter`` for every tracer that
``obs_trace.start`` / ``trace_to`` installs.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.attention import PagedKVCache
from repro_torch.models.model import Model
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.paging import PagedPlan
from repro_torch.train.serve_step import ServeState, jitted_steps, sample_token
from repro_torch.utils.config import RunConfig
from repro_torch.utils.device import synchronize


class PromptTooLong(ValueError):
    """A submitted request can never fit its serving deployment: prompt plus
    worst-case generation exceeds the dense ``cache_len`` or the paged slot
    capacity / page pool."""

    def __init__(self, uid: int, needed: int, limit: int, what: str):
        super().__init__(
            f"request {uid} needs {needed} cache tokens but the {what} "
            f"holds {limit}; it would silently truncate — reject it or "
            f"deploy a larger geometry")
        self.uid = uid
        self.needed = needed
        self.limit = limit


class DrainStall(RuntimeError):
    """A drain loop hit its tick budget with requests still queued or
    resident — a stall, not a completed run."""

    def __init__(self, msg: str, *, completed: int, pending: int):
        super().__init__(msg)
        self.completed = completed
        self.pending = pending


@dataclass
class Request:
    uid: int
    prompt: np.ndarray                  # (prompt_len,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    extras: Dict[str, np.ndarray] = field(default_factory=dict)


@dataclass
class RequestState:
    """A seated request and its lifecycle, as ``time.perf_counter()``
    readings (module docstring); on the dense path one reading is both
    ``dequeued_at`` and ``prefill_started_at``, as the request is popped
    for its prefill."""
    request: Request
    slot: int
    generated: List[int] = field(default_factory=list)
    admitted_at: float = 0.0
    finished_at: Optional[float] = None
    submitted_at: float = 0.0
    dequeued_at: float = 0.0
    prefill_started_at: float = 0.0
    prefill_enqueued_at: float = 0.0
    prefill_done_at: float = 0.0

    @property
    def done(self) -> bool:
        return self.finished_at is not None


def _walk(fn, dst, src=None) -> None:
    """Call ``fn(dst_node, src_node)`` top-down over a decode-state tree
    (dicts, and records such as KV caches and SSM states, down to tensor
    leaves), ``src`` walked beside ``dst`` (or None throughout); a node for
    which ``fn`` returns True is not descended into."""
    if fn(dst, src):
        return
    if isinstance(dst, dict):
        for key in sorted(dst):
            _walk(fn, dst[key], None if src is None else src[key])
    elif isinstance(dst, tuple):
        for i, d in enumerate(dst):
            _walk(fn, d, None if src is None else src[i])


def _scatter_leaf(dst: torch.Tensor, src: torch.Tensor, slot: int) -> None:
    """In place: a batch-1 leaf into batch row ``slot``; the slot is axis
    1 of a stacked (layers, batch, ...) leaf, axis 0 of a flat one."""
    if dst.ndim == src.ndim and dst.shape == src.shape:
        return  # shared/static leaf — keep
    if dst.ndim >= 2 and src.ndim == dst.ndim and \
            src.shape[0] == dst.shape[0] and src.shape[1] == 1:
        dst[:, slot] = src[:, 0]
    elif src.ndim == dst.ndim and src.shape[0] == 1:
        dst[slot] = src[0]
    else:
        raise ValueError(f"unscatterable leaf {tuple(src.shape)} -> "
                         f"{tuple(dst.shape)}")


def _scatter_rows(dst_tree, src_tree, slot: int):
    """Write src (batch-1 state rows) into dst at batch row ``slot``, in
    place, leaf by leaf (KV rows, lengths and recurrent states alike)."""
    def one(dst, src) -> bool:
        if isinstance(dst, torch.Tensor):
            _scatter_leaf(dst, src, slot)
            return True
        return False

    _walk(one, dst_tree, src_tree)
    return dst_tree


def _scatter_paged_rows(dst_tree, src_tree, slot: int, pages: List[int],
                        page_size: int, pages_per_slot_max: int,
                        scratch_page: int):
    """Write a dense batch-1 prefill state into slot ``slot`` of a paged
    decode state, in place: KV rows land in the slot's reserved pool
    ``pages``, the slot's table row is rewritten wholesale (tail entries
    pinned to the scratch page — valid and owned by nobody), and recurrent
    (SSM) leaves scatter as in the dense path."""
    table_row = torch.full((pages_per_slot_max,), scratch_page,
                           dtype=torch.int32)
    table_row[:len(pages)] = torch.tensor(pages, dtype=torch.int32)
    n = len(pages)

    def one(dst, src) -> bool:
        if isinstance(dst, torch.Tensor):
            _scatter_leaf(dst, src, slot)
            return True
        if not isinstance(dst, PagedKVCache):
            return False
        dev = dst.k_pages.device
        pages_t = torch.tensor(pages, dtype=torch.long, device=dev)
        nsb = src.k.shape[0]
        for pool, dense in ((dst.k_pages, src.k), (dst.v_pages, src.v)):
            rows = dense[:, 0, :n * page_size]
            pool[:, pages_t] = rows.reshape(nsb, n, page_size,
                                            *rows.shape[2:])
        dst.page_table[:, slot] = table_row.to(dev)[None]
        dst.length[:, slot] = src.length[:, 0]
        return True

    _walk(one, dst_tree, src_tree)
    return dst_tree


class ContinuousBatcher:
    def __init__(self, model: Model, run: RunConfig, params, *,
                 num_slots: int = 8, cache_len: int = 512,
                 eos_token: Optional[int] = None, seed: int = 0,
                 launch_config: Optional[Dict[str, Any]] = None,
                 interleave: str = "eager",
                 paged: Optional[PagedPlan] = None,
                 on_too_long: str = "raise"):
        if interleave not in ("eager", "drain"):
            raise ValueError(
                f"unknown interleave policy {interleave!r}; "
                f"known: ['drain', 'eager']")
        if on_too_long not in ("raise", "reject"):
            raise ValueError(f"on_too_long must be 'raise' or 'reject', "
                             f"got {on_too_long!r}")
        self.model = model
        self.run = run
        self.params = params
        self.device = model.device
        self.num_slots = num_slots
        self.eos_token = eos_token
        self.interleave = interleave
        self.on_too_long = on_too_long
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

        self.paged = paged if (paged is not None and paged.paging) else None
        if self.paged is not None:
            if model.init_paged_decode_state is None:
                raise NotImplementedError(
                    f"model family {model.cfg.family!r} has no paged decode "
                    f"state; serve it dense (pages.paging=off)")
            # the decode shape is the (pool, page) geometry: per-slot
            # capacity is a page-table property, so `cache_len` is
            # superseded by page_size * pages_per_slot_max
            self.cache_len = self.paged.slot_capacity
            caches = model.init_paged_decode_state(
                num_slots, self.paged.pool_pages, self.paged.page_size,
                self.paged.pages_per_slot_max)
            self._free_pages: List[int] = list(range(self.paged.pool_pages))
            self._slot_pages: List[List[int]] = [[] for _ in range(num_slots)]
        else:
            self.cache_len = cache_len
            caches = model.init_decode_state(num_slots, cache_len)

        # prefill always runs dense — for paged deployments at the slot
        # capacity, then page-scattered
        self._prefill, self._decode = jitted_steps(
            model, run, cache_len=self.cache_len, launch_config=launch_config)

        self.state = ServeState(
            caches=caches,
            lengths=torch.zeros((num_slots,), dtype=torch.int32,
                                device=self.device),
            extras={})
        self._tokens = torch.zeros((num_slots,), dtype=torch.int32,
                                   device=self.device)
        self._slots: List[Optional[RequestState]] = [None] * num_slots
        self.queue: List[Request] = []
        # the submit reading of each queued request, in the queue's order
        self._submitted_at: List[float] = []
        self.completed: List[RequestState] = []
        # chunked prefill in flight: [request, tokens_done, slot, pages,
        # submitted_at, dequeued_at]
        self._prefilling: Optional[List[Any]] = None
        self.rejected_too_long = 0
        self.prefill_chunks = 0
        self.ticks = 0
        self.stalled = False
        self._occupancy_sum = 0
        self._pool_occ_sum = 0.0
        self._chunks_inflight_sum = 0.0
        # lifetime wall time inside prefill vs decode steps
        self.prefill_s = 0.0
        self.decode_s = 0.0

    # -- admission ----------------------------------------------------------

    def _worst_case_tokens(self, request: Request) -> int:
        """Cache rows this request can ever occupy: the prompt plus every
        decode-tick write (the first token comes from prefill)."""
        return len(request.prompt) + max(request.max_new_tokens - 1, 0)

    def submit(self, request: Request) -> None:
        """Enqueue a request, rejecting (or raising, per ``on_too_long``)
        any that could never fit the deployed geometry."""
        needed = self._worst_case_tokens(request)
        if self.paged is not None:
            limit = min(self.paged.slot_capacity,
                        self.paged.pool_pages * self.paged.page_size)
            what = "paged slot"
        else:
            limit = self.cache_len
            what = "dense cache"
        if needed > limit:
            if self.on_too_long == "raise":
                raise PromptTooLong(request.uid, needed, limit, what)
            self.rejected_too_long += 1
            tr = obs_trace.active()
            if tr is not None:
                tr.instant("reject_too_long", cat="request",
                           uid=request.uid, needed=needed, limit=limit)
            return
        # repro: ignore[wall-clock] -- request lifecycle record (submitted_at), allow-listed in the reference's scheduler.py
        now = time.perf_counter()
        tr = obs_trace.active()
        if tr is not None:
            tr.async_begin("request", request.uid, ts_us=tr.us_at(now),
                           prompt_len=len(request.prompt),
                           max_new=request.max_new_tokens)
        self.queue.append(request)
        self._submitted_at.append(now)

    def _dequeue(self) -> Tuple[Request, float]:
        """Pop the queue's head and its submit reading."""
        return self.queue.pop(0), self._submitted_at.pop(0)

    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def _prefill_and_seat(self, req: Request, slot: int,
                          pages: Optional[List[int]], submitted_at: float,
                          dequeued_at: Optional[float] = None) -> None:
        """Run the (dense, batch-1) prefill and seat the request in
        ``slot`` — scattered into its reserved ``pages`` when paged.
        ``dequeued_at`` is given where the request left the queue before
        its prefill (chunked prefill); otherwise it is popped for this
        prefill, and the prefill's start is its dequeue."""
        # repro: ignore[wall-clock] -- request lifecycle record (prefill_started_at), allow-listed in the reference's scheduler.py
        started = time.perf_counter()
        chunked = dequeued_at is not None
        if not chunked:
            dequeued_at = started
        tr = obs_trace.active()
        if tr is not None:
            tr.between("queue", submitted_at, dequeued_at, cat="request",
                       uid=req.uid)
            if chunked:
                tr.between("chunking", dequeued_at, started, cat="request",
                           uid=req.uid)
            tr.instant("admit", cat="request", ts_us=tr.us_at(started),
                       uid=req.uid, slot=slot,
                       pages=len(pages) if pages is not None else 0)
        with obs_trace.span("prefill", cat="request", t0=started,
                            uid=req.uid, prompt_len=len(req.prompt)) as whole:
            with obs_trace.span("prefill.enqueue", cat="request",
                                t0=started, uid=req.uid) as sp:
                prompt = torch.as_tensor(np.asarray(req.prompt, np.int32),
                                         device=self.device)[None, :]
                one_state, logits = self._prefill(self.params,
                                                  {"tokens": prompt})
                # repro: ignore[wall-clock] -- request lifecycle record (prefill_enqueued_at), allow-listed in the reference's scheduler.py
                enqueued = sp.end(time.perf_counter())
            with obs_trace.span("prefill.sync", cat="request", t0=enqueued,
                                uid=req.uid) as sp:
                synchronize(self.device)
                # repro: ignore[wall-clock] -- request lifecycle record (prefill_done_at), allow-listed in the reference's scheduler.py
                done = sp.end(time.perf_counter())
            whole.end(done)
        self.prefill_s += done - started
        with obs_trace.span("seat", cat="request", t0=done, uid=req.uid,
                            slot=slot) as sp:
            if pages is not None:
                _scatter_paged_rows(
                    self.state.caches, one_state.caches, slot, pages,
                    self.paged.page_size, self.paged.pages_per_slot_max,
                    scratch_page=self.paged.pool_pages)
            else:
                _scatter_rows(self.state.caches, one_state.caches, slot)
            self.state.lengths[slot] = one_state.lengths[0]
            tok = int(sample_token(logits, self._gen, req.temperature)[0])
            # repro: ignore[wall-clock] -- request admission timestamp, allow-listed in the reference's scheduler.py
            admitted = sp.end(time.perf_counter())
        rs = RequestState(req, slot, admitted_at=admitted,
                          submitted_at=submitted_at, dequeued_at=dequeued_at,
                          prefill_started_at=started,
                          prefill_enqueued_at=enqueued,
                          prefill_done_at=done)
        rs.generated.append(tok)
        self._tokens[slot] = tok
        self._slots[slot] = rs
        self._maybe_finish(rs, tok)

    def _admit(self) -> None:
        if self.interleave == "drain" and \
                any(s is not None for s in self._slots):
            # drain policy: refill only once the resident batch empties
            return
        if self.paged is not None and self.paged.prefill_chunk > 0:
            self._admit_chunked()
            return
        for slot in self._free_slots():
            if not self.queue:
                break
            if self.paged is not None:
                # reserve the worst case up front: the batcher never grows a
                # resident mid-flight, so an exhausted pool defers admission
                need = self.paged.pages_for(
                    self._worst_case_tokens(self.queue[0]))
                if need > len(self._free_pages):
                    obs_trace.instant("defer", cat="request",
                                      uid=self.queue[0].uid, need=need,
                                      free=len(self._free_pages))
                    break
                pages = [self._free_pages.pop(0) for _ in range(need)]
                self._slot_pages[slot] = pages
                obs_trace.instant("page_reserve", cat="request",
                                  uid=self.queue[0].uid, pages=need,
                                  free=len(self._free_pages))
            else:
                pages = None
            req, submitted_at = self._dequeue()
            self._prefill_and_seat(req, slot, pages, submitted_at)

    def _admit_chunked(self) -> None:
        """Chunked-prefill admission: one prompt chunk per tick, decode
        ticking underneath; the prefill itself runs once, over the full
        prompt, when the last chunk lands (a scheduling decision — tokens
        are unchanged)."""
        if self._prefilling is not None:
            req, done, slot, pages, submitted_at, dequeued_at = \
                self._prefilling
            done += min(self.paged.prefill_chunk, len(req.prompt) - done)
            self.prefill_chunks += 1
            obs_trace.instant("prefill_chunk", cat="request", uid=req.uid,
                              done=done, prompt_len=len(req.prompt))
            if done >= len(req.prompt):
                self._prefilling = None
                self._prefill_and_seat(req, slot, pages, submitted_at,
                                       dequeued_at)
            else:
                self._prefilling[1] = done
            return
        free = self._free_slots()
        if not self.queue or not free:
            return
        need = self.paged.pages_for(self._worst_case_tokens(self.queue[0]))
        if need > len(self._free_pages):
            obs_trace.instant("defer", cat="request", uid=self.queue[0].uid,
                              need=need, free=len(self._free_pages))
            return
        slot = free[0]
        pages = [self._free_pages.pop(0) for _ in range(need)]
        self._slot_pages[slot] = pages
        obs_trace.instant("page_reserve", cat="request",
                          uid=self.queue[0].uid, pages=need,
                          free=len(self._free_pages))
        req, submitted_at = self._dequeue()
        # repro: ignore[wall-clock] -- request lifecycle record (dequeued_at), allow-listed in the reference's scheduler.py
        dequeued_at = time.perf_counter()
        self._prefilling = [req, 0, slot, pages, submitted_at, dequeued_at]

    # -- stepping -----------------------------------------------------------

    def _maybe_finish(self, rs: RequestState, tok: int) -> None:
        if rs.done:
            return
        if (self.eos_token is not None and tok == self.eos_token) or \
                len(rs.generated) >= rs.request.max_new_tokens:
            # repro: ignore[wall-clock] -- request completion timestamp, allow-listed in the reference's scheduler.py
            rs.finished_at = time.perf_counter()
            self.completed.append(rs)
            self._slots[rs.slot] = None
            tr = obs_trace.active()
            if tr is not None:
                tr.instant("retire", cat="request", uid=rs.request.uid,
                           generated=len(rs.generated))
                tr.async_end("request", rs.request.uid,
                             generated=len(rs.generated))
            if self.paged is not None:
                self._free_pages.extend(self._slot_pages[rs.slot])
                self._slot_pages[rs.slot] = []
                self._park_slot(rs.slot)

    def _park_slot(self, slot: int) -> None:
        """Point a freed slot's page-table rows back at the scratch page:
        the empty slot keeps writing pad-token K/V every tick, and those
        writes must not land on pages a later owner holds."""
        def one(cache, _) -> bool:
            if isinstance(cache, PagedKVCache):
                cache.page_table[:, slot] = self.paged.pool_pages
                return True
            return isinstance(cache, torch.Tensor)

        _walk(one, self.state.caches)

    def tick(self) -> int:
        """Admit + one decode step for all resident requests.
        Returns the number of live requests stepped."""
        self._admit()
        live = [s for s in self._slots if s is not None]
        if not live:
            return 0
        self.ticks += 1
        self._occupancy_sum += len(live)
        if self.paged is not None:
            self._pool_occ_sum += ((self.paged.pool_pages
                                    - len(self._free_pages))
                                   / self.paged.pool_pages)
            self._chunks_inflight_sum += (
                1.0 if self._prefilling is not None else 0.0)
        tr = obs_trace.active()
        if tr is not None:
            tr.counter("queue_depth", len(self.queue))
        # repro: ignore[wall-clock] -- serving wall accounting (decode_s), allow-listed in the reference's scheduler.py
        t0 = time.perf_counter()
        with obs_trace.span("decode_tick", cat="serve", live=len(live),
                            tick=self.ticks):
            new_state, logits = self._decode(self.params, self.state,
                                             self._tokens[:, None])
            synchronize(self.device)
        # repro: ignore[wall-clock] -- serving wall accounting (decode_s), allow-listed in the reference's scheduler.py
        self.decode_s += time.perf_counter() - t0
        self.state = new_state
        with obs_trace.span("sample", cat="serve", tick=self.ticks):
            # per-slot temperatures: each resident row decodes at its own
            # temperature (empty slots greedily, into ignored outputs); the
            # all-greedy batch keeps the argmax-only path
            if any(rs.request.temperature > 0.0 for rs in live):
                temps = torch.zeros((self.num_slots,), dtype=torch.float32)
                for rs in live:
                    temps[rs.slot] = rs.request.temperature
                toks = sample_token(logits, self._gen, temps.to(self.device))
            else:
                toks = sample_token(logits, self._gen, 0.0)
            # live rows take their new token; empty slots keep their pad
            # token
            live_rows = torch.zeros((self.num_slots,), dtype=torch.bool)
            live_rows[[rs.slot for rs in live]] = True
            self._tokens = torch.where(live_rows.to(self.device), toks,
                                       self._tokens)
            host = toks.tolist()
        for rs in list(live):
            tok = int(host[rs.slot])
            rs.generated.append(tok)
            self._maybe_finish(rs, tok)
        return len(live)

    def run_until_drained(self, max_ticks: int = 10_000,
                          on_limit: str = "raise") -> List[RequestState]:
        """Tick until every submitted request finishes or ``max_ticks``
        ticks (counted from this call) elapse; hitting the limit with work
        pending raises :class:`DrainStall` (``on_limit="raise"``) or warns
        and sets :attr:`stalled` (``"warn"``)."""
        if on_limit not in ("raise", "warn"):
            raise ValueError(f"on_limit must be 'raise' or 'warn', "
                             f"got {on_limit!r}")
        self.stalled = False
        start = self.ticks
        while self.queue or self._prefilling is not None or \
                any(s is not None for s in self._slots):
            if self.ticks - start >= max_ticks:
                pending = (len(self.queue) + sum(
                    s is not None for s in self._slots)
                    + (self._prefilling is not None))
                msg = (f"batcher not drained after {max_ticks} ticks: "
                       f"{len(self.completed)} completed, {pending} pending")
                if on_limit == "raise":
                    raise DrainStall(msg, completed=len(self.completed),
                                     pending=pending)
                warnings.warn(msg, RuntimeWarning, stacklevel=2)
                self.stalled = True
                break
            if self.tick() == 0 and not self.queue and \
                    self._prefilling is None:
                break
        return self.completed

    # -- stats ----------------------------------------------------------------

    @property
    def mean_occupancy(self) -> float:
        return self._occupancy_sum / max(self.ticks, 1)
