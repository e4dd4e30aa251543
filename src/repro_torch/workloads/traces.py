"""Seeded request-trace generators: the serving workload as data.

CAMEO's headline environment change is workload fluctuation — the paper
re-optimizes when the request mix shifts.  This module makes that axis a
first-class, reproducible object: a :class:`Trace` is a finite sequence of
:class:`RequestSpec` (arrival time, prompt length, output length) and a
:class:`Workload` is a seeded generator of traces.  Everything is
deterministic — the same spec string and seed always produce the identical
trace — so source→target workload swaps are benchmarkable on CPU CI exactly
like the ``shifted:<kind>`` measurement backends.

Registry: generator kinds register with :func:`register_workload` and are
selectable by spec string through :func:`make_workload`, mirroring
``repro_torch.envs.measure.make_backend``:

    make_workload("poisson")
    make_workload("bursty:rate=2000,burst=6,horizon=0.05")
    make_workload("replay:path=trace.jsonl")

Arrival times are in seconds from trace start; the serving simulator prices
ticks in modeled microseconds, so a trace's ``rate`` is requests per second
of modeled time.  Unknown kinds or parameters raise ``ValueError`` with the
valid names — a workload spec that cannot land on a real generator is a bug
in the caller, not noise to ignore.
"""

from __future__ import annotations

import inspect
import json
import zlib
from dataclasses import dataclass
from typing import (Any, Callable, Dict, List, Protocol, Tuple,
                    runtime_checkable)

import numpy as np

WORKLOAD_SPEC_SEP = ":"


@dataclass(frozen=True)
class RequestSpec:
    """One request of a trace: when it arrives and how big it is."""

    uid: int
    arrival_s: float
    prompt_len: int
    output_len: int

    def to_json(self) -> Dict[str, Any]:
        return {"uid": self.uid, "arrival_s": self.arrival_s,
                "prompt_len": self.prompt_len, "output_len": self.output_len}


@dataclass(frozen=True)
class Trace:
    """A finite, ordered request arrival process (one workload realization)."""

    kind: str
    spec: str
    seed: int
    requests: Tuple[RequestSpec, ...]

    def __post_init__(self):
        times = [r.arrival_s for r in self.requests]
        if any(b < a for a, b in zip(times, times[1:])):
            raise ValueError("trace arrivals must be sorted by arrival_s")
        for r in self.requests:
            if r.arrival_s < 0 or r.prompt_len < 1 or r.output_len < 1:
                raise ValueError(f"malformed request {r}")

    def __len__(self) -> int:
        return len(self.requests)

    @property
    def span_s(self) -> float:
        """First-to-last arrival span (0 for <= 1 request)."""
        if len(self.requests) < 2:
            return 0.0
        return self.requests[-1].arrival_s - self.requests[0].arrival_s

    @property
    def total_output_tokens(self) -> int:
        return sum(r.output_len for r in self.requests)

    @property
    def max_context(self) -> int:
        """Longest prompt + output any single request needs resident."""
        return max((r.prompt_len + r.output_len for r in self.requests),
                   default=0)

    def mean_rate(self) -> float:
        """Empirical arrival rate (requests per second of span)."""
        if self.span_s <= 0:
            return 0.0
        return (len(self.requests) - 1) / self.span_s

    def save(self, path: str) -> None:
        """One JSON object per line — the format ``replay:path=`` reads."""
        with open(path, "w") as f:
            for r in self.requests:
                f.write(json.dumps(r.to_json()) + "\n")


@runtime_checkable
class Workload(Protocol):
    """A seeded trace generator: same (spec, seed) -> identical trace."""

    kind: str
    spec: str

    def generate(self, seed: int = 0) -> Trace: ...


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

#: kind -> generator function ``fn(rng, **params) -> List[RequestSpec]``
WORKLOAD_KINDS: Dict[str, Callable[..., List[RequestSpec]]] = {}


def register_workload(kind: str):
    """Decorator registering a trace generator under ``kind``.  The
    function's keyword-only parameters (with defaults) define the spec
    surface: ``make_workload("kind:param=value")`` validates against them."""
    def deco(fn: Callable[..., List[RequestSpec]]):
        if kind in WORKLOAD_KINDS:
            raise ValueError(f"workload kind {kind!r} already registered")
        WORKLOAD_KINDS[kind] = fn
        return fn
    return deco


def workload_kinds() -> Tuple[str, ...]:
    return tuple(sorted(WORKLOAD_KINDS))


def _generator_params(fn: Callable) -> Dict[str, Any]:
    return {n: p.default for n, p in inspect.signature(fn).parameters.items()
            if p.kind == inspect.Parameter.KEYWORD_ONLY}


@dataclass(frozen=True)
class TraceWorkload:
    """A registered generator bound to concrete parameters."""

    kind: str
    params: Tuple[Tuple[str, Any], ...]

    @property
    def spec(self) -> str:
        """Canonical spec string (sorted params) — round-trips through
        :func:`make_workload`."""
        if not self.params:
            return self.kind
        body = ",".join(f"{k}={v}" for k, v in self.params)
        return f"{self.kind}{WORKLOAD_SPEC_SEP}{body}"

    def generate(self, seed: int = 0) -> Trace:
        # seed the stream with (seed, crc32(spec)) so distinct specs with the
        # same seed draw different arrivals, reproducibly across processes
        # (unlike hash(), crc32 is unsalted)
        rng = np.random.default_rng(
            [int(seed), zlib.crc32(self.spec.encode())])
        requests = WORKLOAD_KINDS[self.kind](rng, **dict(self.params))
        requests.sort(key=lambda r: (r.arrival_s, r.uid))
        requests = [RequestSpec(uid=i, arrival_s=r.arrival_s,
                                prompt_len=r.prompt_len,
                                output_len=r.output_len)
                    for i, r in enumerate(requests)]
        return Trace(kind=self.kind, spec=self.spec, seed=int(seed),
                     requests=tuple(requests))


def _parse_value(text: str) -> Any:
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            continue
    return text


def make_workload(spec: str) -> TraceWorkload:
    """Spec string -> bound workload.  ``kind`` or ``kind:k=v,k=v``; unknown
    kinds/parameters raise with the valid names."""
    kind, _, body = spec.partition(WORKLOAD_SPEC_SEP)
    kind = kind.strip()
    if kind not in WORKLOAD_KINDS:
        raise ValueError(
            f"unknown workload kind {kind!r}; known: {sorted(WORKLOAD_KINDS)}")
    fn = WORKLOAD_KINDS[kind]
    valid = _generator_params(fn)
    params = dict(valid)
    for item in filter(None, (s.strip() for s in body.split(","))):
        key, sep, val = item.partition("=")
        key = key.strip()
        if not sep:
            raise ValueError(
                f"workload spec item {item!r} is not 'param=value'")
        if key not in valid:
            raise ValueError(
                f"workload kind {kind!r} has no parameter {key!r}; "
                f"valid: {sorted(valid)}")
        params[key] = _parse_value(val.strip())
    return TraceWorkload(kind=kind, params=tuple(sorted(params.items())))


# --------------------------------------------------------------------------
# length mixtures
# --------------------------------------------------------------------------

def _thin_lengths(rng: np.random.Generator, n: int, mean: float,
                  cap: int) -> np.ndarray:
    """Thin-tailed (Poisson-around-mean) lengths, >= 1, <= cap."""
    return np.clip(1 + rng.poisson(max(mean - 1.0, 0.0), n), 1, cap)


def _heavy_lengths(rng: np.random.Generator, n: int, mean: float, cap: int,
                   alpha: float) -> np.ndarray:
    """Pareto(alpha) lengths scaled to the requested mean, >= 1, <= cap."""
    draw = mean * max(alpha - 1.0, 0.1) * rng.pareto(alpha, n)
    return np.clip(draw.astype(np.int64) + 1, 1, cap)


def _requests(arrivals: np.ndarray, prompts: np.ndarray,
              outputs: np.ndarray) -> List[RequestSpec]:
    return [RequestSpec(uid=i, arrival_s=float(t), prompt_len=int(p),
                        output_len=int(o))
            for i, (t, p, o) in enumerate(zip(arrivals, prompts, outputs))]


def _poisson_arrivals(rng: np.random.Generator, rate: float,
                      horizon: float) -> np.ndarray:
    if rate <= 0 or horizon <= 0:
        raise ValueError(f"rate and horizon must be > 0, got "
                         f"rate={rate} horizon={horizon}")
    # draw in blocks until the horizon is covered: exact homogeneous process
    gaps: List[np.ndarray] = []
    total = 0.0
    while total < horizon:
        g = rng.exponential(1.0 / rate, max(int(rate * horizon) + 1, 16))
        gaps.append(g)
        total += float(g.sum())
    t = np.cumsum(np.concatenate(gaps))
    return t[t < horizon]


# --------------------------------------------------------------------------
# registered kinds
# --------------------------------------------------------------------------

@register_workload("poisson")
def poisson_trace(rng: np.random.Generator, *, rate: float = 1500.0,
                  horizon: float = 0.05, mean_prompt: float = 96.0,
                  mean_output: float = 48.0, max_len: int = 384
                  ) -> List[RequestSpec]:
    """Memoryless arrivals at ``rate`` req/s with thin-tailed lengths — the
    well-behaved staging workload (the transfer source by default)."""
    t = _poisson_arrivals(rng, rate, horizon)
    return _requests(t, _thin_lengths(rng, len(t), mean_prompt, max_len),
                     _thin_lengths(rng, len(t), mean_output, max_len))


@register_workload("bursty")
def bursty_trace(rng: np.random.Generator, *, rate: float = 1500.0,
                 burst: float = 5.0, dwell: float = 0.008,
                 burst_frac: float = 0.3, horizon: float = 0.05,
                 mean_prompt: float = 96.0, mean_output: float = 48.0,
                 max_len: int = 384) -> List[RequestSpec]:
    """Markov-modulated Poisson: a calm state at ``rate`` and a burst state
    at ``rate * burst``, with exponential dwell times (mean ``dwell`` s,
    stationary burst fraction ``burst_frac``).  Queue depth spikes the
    Poisson source never shows — the canonical serving workload shift."""
    if not 0.0 < burst_frac < 1.0:
        raise ValueError(f"burst_frac must be in (0, 1), got {burst_frac}")
    times: List[float] = []
    t, hot = 0.0, False
    while t < horizon:
        mean_dwell = dwell * (burst_frac if hot else (1.0 - burst_frac)) * 2
        seg = min(float(rng.exponential(mean_dwell)), horizon - t)
        seg_rate = rate * (burst if hot else 1.0)
        if seg > 0:
            times.extend(t + _poisson_arrivals(rng, seg_rate, seg))
        t += seg
        hot = not hot
    arr = np.sort(np.asarray(times))
    return _requests(arr, _thin_lengths(rng, len(arr), mean_prompt, max_len),
                     _thin_lengths(rng, len(arr), mean_output, max_len))


@register_workload("diurnal")
def diurnal_trace(rng: np.random.Generator, *, rate: float = 1500.0,
                  amplitude: float = 0.8, period: float = 0.02,
                  horizon: float = 0.05, mean_prompt: float = 96.0,
                  mean_output: float = 48.0, max_len: int = 384
                  ) -> List[RequestSpec]:
    """Inhomogeneous Poisson with a sinusoidal rate profile
    ``rate * (1 + amplitude * sin(2 pi t / period))`` (thinning method) —
    the day/night traffic cycle compressed to the simulator's time scale."""
    if not 0.0 <= amplitude <= 1.0:
        raise ValueError(f"amplitude must be in [0, 1], got {amplitude}")
    peak = rate * (1.0 + amplitude)
    cand = _poisson_arrivals(rng, peak, horizon)
    keep = rng.random(len(cand)) * peak <= rate * (
        1.0 + amplitude * np.sin(2.0 * np.pi * cand / period))
    t = cand[keep]
    return _requests(t, _thin_lengths(rng, len(t), mean_prompt, max_len),
                     _thin_lengths(rng, len(t), mean_output, max_len))


@register_workload("heavy_tail")
def heavy_tail_trace(rng: np.random.Generator, *, rate: float = 1500.0,
                     horizon: float = 0.05, mean_prompt: float = 96.0,
                     mean_output: float = 48.0, alpha: float = 1.6,
                     heavy_frac: float = 0.25, max_len: int = 1280
                     ) -> List[RequestSpec]:
    """Poisson arrivals with a Pareto(``alpha``) length mixture: fraction
    ``heavy_frac`` of prompts/outputs draw from the heavy tail (up to
    ``max_len``), the rest stay thin.  Long-context stragglers dominate the
    p99 and can push small-cache serving configurations infeasible."""
    if not 0.0 <= heavy_frac <= 1.0:
        raise ValueError(f"heavy_frac must be in [0, 1], got {heavy_frac}")
    t = _poisson_arrivals(rng, rate, horizon)
    n = len(t)

    def mix(mean: float) -> np.ndarray:
        thin = _thin_lengths(rng, n, mean, max_len)
        heavy = _heavy_lengths(rng, n, mean * 2.0, max_len, alpha)
        return np.where(rng.random(n) < heavy_frac, heavy, thin)

    return _requests(t, mix(mean_prompt), mix(mean_output))


@register_workload("replay")
def replay_trace(rng: np.random.Generator, *, path: str = ""
                 ) -> List[RequestSpec]:
    """Replay a recorded JSONL trace (the format :meth:`Trace.save` writes).
    Deterministic by construction — the seed is ignored."""
    if not path:
        raise ValueError("replay workload needs path=<trace.jsonl>")
    out: List[RequestSpec] = []
    with open(path) as f:
        for i, line in enumerate(filter(str.strip, f)):
            rec = json.loads(line)
            out.append(RequestSpec(
                uid=int(rec.get("uid", i)),
                arrival_s=float(rec["arrival_s"]),
                prompt_len=int(rec["prompt_len"]),
                output_len=int(rec["output_len"])))
    if not out:
        raise ValueError(f"replay trace {path!r} is empty")
    return out
