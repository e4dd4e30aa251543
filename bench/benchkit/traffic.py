"""One generator for every traffic mix: a mix file of parameters in, a
schedule of requests out.

Every seed gets the same work.  Lengths are the quantiles ``(i + 1/2) /
n`` of the mix's distribution, paired by a fixed scramble; an open loop's
gaps between arrivals are the quantiles of an exponential distribution,
scaled so that the last request falls just inside the window.  In a
closed loop the seed deals each round's lengths to the clients (who are
alike, so the work is the same); in an open loop the order of the gaps
and of the requests is drawn once from the mix's ``schedule_seed``,
because the tail of a queue near its capacity depends on which requests
arrive together: with that order drawn from the run's seed, the 90th
percentile of the time to first token spread by a fifth from seed to
seed over a window of 100 requests.  The run's seed draws the prompts'
token ids.

Both loops open their window in steady state.  A closed loop's clients
each start with a request that is part of the way through: its output
length is a quantile of the residual life that a server in steady state
would find left in a resident (a length-biased output length, then a
uniform share of it), so completions, and the admissions they set off,
are spread evenly from the first tick of the window on.  An open loop's
arrivals start ``warm_s`` seconds before the window; the requests due
then are served but not counted.

Mix keys:

- ``loop``: ``closed`` (``clients`` clients, each sending its next
  request when its last one finishes) or ``open`` (arrivals at
  ``rate_per_s`` on the window's clock, whether or not earlier requests
  have finished);
- ``num_slots``: the batcher's decode rows;
- ``prompt_len`` and ``output_len``: ``{"dist": "uniform" |
  "log_uniform", "lo": int, "hi": int}``, bounds inclusive;
- ``rounds`` (closed loop): requests queued a client after its first,
  part-way one; each round the same set of lengths dealt to the clients
  in another order;
- ``arrive_by`` (open loop): the share of the arrivals' span (``warm_s``
  and the window) by which the last request is due;
- ``schedule_seed`` (open loop): the seed of the arrivals' order;
- ``warm_s`` (open loop): seconds of arrivals before the window opens;
- ``check_requests``: how many finished requests the check samples.

Requests decode greedily and never stop early (no end-of-sequence token).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Planned:
    """One request of the schedule."""
    uid: int
    prompt: np.ndarray            # int32 token ids
    max_new_tokens: int
    due_s: Optional[float] = None  # open loop: seconds after the window
    #                                 opens (before it, below 0)


def _quantiles(dist: Dict, n: int) -> np.ndarray:
    q = (np.arange(n) + 0.5) / n
    lo, hi = float(dist["lo"]), float(dist["hi"])
    if dist["dist"] == "uniform":
        x = lo + q * (hi - lo + 1.0) - 0.5
    elif dist["dist"] == "log_uniform":
        x = np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo)))
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def _pairs(mix: Dict, n: int):
    """``n`` (prompt, output) length pairs: both sets of quantiles, the
    outputs in a fixed scrambled order, so long prompts meet short and
    long outputs alike whatever the seed."""
    prompts = _quantiles(mix["prompt_len"], n)
    outputs = _quantiles(mix["output_len"], n)[
        np.random.default_rng(0).permutation(n)]
    return list(zip(prompts.tolist(), outputs.tolist()))


def _tokens(rng: np.random.Generator, vocab: int, n: int) -> np.ndarray:
    return rng.integers(0, vocab, size=n, dtype=np.int64).astype(np.int32)


def _residuals(dist: Dict, n: int) -> np.ndarray:
    """``n`` quantiles of the output left to serve in a resident found at
    a random moment of a steady closed loop: a length drawn in proportion
    to itself (a long request is resident longer), then uniform in
    ``1..length``."""
    left = np.concatenate([np.arange(1, k + 1)
                           for k in _quantiles(dist, n)])
    left.sort()
    return left[((np.arange(n) + 0.5) / n * left.size).astype(np.int64)]


def closed_loop(mix: Dict, seed: int, vocab: int) -> List[List[Planned]]:
    """Each client's queue of requests, in the order it sends them: a
    request part of the way through its output (``_residuals``), then
    ``rounds`` whole ones."""
    clients, rounds = int(mix["clients"]), int(mix["rounds"])
    rng = np.random.default_rng(seed)
    prompts = _quantiles(mix["prompt_len"], clients)
    left = _residuals(mix["output_len"], clients)[
        np.random.default_rng(1).permutation(clients)]
    pairs = _pairs(mix, clients)
    queues: List[List[Planned]] = [[] for _ in range(clients)]
    for client, k in enumerate(rng.permutation(clients)):
        queues[client].append(Planned(client, _tokens(rng, vocab,
                                                      prompts[k]),
                                      int(left[k])))
    uid = clients
    for _ in range(rounds):
        for client, k in enumerate(rng.permutation(clients)):
            p, o = pairs[k]
            queues[client].append(Planned(uid, _tokens(rng, vocab, p), o))
            uid += 1
    return queues


def open_loop(mix: Dict, seed: int, vocab: int,
              seconds: float) -> List[Planned]:
    """Every request due from ``warm_s`` before the window to its close,
    by due time (seconds from the window's open)."""
    warm = float(mix.get("warm_s", 0.0))
    span = seconds + warm
    n = max(int(round(float(mix["rate_per_s"]) * span)), 1)
    rng = np.random.default_rng(seed)
    order_rng = np.random.default_rng(int(mix["schedule_seed"]))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q)
    gaps *= float(mix["arrive_by"]) * span / gaps.sum()
    due = np.cumsum(gaps[order_rng.permutation(n)]) - warm
    pairs = _pairs(mix, n)
    order = order_rng.permutation(n)
    return [Planned(i, _tokens(rng, vocab, pairs[k][0]), pairs[k][1],
                    due_s=float(due[i]))
            for i, k in enumerate(order)]


def longest(mix: Dict) -> int:
    """The most cache rows one request of the mix can take: its longest
    prompt and longest output."""
    return int(mix["prompt_len"]["hi"]) + int(mix["output_len"]["hi"])


def warmup_lengths(mix: Dict) -> List[int]:
    """The prompt lengths set-up prefills once: the shortest, the middle
    and the longest of the mix."""
    lo, hi = int(mix["prompt_len"]["lo"]), int(mix["prompt_len"]["hi"])
    if mix["prompt_len"]["dist"] == "log_uniform":
        mid = int(round(math.sqrt(lo * hi)))
    else:
        mid = (lo + hi) // 2
    return sorted({lo, mid, hi})
