"""The arithmetic of the end-to-end metrics, from token times on the host
clock.

A request's token times are the host clock at which each of its tokens
reached the host: the first when its prefill's token was read
(``RequestState.admitted_at``), each later one when the tick that
produced it returned.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (linear between order statistics)."""
    if len(values) == 0:
        raise ValueError("no samples")
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def tokens_in(times: Iterable[List[float]], t0: float, t1: float) -> int:
    """Output tokens that reached the host inside ``[t0, t1)``."""
    return sum(sum(1 for t in ts if t0 <= t < t1) for ts in times)


def output_tokens_per_s(times: Iterable[List[float]], t0: float,
                        t1: float) -> float:
    """Every output token of the window over the window's length."""
    return tokens_in(times, t0, t1) / (t1 - t0)


def gaps_in(times: Iterable[List[float]], t0: float, t1: float
            ) -> List[float]:
    """Every gap between consecutive tokens of one request whose later
    token reached the host inside ``[t0, t1)``, in seconds."""
    out: List[float] = []
    for ts in times:
        for a, b in zip(ts, ts[1:]):
            if t0 <= b < t1:
                out.append(b - a)
    return out


def ttft_p90_ms(ttft_s: Sequence[float]) -> float:
    """The 90th percentile of the times from each request's due time to
    its first token, over every request due in the window (the highest
    with ten requests beyond it in a window of a hundred)."""
    return 1e3 * percentile(ttft_s, 90.0)


def summary(values: Sequence[float]) -> Dict[str, float]:
    v = np.asarray(values, dtype=np.float64)
    return {"n": int(v.size), "p50": float(np.percentile(v, 50)),
            "max": float(v.max())} if v.size else {"n": 0}
