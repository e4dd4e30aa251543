"""Summarize an exported trace file: ``python -m repro_torch.obs.report trace.json``.

Prints, for a Chrome trace-event JSON written by :mod:`repro_torch.obs.trace`:

- **top spans** — per span name: count, total / mean / max duration;
- **request lifecycle breakdown** — queue vs. prefill vs. decode time and
  per-request end-to-end latency from the async ``b``/``e`` request events;
- **SLO burn** — fraction of requests whose end-to-end latency exceeds
  ``--slo-ms`` (when request events are present);
- **tuner rounds** — per-round ask/tell events from the tuner track.

The same module exposes :func:`validate_trace_doc` — the schema check CI
and tier-1 tests run against every exported file.  Carried over from
:mod:`repro.obs.report` (pure Python).
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

# phases we emit (a subset of the Chrome trace-event vocabulary)
_KNOWN_PHASES = {"X", "i", "I", "C", "b", "e", "n", "B", "E", "M", "s", "t", "f"}
_LIFECYCLE_SPANS = ("queue", "prefill", "prefill_chunk", "decode_tick")


def validate_trace_doc(doc: Any) -> List[Dict[str, Any]]:
    """Validate a parsed trace document against the Chrome trace-event
    schema (JSON Object Format); return the event list.

    Raises ``ValueError`` on the first violation — used by tier-1 tests
    and by the report CLI before summarizing, so a malformed export fails
    loudly rather than rendering an empty report.
    """
    if isinstance(doc, list):          # JSON Array Format is also legal
        events = doc
    elif isinstance(doc, dict):
        if "traceEvents" not in doc:
            raise ValueError("trace document has no 'traceEvents' key")
        events = doc["traceEvents"]
    else:
        raise ValueError(f"trace document must be an object or array, "
                         f"got {type(doc).__name__}")
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object: {ev!r}")
        ph = ev.get("ph")
        if ph not in _KNOWN_PHASES:
            raise ValueError(f"event {i} has invalid phase {ph!r}")
        if ph != "M":
            if "ts" not in ev:
                raise ValueError(f"event {i} ({ev.get('name')!r}) missing 'ts'")
            if not isinstance(ev["ts"], (int, float)):
                raise ValueError(f"event {i} has non-numeric ts: {ev['ts']!r}")
        if not isinstance(ev.get("name", ""), str):
            raise ValueError(f"event {i} has non-string name")
        if "pid" in ev and not isinstance(ev["pid"], int):
            raise ValueError(f"event {i} has non-integer pid: {ev['pid']!r}")
        if ph == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                raise ValueError(
                    f"event {i} ({ev.get('name')!r}) 'X' span needs dur >= 0")
        if ph in ("b", "e", "n") and "id" not in ev:
            raise ValueError(f"event {i} async phase {ph!r} missing 'id'")
        if "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(f"event {i} has non-object args")
    return events


def load_trace(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        doc = json.load(f)
    return validate_trace_doc(doc)


# -- aggregation ------------------------------------------------------------

def span_stats(events: Iterable[Mapping[str, Any]]) -> Dict[str, Dict[str, float]]:
    """Per-name duration stats over all complete ('X') spans."""
    stats: Dict[str, Dict[str, float]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        s = stats.setdefault(ev.get("name", "?"),
                             {"count": 0, "total_us": 0.0, "max_us": 0.0})
        d = float(ev.get("dur", 0.0))
        s["count"] += 1
        s["total_us"] += d
        s["max_us"] = max(s["max_us"], d)
    for s in stats.values():
        s["mean_us"] = s["total_us"] / s["count"] if s["count"] else 0.0
    return stats


def request_latencies(events: Iterable[Mapping[str, Any]]) -> Dict[str, float]:
    """End-to-end latency (us) per request id from async b/e pairs."""
    begin: Dict[Tuple[str, str], float] = {}
    out: Dict[str, float] = {}
    for ev in events:
        ph = ev.get("ph")
        if ph == "b":
            begin[(ev.get("name", ""), str(ev.get("id")))] = float(ev["ts"])
        elif ph == "e":
            key = (ev.get("name", ""), str(ev.get("id")))
            t0 = begin.pop(key, None)
            if t0 is not None:
                out[key[1]] = float(ev["ts"]) - t0
    return out


def lifecycle_breakdown(events: Iterable[Mapping[str, Any]]) -> Dict[str, float]:
    """Total time (us) in each request-lifecycle stage across the trace."""
    stats = span_stats(events)
    return {name: stats[name]["total_us"]
            for name in _LIFECYCLE_SPANS if name in stats}


def slo_burn(latencies: Mapping[str, float], slo_ms: float) -> Dict[str, float]:
    n = len(latencies)
    viol = sum(1 for v in latencies.values() if v > slo_ms * 1e3)
    return {"requests": float(n), "slo_ms": slo_ms,
            "violations": float(viol),
            "burn_rate": viol / n if n else 0.0}


def tuner_round_summary(events: Iterable[Mapping[str, Any]]) -> List[Dict[str, Any]]:
    return [{"name": ev.get("name"), "ts": ev.get("ts"),
             "args": ev.get("args", {})}
            for ev in events if ev.get("cat") == "tuner"]


def summarize(events: List[Dict[str, Any]], slo_ms: float = 50.0,
              top: int = 12) -> Dict[str, Any]:
    """The full report as a JSON-able dict (the CLI pretty-prints this)."""
    stats = span_stats(events)
    lats = request_latencies(events)
    return {
        "num_events": len(events),
        "top_spans": sorted(
            ({"name": k, **v} for k, v in stats.items()),
            key=lambda s: -s["total_us"])[:top],
        "lifecycle_us": lifecycle_breakdown(events),
        "slo": slo_burn(lats, slo_ms),
        "tuner_rounds": tuner_round_summary(events),
    }


# -- CLI --------------------------------------------------------------------

def _fmt_us(us: float) -> str:
    if us >= 1e6:
        return f"{us / 1e6:8.3f}s "
    if us >= 1e3:
        return f"{us / 1e3:8.3f}ms"
    return f"{us:8.1f}us"


def render(report: Mapping[str, Any], out=sys.stdout) -> None:
    w = out.write
    w(f"trace: {report['num_events']} events\n\n")

    w("top spans (by total duration)\n")
    w(f"  {'name':<28}{'count':>7}{'total':>11}{'mean':>11}{'max':>11}\n")
    for s in report["top_spans"]:
        w(f"  {s['name']:<28}{s['count']:>7.0f}{_fmt_us(s['total_us']):>11}"
          f"{_fmt_us(s['mean_us']):>11}{_fmt_us(s['max_us']):>11}\n")

    life = report["lifecycle_us"]
    if life:
        total = sum(life.values()) or 1.0
        w("\nrequest lifecycle breakdown\n")
        for name, us in life.items():
            w(f"  {name:<16}{_fmt_us(us):>11}  {100.0 * us / total:5.1f}%\n")

    slo = report["slo"]
    if slo["requests"]:
        w(f"\nSLO burn @ {slo['slo_ms']:g} ms: "
          f"{slo['violations']:.0f}/{slo['requests']:.0f} requests over "
          f"({100.0 * slo['burn_rate']:.1f}%)\n")

    rounds = report["tuner_rounds"]
    if rounds:
        w(f"\ntuner rounds ({len(rounds)} events)\n")
        for ev in rounds:
            args = ev.get("args", {})
            keys = ("tuner", "round", "k", "told", "best_y", "eps",
                    "graph_refreshed", "n_reduced")
            brief = ", ".join(f"{k}={args[k]}" for k in keys if k in args)
            w(f"  {ev['name']:<16}{brief}\n")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize a Chrome trace-event JSON exported by repro_torch.obs")
    ap.add_argument("trace", help="path to the trace JSON file")
    ap.add_argument("--slo-ms", type=float, default=50.0,
                    help="per-request latency SLO for the burn-rate section")
    ap.add_argument("--top", type=int, default=12,
                    help="how many span names to list")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON instead of text")
    args = ap.parse_args(argv)

    try:
        events = load_trace(args.trace)
    except (OSError, json.JSONDecodeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    report = summarize(events, slo_ms=args.slo_ms, top=args.top)
    if args.json:
        json.dump(report, sys.stdout, indent=2)
        sys.stdout.write("\n")
    else:
        render(report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
