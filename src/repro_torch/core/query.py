"""User-query translation (the paper's query engine).

Accepts requests like
    "How to improve latency within 1 hour or 50 samples"
    "find the configuration with minimum energy for which latency is less
     than 20 seconds within 45 minutes"
and extracts (objective, budget, constraints) with fixed guided keyword
directives, exactly as described in Sec. 3.3.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_OBJECTIVES = ("latency", "energy", "throughput", "step_time", "cost")
_MAXIMIZE = {"throughput"}

_TIME_UNITS = {
    "second": 1.0, "seconds": 1.0, "sec": 1.0, "s": 1.0,
    "minute": 60.0, "minutes": 60.0, "min": 60.0,
    "hour": 3600.0, "hours": 3600.0, "hr": 3600.0, "h": 3600.0,
}


@dataclass
class Query:
    objective: str
    maximize: bool = False
    budget_samples: Optional[int] = None
    budget_seconds: Optional[float] = None
    constraints: List[Tuple[str, str, float]] = field(default_factory=list)
    # (metric, op in {"<", ">"}, value)

    def satisfies(self, metrics: Dict[str, float]) -> bool:
        for metric, op, val in self.constraints:
            got = metrics.get(metric)
            if got is None:
                return False
            if op == "<" and not got < val:
                return False
            if op == ">" and not got > val:
                return False
        return True


def parse_query(text: str) -> Query:
    t = text.lower()

    # objective: first objective keyword not inside a constraint clause
    constraint_spans = []
    constraints: List[Tuple[str, str, float]] = []
    for m in re.finditer(
            r"(\w+)\s+(?:is\s+)?(less|greater|lower|higher|below|above)"
            r"(?:\s+than)?\s+([0-9.]+)", t):
        metric, rel, val = m.group(1), m.group(2), float(m.group(3))
        if metric in _OBJECTIVES:
            op = "<" if rel in ("less", "lower", "below") else ">"
            constraints.append((metric, op, val))
            constraint_spans.append(m.span())

    objective = None
    for m in re.finditer("|".join(_OBJECTIVES), t):
        if any(a <= m.start() < b for a, b in constraint_spans):
            continue
        objective = m.group(0)
        break
    if objective is None:
        raise ValueError(f"no objective keyword found in query: {text!r}")

    q = Query(objective=objective, maximize=objective in _MAXIMIZE,
              constraints=constraints)

    # budget clauses must not match inside constraint clauses ("less than
    # 20 seconds" is a latency bound, not a time budget)
    budget_text = list(t)
    for a, b in constraint_spans:
        b = min(len(t), b + 16)  # swallow the trailing unit too
        for i in range(a, b):
            budget_text[i] = " "
    budget_text = "".join(budget_text)

    m = re.search(r"(\d+)\s*(?:samples|configurations|configs|evaluations|iterations)",
                  budget_text)
    if m:
        q.budget_samples = int(m.group(1))
    for m in re.finditer(r"([0-9.]+)\s*(hours?|hrs?|h\b|minutes?|min\b|seconds?|secs?|s\b)",
                         budget_text):
        unit = m.group(2).strip()
        for k, mult in _TIME_UNITS.items():
            if unit.startswith(k[:3]):
                q.budget_seconds = float(m.group(1)) * mult
                break
        break
    return q
