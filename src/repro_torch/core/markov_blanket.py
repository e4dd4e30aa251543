"""Markov-blanket extraction for multiple targets (IAMB-S style).

The paper transfers the union of the Markov blankets of the top-k
highest-ACE nodes (plus the objective's own blanket) — this is the reduced
variable set the warm CGP operates on, and it is what deletes
source-specific spurious edges (Sec. 2.2, Fig. 4-5).

``top_k_blanket`` takes the graph-derived blankets and verifies each member
with a shrink phase of conditional-independence tests (IAMB's backward
step, the additivity check of Liu & Liu 2018): a member is dropped if it is
independent of the target given the rest of the blanket.
"""

from __future__ import annotations

from typing import List, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.ci_tests import fisher_z
from repro_torch.core.discovery import CausalGraph


def shrink_blanket(data: np.ndarray, names: Sequence[str], target: str,
                   blanket: Set[str], alpha: float = 0.05,
                   max_cond: int = 3) -> Set[str]:
    idx = {n: i for i, n in enumerate(names)}
    if target not in idx:
        return blanket
    members = [m for m in blanket if m in idx]
    keep = set(members)
    for m in list(members):
        rest = [idx[r] for r in keep if r != m][:max_cond]
        _, independent = fisher_z(data, idx[m], idx[target], rest, alpha=alpha)
        if independent:
            keep.discard(m)
    return keep


def top_k_blanket(
    graph: CausalGraph,
    ranked: Sequence[Tuple[str, float]],
    k: int,
    y_name: str,
    data: np.ndarray = None,
    names: Sequence[str] = None,
    shrink: bool = True,
) -> Set[str]:
    """Union of Markov blankets of the top-k nodes and the objective."""
    top = [n for n, _ in ranked[:k]]
    mb: Set[str] = set(top)
    mb |= graph.markov_blanket(y_name)
    for n in top:
        mb |= graph.markov_blanket(n)
    mb.discard(y_name)
    if shrink and data is not None and names is not None:
        mb = shrink_blanket(data, names, y_name, mb) | set(top)
    return mb
