"""FCI-lite causal structure discovery + entropic edge orientation.

The paper runs FCI (Fisher-z / mutual-information CI tests) to get a PAG and
resolves the remaining partially-directed edges with entropic causal
discovery (LatentSearch, Kocaoglu et al.).  This implementation keeps the
same three stages on the same test machinery, with the full PAG calculus
replaced by the PC skeleton + v-structures + Meek rules ("FCI-lite", see
DESIGN.md §8):

  1. skeleton: start complete, remove edges independent given conditioning
     sets up to ``max_cond`` drawn from current neighborhoods;
  2. orient v-structures (i - k - j with i,j nonadjacent and k not in
     sepset(i,j)) then apply Meek rules R1-R3;
  3. orient whatever is left by the entropic criterion: prefer the direction
     whose residual (effect given cause) has lower entropy; edges whose
     entropy gap is negligible keep a bidirected mark (possible latent
     confounder), which downstream ACE treats conservatively.

Graphs are small (tens of nodes), so adjacency sets + dict edge marks are
plenty.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.ci_tests import _discretize, fisher_z, mutual_info

DIRECTED = "-->"
BIDIRECTED = "<->"
UNDIRECTED = "---"


@dataclass
class CausalGraph:
    nodes: List[str]
    # edges keyed by ordered pair for DIRECTED (a->b); unordered stored both ways
    edges: Dict[Tuple[str, str], str] = field(default_factory=dict)
    sepsets: Dict[FrozenSet[str], Set[str]] = field(default_factory=dict)

    # -- mutation ----------------------------------------------------------

    def add_edge(self, a: str, b: str, kind: str = UNDIRECTED) -> None:
        if kind == DIRECTED:
            self.edges.pop((b, a), None)
            self.edges[(a, b)] = DIRECTED
        else:
            self.edges[(a, b)] = kind
            self.edges[(b, a)] = kind

    def remove_edge(self, a: str, b: str) -> None:
        self.edges.pop((a, b), None)
        self.edges.pop((b, a), None)

    # -- queries -------------------------------------------------------------

    def has_edge(self, a: str, b: str) -> bool:
        return (a, b) in self.edges or (b, a) in self.edges

    def edge_kind(self, a: str, b: str) -> Optional[str]:
        if (a, b) in self.edges:
            return self.edges[(a, b)]
        if (b, a) in self.edges:
            k = self.edges[(b, a)]
            return DIRECTED + "_rev" if k == DIRECTED else k

    def neighbors(self, a: str) -> Set[str]:
        out = set()
        for (x, y) in self.edges:
            if x == a:
                out.add(y)
            elif y == a:
                out.add(x)
        return out

    def parents(self, a: str) -> Set[str]:
        return {x for (x, y), k in self.edges.items()
                if y == a and k == DIRECTED}

    def children(self, a: str) -> Set[str]:
        return {y for (x, y), k in self.edges.items()
                if x == a and k == DIRECTED}

    def undirected_neighbors(self, a: str) -> Set[str]:
        out = set()
        for (x, y), k in self.edges.items():
            if k in (UNDIRECTED, BIDIRECTED):
                if x == a:
                    out.add(y)
        return out

    def markov_blanket(self, a: str) -> Set[str]:
        """Parents, children, children's other parents (+ undirected nbrs)."""
        mb = set(self.parents(a)) | set(self.children(a))
        for c in self.children(a):
            mb |= self.parents(c)
        mb |= self.undirected_neighbors(a)
        mb.discard(a)
        return mb

    def edge_list(self) -> List[Tuple[str, str, str]]:
        seen = set()
        out = []
        for (a, b), k in sorted(self.edges.items()):
            key = frozenset((a, b))
            if k == DIRECTED:
                out.append((a, b, k))
            elif key not in seen:
                out.append((a, b, k))
                seen.add(key)
        return out

    def num_edges(self) -> int:
        return len(self.edge_list())

    def copy(self) -> "CausalGraph":
        g = CausalGraph(list(self.nodes))
        g.edges = dict(self.edges)
        g.sepsets = {k: set(v) for k, v in self.sepsets.items()}
        return g

    # -- comparison (Fig. 3 / Fig. 12 of the paper) ---------------------------

    def shd(self, other: "CausalGraph") -> int:
        """Structural Hamming distance over the shared node set."""
        nodes = [n for n in self.nodes if n in set(other.nodes)]
        d = 0
        for a, b in itertools.combinations(nodes, 2):
            ka = self.edge_kind(a, b)
            kb = other.edge_kind(a, b)
            if (ka is None) != (kb is None):
                d += 1
            elif ka is not None and ka != kb:
                d += 1
        return d


def fci_lite(
    data: np.ndarray,
    names: Sequence[str],
    *,
    alpha: float = 0.05,
    max_cond: int = 2,
    discrete_cols: Optional[Set[int]] = None,
    entropic_orient: bool = True,
    entropy_gap: float = 0.02,
) -> CausalGraph:
    """Discover a causal graph from observational data (rows x variables)."""
    n_vars = data.shape[1]
    assert len(names) == n_vars
    discrete_cols = discrete_cols or set()
    g = CausalGraph(list(names))
    for i, j in itertools.combinations(range(n_vars), 2):
        g.add_edge(names[i], names[j], UNDIRECTED)

    def indep(i, j, cond):
        if i in discrete_cols and j in discrete_cols and len(cond) <= 1:
            _, ind = mutual_info(data, i, j, cond, alpha=alpha)
            return ind
        _, ind = fisher_z(data, i, j, cond, alpha=alpha)
        return ind

    idx = {nm: k for k, nm in enumerate(names)}

    # stage 1: skeleton
    for level in range(max_cond + 1):
        for i, j in itertools.combinations(range(n_vars), 2):
            a, b = names[i], names[j]
            if not g.has_edge(a, b):
                continue
            nbrs = (g.neighbors(a) | g.neighbors(b)) - {a, b}
            nbr_idx = [idx[x] for x in nbrs]
            removed = False
            for cond in itertools.combinations(nbr_idx, level):
                if indep(i, j, list(cond)):
                    g.remove_edge(a, b)
                    g.sepsets[frozenset((a, b))] = {names[c] for c in cond}
                    removed = True
                    break
            if removed:
                continue

    # stage 2: v-structures + Meek rules
    for a, b in itertools.combinations(g.nodes, 2):
        if g.has_edge(a, b):
            continue
        sep = g.sepsets.get(frozenset((a, b)), set())
        for c in g.neighbors(a) & g.neighbors(b):
            if c not in sep and g.edge_kind(a, c) == UNDIRECTED \
                    and g.edge_kind(b, c) == UNDIRECTED:
                g.remove_edge(a, c)
                g.add_edge(a, c, DIRECTED)
                g.remove_edge(b, c)
                g.add_edge(b, c, DIRECTED)
    _meek(g)

    # stage 3: entropic orientation of the residual undirected edges
    if entropic_orient:
        for a, b, k in list(g.edge_list()):
            if k != UNDIRECTED:
                continue
            gap = _entropy_direction(data, idx[a], idx[b])
            g.remove_edge(a, b)
            if abs(gap) < entropy_gap:
                g.add_edge(a, b, BIDIRECTED)  # possible latent confounder
            elif gap < 0:
                g.add_edge(a, b, DIRECTED)
            else:
                g.add_edge(b, a, DIRECTED)
        _meek(g)
    return g


def _meek(g: CausalGraph) -> None:
    """Meek rules R1-R3 to closure."""
    changed = True
    while changed:
        changed = False
        for a, b, k in list(g.edge_list()):
            if k != UNDIRECTED:
                continue
            # R1: c -> a, c not adjacent b  =>  a -> b
            for c in g.parents(a):
                if not g.has_edge(c, b):
                    g.remove_edge(a, b)
                    g.add_edge(a, b, DIRECTED)
                    changed = True
                    break
            if changed:
                continue
            # R2: a -> c -> b  =>  a -> b
            if g.children(a) & g.parents(b):
                g.remove_edge(a, b)
                g.add_edge(a, b, DIRECTED)
                changed = True
                continue
            # R3: a - c -> b and a - d -> b, c,d nonadjacent => a -> b
            cands = [c for c in g.undirected_neighbors(a) if b in g.children(c)]
            if any(not g.has_edge(c, d)
                   for c, d in itertools.combinations(cands, 2)):
                g.remove_edge(a, b)
                g.add_edge(a, b, DIRECTED)
                changed = True


def _entropy_direction(data: np.ndarray, i: int, j: int, bins: int = 6) -> float:
    """Entropic criterion: H(j | i) - H(i | j) on binned data.

    Negative -> i causes j (residual of j given i is simpler), per the
    minimum-entropy exogenous-variable principle of entropic causal
    inference.
    """
    xi = _discretize(data[:, i], bins)
    xj = _discretize(data[:, j], bins)

    def cond_entropy(a, b):  # H(a | b)
        h = 0.0
        n = len(a)
        for bv in np.unique(b):
            m = b == bv
            pa = np.bincount(a[m]) / m.sum()
            pa = pa[pa > 0]
            h += (m.sum() / n) * float(-(pa * np.log(pa)).sum())
        return h

    return cond_entropy(xj, xi) - cond_entropy(xi, xj)
