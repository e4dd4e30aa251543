"""Configuration spaces: named options with mixed-type domains.

The space is the paper's ``O = Dom(O_1) x ... x Dom(O_d)``.  Options carry
explicit finite domains (systems knobs are recommended-value lists — Tables
7–12 of the paper); encoding maps a configuration to a float vector for the
GP/CI machinery (categoricals -> domain index, numerics -> value) with
per-dimension normalization to [0, 1].
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Option:
    name: str
    values: Tuple[Any, ...]          # finite ordered domain
    default: Any = None
    kind: str = "numeric"            # numeric | categorical | boolean

    def __post_init__(self):
        if self.default is None:
            object.__setattr__(self, "default", self.values[0])

    @property
    def cardinality(self) -> int:
        return len(self.values)

    def index_of(self, v: Any) -> int:
        """Index of v, snapping to the nearest valid value when v comes from
        a different environment's domain (cross-space transfer)."""
        if v in self.values:
            return self.values.index(v)
        if self.kind == "numeric":
            try:
                fv = float(v)
                return min(range(len(self.values)),
                           key=lambda i: abs(float(self.values[i]) - fv))
            except (TypeError, ValueError):
                pass
        return self.values.index(self.default)


class ConfigSpace:
    def __init__(self, options: Sequence[Option]):
        self.options = list(options)
        self.by_name = {o.name: o for o in self.options}
        if len(self.by_name) != len(self.options):
            raise ValueError("duplicate option names")

    @property
    def names(self) -> List[str]:
        return [o.name for o in self.options]

    @property
    def dim(self) -> int:
        return len(self.options)

    def size(self) -> int:
        n = 1
        for o in self.options:
            n *= o.cardinality
        return n

    def default_config(self) -> Dict[str, Any]:
        return {o.name: o.default for o in self.options}

    # -- encoding ------------------------------------------------------------

    def encode(self, config: Dict[str, Any]) -> np.ndarray:
        """Config -> normalized float vector in [0, 1]^d."""
        x = np.empty(self.dim, np.float64)
        for i, o in enumerate(self.options):
            v = config.get(o.name, o.default)
            if o.kind == "numeric":
                lo = float(min(o.values))
                hi = float(max(o.values))
                x[i] = 0.5 if hi == lo else (float(v) - lo) / (hi - lo)
            else:
                x[i] = o.index_of(v) / max(o.cardinality - 1, 1)
        return x

    def decode(self, x: np.ndarray) -> Dict[str, Any]:
        """Nearest valid configuration for a [0,1]^d vector."""
        cfg = {}
        for i, o in enumerate(self.options):
            if o.kind == "numeric":
                lo = float(min(o.values))
                hi = float(max(o.values))
                target = lo + float(np.clip(x[i], 0, 1)) * (hi - lo)
                cfg[o.name] = min(o.values, key=lambda v: abs(float(v) - target))
            else:
                idx = int(round(float(np.clip(x[i], 0, 1)) * (o.cardinality - 1)))
                cfg[o.name] = o.values[idx]
        return cfg

    # -- sampling / enumeration ----------------------------------------------

    def sample(self, rng: np.random.Generator, n: int = 1) -> List[Dict[str, Any]]:
        out = []
        for _ in range(n):
            out.append({o.name: o.values[int(rng.integers(o.cardinality))]
                        for o in self.options})
        return out

    def neighbors(self, config: Dict[str, Any], rng: np.random.Generator,
                  n: int = 8) -> List[Dict[str, Any]]:
        """Local moves: change one option to an adjacent / random value."""
        out = []
        for _ in range(n):
            o = self.options[int(rng.integers(self.dim))]
            c = dict(config)
            cur = o.index_of(c.get(o.name, o.default))
            if o.kind == "numeric" and o.cardinality > 2 and rng.random() < 0.7:
                step = int(rng.integers(1, 3)) * (1 if rng.random() < 0.5 else -1)
                idx = int(np.clip(cur + step, 0, o.cardinality - 1))
            else:
                idx = int(rng.integers(o.cardinality))
            c[o.name] = o.values[idx]
            out.append(c)
        return out

    def subspace(self, names: Iterable[str]) -> "ConfigSpace":
        keep = [self.by_name[n] for n in names if n in self.by_name]
        return ConfigSpace(keep)

    def grid(self, max_points: int = 4096,
             rng: Optional[np.random.Generator] = None) -> List[Dict[str, Any]]:
        """Full enumeration if small, else a random subset."""
        if self.size() <= max_points:
            configs = [{}]
            for o in self.options:
                configs = [dict(c, **{o.name: v}) for c in configs
                           for v in o.values]
            return configs
        rng = rng or np.random.default_rng(0)
        return self.sample(rng, max_points)
