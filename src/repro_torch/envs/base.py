"""Environment contract for configuration tuning.

An environment is "a combination of hardware, workload, software, and
deployment topology" (the paper's definition).  Tuners interact through:

  observe(rng)      -> (config, counters, y)   draw from the cheap
                       observational pool (staging measurements)
  intervene(config) -> (counters, y)           set the configuration and
                       measure (expensive in production)
  intervene_batch(configs) -> [(counters, y)]  measure a q-batch round;
                       sequential by default, overridden where batching
                       actually pays (vectorized noise, shared jit caches,
                       one warmed deployment per compile key)

``counters`` are the system events C (perf counters in the paper; compiled
HLO statistics in ours).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Protocol, Tuple

import numpy as np

from repro_torch.core.spaces import ConfigSpace


class PerfEnv(Protocol):
    space: ConfigSpace
    counter_names: Tuple[str, ...]

    def observe(self, rng: np.random.Generator
                ) -> Tuple[Dict[str, Any], Dict[str, float], float]: ...

    def intervene(self, config: Dict[str, Any]
                  ) -> Tuple[Dict[str, float], float]: ...

    def intervene_batch(self, configs: List[Dict[str, Any]]
                        ) -> List[Tuple[Dict[str, float], float]]: ...


class PooledEnv:
    """Base env with an observational pool drawn by random configuration.

    Batched-measurement hooks:

    - ``batch_share_dims`` — option names whose joint value determines the
      expensive part of a measurement (e.g. the replay environment's
      ``(cache_len, launch)`` compile key).  ``None`` (the default) means
      measurements share nothing; batched proposal/sampling paths use it to
      group round members onto one deployment.
    - ``memoize_measurements`` — when True, :meth:`dataset` and
      :meth:`observe` reuse an already-measured configuration's result
      instead of re-measuring (the observational pool and the dataset
      become one store).  Off by default: analytic backends draw noise per
      measurement from a seeded stream, and reusing results would shift
      that stream.  Replay-backed envs opt in — their cost is compilation
      and wall-clock, not a noise draw.
    """

    batch_share_dims: Optional[Tuple[str, ...]] = None
    memoize_measurements: bool = False

    def __init__(self, space: ConfigSpace, counter_names=(), seed: int = 0,
                 pool_size: int = 512):
        self.space = space
        self.counter_names = tuple(counter_names)
        self._pool_rng = np.random.default_rng(seed)
        self._pool: List[Tuple[Dict, Dict, float]] = []
        self._pool_size = pool_size
        self._measured: Dict[tuple, Tuple[Dict, Dict, float]] = {}

    def _measure(self, config) -> Tuple[Dict[str, float], float]:
        raise NotImplementedError

    def _config_key(self, config: Dict[str, Any]) -> tuple:
        return tuple(config.get(o.name, o.default) for o in self.space.options)

    def _remember(self, cfg, counters, y) -> None:
        if self.memoize_measurements:
            self._measured[self._config_key(cfg)] = (dict(cfg),
                                                     dict(counters), y)

    def intervene(self, config):
        counters, y = self._measure(config)
        self._remember(config, counters, y)
        return counters, y

    def intervene_batch(self, configs: List[Dict[str, Any]]
                        ) -> List[Tuple[Dict[str, float], float]]:
        """Measure a q-batch; sequential fallback, identical stream to
        per-config :meth:`intervene` calls."""
        return [self.intervene(c) for c in configs]

    def observe(self, rng: np.random.Generator):
        if len(self._pool) < self._pool_size:
            cfg = self.space.sample(self._pool_rng, 1)[0]
            hit = (self._measured.get(self._config_key(cfg))
                   if self.memoize_measurements else None)
            if hit is not None:
                _, counters, y = hit
            else:
                counters, y = self._measure(cfg)
                self._remember(cfg, counters, y)
            self._pool.append((cfg, counters, y))
            return cfg, counters, y
        i = int(rng.integers(len(self._pool)))
        return self._pool[i]

    def _grouped_sample(self, rng: np.random.Generator, n: int,
                        query_batch: int) -> List[Dict[str, Any]]:
        """``n`` random configurations in groups of ``query_batch`` whose
        members share the ``batch_share_dims`` values of the group's first
        member — the measurement-cost-aware sampling the batched paths use
        (one compiled deployment serves each group)."""
        cfgs = self.space.sample(rng, n)
        share = [nm for nm in (self.batch_share_dims or ())
                 if nm in self.space.by_name]
        if not share or query_batch <= 1:
            return cfgs
        for g0 in range(0, n, query_batch):
            anchor = cfgs[g0]
            for c in cfgs[g0 + 1:g0 + query_batch]:
                for nm in share:
                    c[nm] = anchor[nm]
        return cfgs

    def dataset(self, n: int, seed: int = 0, query_batch: int = 1):
        """Collect an observational dataset of n random measurements.

        ``query_batch > 1`` (on envs declaring ``batch_share_dims``) samples
        in compile-key-sharing groups and measures through
        :meth:`intervene_batch`; ``query_batch=1`` reproduces the
        historical sequential collection exactly.  Envs with
        ``memoize_measurements`` reuse prior results for repeated
        configurations (and feed the observational pool) instead of paying
        the measurement twice.
        """
        from repro_torch.core.cameo import Dataset

        rng = np.random.default_rng(seed)
        cfgs = self._grouped_sample(rng, n, query_batch)
        d = Dataset()
        misses = [c for c in cfgs
                  if not (self.memoize_measurements
                          and self._config_key(c) in self._measured)]
        if query_batch > 1 and len(misses) > 1:
            fresh = dict(zip(map(self._config_key, misses),
                             self.intervene_batch(misses)))
        else:
            fresh = {}
        for cfg in cfgs:
            key = self._config_key(cfg)
            if self.memoize_measurements and key in self._measured:
                _, counters, y = self._measured[key]
            elif key in fresh:
                counters, y = fresh[key]
                self._remember(cfg, counters, y)
            else:
                counters, y = self._measure(cfg)
                self._remember(cfg, counters, y)
            if self.memoize_measurements and len(self._pool) < self._pool_size:
                self._pool.append((dict(cfg), dict(counters), y))
            d.add(cfg, counters, y)
        return d
