"""Ground-truth SCM sandbox — the paper's swappiness/dirty_ratio/IPC example
(Sec. 2.1, Fig. 2), as an executable structural causal model.  Carried
over from :mod:`repro.envs.sandbox` bit for bit (numpy only).

Mechanisms (per environment e):

    swappiness  S ~ config option        (true cause, invariant mechanism)
    dirty_ratio R ~ config option        (true cause, small invariant effect)
    IPC         I = a_e + b_e * S + P_e(R) + noise   (ENV-DEPENDENT: the
                                         direction b_e flips with memory size)
    latency     Y = c*S + d*R' + e*sched + noise     (invariant mechanism)

Latency's structural equation never changes across environments — only the
IPC mechanism does (small memory: page flushing makes IPC *fall* as
swappiness rises; large memory: IPC *rises* with it).  An ML regressor that
leans on the IPC shortcut is poisoned after the shift (Table 2); the causal
model conditions on the invariant parents of Y and is unaffected — exactly
the paper's Fig. 2 narrative.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.core.spaces import ConfigSpace, Option
from repro_torch.envs.base import PooledEnv


def sandbox_space() -> ConfigSpace:
    return ConfigSpace([
        Option("swappiness", (10, 30, 50, 60, 80, 90), default=60),
        Option("dirty_ratio", (5, 10, 20, 35, 50), default=20),
        Option("vfs_cache_pressure", (1, 100, 500), default=100),  # inert
        Option("sched_latency", (6, 12, 24, 48), default=24),      # weak
    ])


class SandboxSCMEnv(PooledEnv):
    """One environment of the sandbox SCM. env_memory in {small, large}."""

    counter_names = ("ipc", "major_faults")

    def __init__(self, env_memory: str = "small", noise: float = 0.15,
                 seed: int = 0):
        super().__init__(sandbox_space(), self.counter_names, seed=seed)
        self.env_memory = env_memory
        self.noise = noise
        self._rng = np.random.default_rng(seed + 1)

    @staticmethod
    def _latency_mean(s, r, sched):
        """The INVARIANT structural equation for the objective."""
        return 6.0 + 7.0 * s + 1.4 * max(0.0, 0.5 - r) + 0.6 * sched

    def _measure(self, config) -> Tuple[Dict[str, float], float]:
        s = float(config["swappiness"]) / 100.0
        r = float(config["dirty_ratio"]) / 50.0
        sched = float(config["sched_latency"]) / 48.0
        rng = self._rng

        if self.env_memory == "small":
            # small memory: aggressive swapping busy-spins reclaim work, so
            # IPC RISES with swappiness while the app stalls (corr(I,Y) > 0)
            ipc = (0.6 + 2.2 * s + 0.9 * max(0.0, 0.5 - r)
                   + self.noise * rng.standard_normal())
            faults = 30.0 * max(0.0, 0.5 - r) + 8.0 * s \
                + 2.0 * rng.standard_normal()
        else:
            # large memory: reclaim never runs; higher swappiness just idles
            # the prefetcher -> IPC FALLS with it (corr(I,Y) < 0): the flip
            ipc = (2.6 - 2.2 * s + 0.1 * max(0.0, 0.5 - r)
                   + self.noise * rng.standard_normal())
            faults = 2.0 * max(0.0, 0.5 - r) + 1.0 * s \
                + 2.0 * rng.standard_normal()
        latency = (self._latency_mean(s, r, sched)
                   + self.noise * rng.standard_normal())
        return {"ipc": float(ipc), "major_faults": float(faults)}, float(latency)

    def optimum(self) -> float:
        """Best achievable mean latency over the grid (noise-free)."""
        best = np.inf
        for cfg in self.space.grid():
            s = float(cfg["swappiness"]) / 100.0
            r = float(cfg["dirty_ratio"]) / 50.0
            sched = float(cfg["sched_latency"]) / 48.0
            best = min(best, self._latency_mean(s, r, sched))
        return float(best)


def make_sandbox_pair(seed: int = 0) -> Tuple[SandboxSCMEnv, SandboxSCMEnv]:
    """(source=small-memory TX2-like, target=large-memory Xavier-like)."""
    return (SandboxSCMEnv("small", seed=seed),
            SandboxSCMEnv("large", seed=seed + 100))
