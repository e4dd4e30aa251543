"""CAMEO — Algorithm 1 of the paper.

Knowledge extraction (offline):
  1. learn causal performance models G_s (from the source dataset D_s) and
     G_t (from m initial target samples);
  2. rank nodes by ACE on the objective in G_s; pick k at the ACE elbow;
  3. transfer the union Markov blanket of the top-k nodes -> the reduced
     space the warm CGP operates on.

Knowledge update (online active loop):
  4. CGP_warm on the reduced space (source data), CGP_cold on the full
     space (target data);
  5. each round: ε-greedy observation-vs-intervention (eq. 8); for
     interventions pick argmax of the λ-combined EI (eqs. 5-7), measure,
     apply constraint handling (infeasible -> ∞), update D_t, periodically
     refresh G_t and the CGPs.

The environment contract is ``repro_torch.envs.base.PerfEnv``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.ace import choose_k, rank_by_ace
from repro_torch.core.acquisition import combined_acquisition, expected_improvement
from repro_torch.core.cgp import CausalGP
from repro_torch.core.discovery import CausalGraph, fci_lite
from repro_torch.core.epsilon import observation_epsilon
from repro_torch.core.markov_blanket import top_k_blanket
from repro_torch.core.query import Query
from repro_torch.core.spaces import ConfigSpace
from repro_torch.obs import trace as obs_trace


@dataclass
class Dataset:
    """Aligned configs / system-event counters / objective values."""
    configs: List[Dict[str, Any]] = field(default_factory=list)
    counters: List[Dict[str, float]] = field(default_factory=list)
    ys: List[float] = field(default_factory=list)

    def add(self, config, counters, y):
        self.configs.append(dict(config))
        self.counters.append(dict(counters or {}))
        self.ys.append(float(y))

    def __len__(self):
        return len(self.ys)

    def matrix(self, space: ConfigSpace, counter_names: Sequence[str],
               *, maximize: bool = False) -> Tuple[np.ndarray, List[str]]:
        """[options..., counters..., objective] matrix + column names.

        Infeasible measurements (±inf from constraint handling / invalid
        configurations) are clamped to a pessimistic finite value so the CI
        tests and regressions stay well-posed.  "Pessimistic" is
        direction-aware: constraint handling stores ``inf * sign``, so for a
        ``maximize`` objective the sentinel is ``-inf`` and the clamp must
        land *below* every feasible value — clamping high would turn an
        infeasible configuration into the best-looking row and poison
        discovery and the ACE ranking.
        """
        rows = []
        for cfg, cnt, y in zip(self.configs, self.counters, self.ys):
            x = space.encode(cfg)
            c = [float(cnt.get(n, 0.0)) for n in counter_names]
            rows.append(np.concatenate([x, c, [y]]))
        names = list(space.names) + list(counter_names) + ["__objective__"]
        m = np.asarray(rows, np.float64)
        obj_col = m.shape[1] - 1
        for col in range(m.shape[1]):
            v = m[:, col]
            bad = ~np.isfinite(v)
            if bad.any():
                good = v[~bad]
                margin = (2.0 * (good.max() - good.min() + 1.0)
                          if len(good) else 0.0)
                hi = good.max() + margin if len(good) else 0.0
                lo = good.min() - margin if len(good) else 0.0
                worst = lo if (maximize and col == obj_col) else hi
                m[bad, col] = worst
        return m, names


@dataclass
class CameoTrace:
    best_y: List[float] = field(default_factory=list)
    action: List[str] = field(default_factory=list)
    lam_fraction: List[float] = field(default_factory=list)
    model_update_s: List[float] = field(default_factory=list)
    recommend_s: List[float] = field(default_factory=list)
    g_t_edges: List[int] = field(default_factory=list)


@dataclass(frozen=True)
class Proposal:
    """One slot of a q-batch round.

    ``kind`` is ``"observe"`` (resolve against the environment's
    observational pool) or ``"intervene"`` (measure ``config``).  Observe
    proposals carry no config — the pool draw happens at resolution time so
    the tuner's RNG stream stays identical to the sequential loop's.
    """

    kind: str
    config: Optional[Dict[str, Any]] = None


class Cameo:
    """Causal multi-environment optimizer (Algorithm 1)."""

    def __init__(
        self,
        space: ConfigSpace,
        query: Query,
        source_data: Dataset,
        *,
        counter_names: Sequence[str] = (),
        l_alpha: float = 0.1,
        k: Optional[int] = None,
        n_max_obs: int = 50,
        candidates_per_round: int = 256,
        rediscover_every: int = 10,
        ci_alpha: float = 0.05,
        seed: int = 0,
    ):
        self.space = space
        self.query = query
        self.counter_names = list(counter_names)
        self.l_alpha = l_alpha
        self.n_max_obs = n_max_obs
        self.cand_n = candidates_per_round
        self.rediscover_every = rediscover_every
        self.ci_alpha = ci_alpha
        self.rng = np.random.default_rng(seed)
        self.trace = CameoTrace()

        self.d_s = source_data
        self.d_t = Dataset()
        self._sign = -1.0 if query.maximize else 1.0  # internal: minimize

        # -- knowledge extraction phase (offline, lines 1-3) ---------------
        # repro: ignore[wall-clock] -- tuner-phase wall_s telemetry only; never feeds seeded decisions
        t0 = time.perf_counter()
        data_s, names_s = self.d_s.matrix(space, self.counter_names,
                                          maximize=query.maximize)
        self.g_s = fci_lite(data_s, names_s, alpha=ci_alpha)
        ranked = rank_by_ace(data_s, names_s, "__objective__", self.g_s)
        # only configuration options can be intervened on
        ranked_opts = [(n, v) for n, v in ranked if n in space.by_name]
        self.k = k if k is not None else choose_k(ranked_opts)
        self.ranked = ranked_opts
        mb = top_k_blanket(self.g_s, ranked_opts, self.k, "__objective__",
                           data=data_s, names=names_s)
        self.reduced_names = [n for n in space.names
                              if n in mb or n in {x for x, _ in ranked_opts[:self.k]}]
        if not self.reduced_names:
            self.reduced_names = [n for n, _ in ranked_opts[:max(self.k, 2)]]
        self.g_t: Optional[CausalGraph] = None
        # repro: ignore[wall-clock] -- tuner-phase wall_s telemetry only; never feeds seeded decisions
        self.extraction_s = time.perf_counter() - t0

        self._warm: Optional[CausalGP] = None
        self._cold: Optional[CausalGP] = None
        self._fitted_at = -1
        self._round_idx = 0  # ask/tell rounds so far (introspection only)

    # ------------------------------------------------------------------ API

    @property
    def best(self) -> Tuple[Optional[Dict], float]:
        if not self.d_t.ys:
            return None, float("inf")
        ys = np.asarray(self.d_t.ys)
        feas = [i for i in range(len(ys))
                if np.isfinite(ys[i])]
        if not feas:
            return None, float("inf")
        i = feas[int(np.argmin(ys[feas] * self._sign))] \
            if self.query.maximize else feas[int(np.argmin(ys[feas]))]
        return self.d_t.configs[i], float(ys[i])

    def seed_target(self, dataset: Dataset) -> None:
        """Initial m target samples (D_t) — counted against nothing."""
        for c, cnt, y in zip(dataset.configs, dataset.counters, dataset.ys):
            self.d_t.add(c, cnt, y)
        self._refresh_graph_t()

    def run(self, env, budget: int, query_batch: int = 1,
            round_log: Optional[List[Dict[str, Any]]] = None
            ) -> Tuple[Dict, float]:
        """The active loop (lines 5-21). env: repro_torch.envs.base.PerfEnv.

        ``query_batch`` restructures the budget as rounds of up to k
        measurements each: one ``ask(k)`` proposal, one (batched)
        measurement, one ``tell``.  ``query_batch=1`` reproduces the
        sequential loop exactly — same RNG stream, same trajectory.
        ``round_log``, when given, receives one ``{"size", "actions",
        "wall_s"}`` record per round."""
        share_dims = getattr(env, "batch_share_dims", None)
        spent = 0
        while spent < budget:
            k = min(max(int(query_batch), 1), budget - spent)
            # repro: ignore[wall-clock] -- tuner-phase wall_s telemetry only; never feeds seeded decisions
            t0 = time.perf_counter()
            actions = self._round(env, k, share_dims=share_dims)
            if round_log is not None:
                round_log.append({"size": len(actions),
                                  "actions": list(actions),
                                  # repro: ignore[wall-clock] -- tuner-phase wall_s telemetry only; never feeds seeded decisions
                                  "wall_s": round(time.perf_counter() - t0,
                                                  4)})
            spent += len(actions)
        cfg, y = self.best
        return cfg or self.space.default_config(), y

    # ------------------------------------------------------------ internals

    def _ys_internal(self) -> np.ndarray:
        return np.asarray(self.d_t.ys) * self._sign

    def _refresh_graph_t(self) -> None:
        if len(self.d_t) >= 8:
            data_t, names_t = self.d_t.matrix(self.space, self.counter_names,
                                              maximize=self.query.maximize)
            keep = data_t.std(axis=0) > 1e-12
            # the objective column must survive: early target rounds can have
            # identical ys (constant column), and a g_t missing its
            # __objective__ node breaks the later ACE re-ranking against it
            keep[names_t.index("__objective__")] = True
            cols = np.where(keep)[0]
            self.g_t = fci_lite(data_t[:, cols],
                                [names_t[i] for i in cols],
                                alpha=self.ci_alpha, max_cond=1)
            self.trace.g_t_edges.append(self.g_t.num_edges())

    def _fit_surrogates(self) -> None:
        ys_s = np.asarray(self.d_s.ys) * self._sign
        ys_t = self._ys_internal()
        finite_t = np.isfinite(ys_t)
        if finite_t.any():
            good = ys_t[finite_t]
            worst = float(good.max() + 0.5 * (np.ptp(good) + 1e-3))
        else:
            worst = 1.0
        ys_t = np.where(finite_t, ys_t, worst)
        self._warm = CausalGP(self.space, self.reduced_names).fit(
            self.d_s.configs, ys_s)
        # cold operates on the full space with a constant interventional
        # mean: a multivariate adjustment is unsupported at the few-sample
        # target regime and extrapolates disastrously
        self._cold = CausalGP(self.space, self.space.names,
                              mean_mode="constant").fit(
            self.d_t.configs, ys_t)
        self._fitted_at = len(self.d_t)

    def step(self, env) -> str:
        """One sequential round (one measurement); returns the action taken
        ('observe' | 'intervene').  Implemented as an ``ask(1)``/``tell``
        round — bit-identical to the historical sequential loop."""
        return self._round(env, 1)[0]

    # --------------------------------------------------------- ask / tell

    def ask(self, k: int = 1, *, allow_observe: bool = True,
            share_dims: Optional[Sequence[str]] = None) -> List[Proposal]:
        """Propose a q-batch of ``k`` slots (lines 6-16, batched).

        Per-slot ε-greedy mixing decides observe-vs-intervene for each slot
        (eq. 8, one ``u`` draw per slot); all intervene slots are then
        filled from ONE scored candidate set: the first pick is the
        acquisition argmax (identical to the sequential loop, so ``k=1``
        reproduces it exactly), later picks maximize acquisition × a
        repulsion penalty in the reduced causal subspace while holding the
        non-reduced dims at the anchor's values — dims outside the reduced
        space carry no causal effect under the transferred model, so pinning
        them costs nothing in expectation and lets batched environments
        share expensive measurement infrastructure (one compiled deployment
        serves the whole round).  ``share_dims`` (usually the environment's
        ``batch_share_dims``) additionally discounts candidates that would
        open another expensive measurement group within the round.
        """
        k = max(int(k), 1)
        self._round_idx += 1
        if len(self.d_t) < 2:
            # cold start: must intervene to have any target signal
            props = [Proposal("intervene", c)
                     for c in self.space.sample(self.rng, k)]
            obs_trace.tuner_event("ask", tuner="cameo",
                                  round=self._round_idx, k=k,
                                  cold_start=True)
            return props

        # repro: ignore[wall-clock] -- tuner-phase wall_s telemetry only; never feeds seeded decisions
        t0 = time.perf_counter()
        if self._warm is None or self._fitted_at != len(self.d_t):
            self._fit_surrogates()
        # repro: ignore[wall-clock] -- tuner-phase wall_s telemetry only; never feeds seeded decisions
        self.trace.model_update_s.append(time.perf_counter() - t0)

        # -- ε-greedy observation / intervention (eq. 8), per slot ----------
        x_t = np.stack([self.space.encode(c) for c in self.d_t.configs])
        eps = observation_epsilon(x_t, len(self.d_t), self.n_max_obs)
        kinds = []
        eps_draws = []
        for _ in range(k):
            u = float(self.rng.random())
            eps_draws.append(u)
            kinds.append("observe" if (eps > u and allow_observe)
                         else "intervene")
        n_int = sum(1 for kd in kinds if kd == "intervene")
        if n_int == 0:
            obs_trace.tuner_event("ask", tuner="cameo",
                                  round=self._round_idx, k=k, eps=eps,
                                  eps_draws=eps_draws, kinds=kinds,
                                  n_candidates=0)
            return [Proposal("observe") for _ in kinds]

        # -- intervention via the λ-combined acquisition -------------------
        # repro: ignore[wall-clock] -- tuner-phase wall_s telemetry only; never feeds seeded decisions
        t1 = time.perf_counter()
        cands = self.space.sample(self.rng, self.cand_n)
        best_cfg, _ = self.best
        if best_cfg is not None:
            cands.extend(self.space.neighbors(best_cfg, self.rng, 16))
        # source incumbents: the warm model's strongest transfer signal
        ys_s = np.asarray(self.d_s.ys) * self._sign
        for i in np.argsort(np.where(np.isfinite(ys_s), ys_s, np.inf))[:5]:
            cands.append({k2: v for k2, v in self.d_s.configs[int(i)].items()
                          if k2 in self.space.by_name})
            cands.extend(self.space.neighbors(cands[-1], self.rng, 3))
        # never re-intervene on a configuration already measured infeasible
        infeasible = {self._key(c) for c, y in zip(self.d_t.configs,
                                                   self.d_t.ys)
                      if not np.isfinite(y)}
        measured = {self._key(c) for c in self.d_t.configs}
        filtered = [c for c in cands
                    if self._key(c) not in infeasible
                    and self._key(c) not in measured]
        if filtered:
            cands = filtered
        alpha, lam = self._score(cands)
        self.trace.lam_fraction.append(float(lam.mean()))
        picks = self._select_batch(cands, alpha, n_int,
                                   measured | infeasible, share_dims)
        # repro: ignore[wall-clock] -- tuner-phase wall_s telemetry only; never feeds seeded decisions
        self.trace.recommend_s.append(time.perf_counter() - t1)

        # introspection only: reads already-computed state, draws no RNG —
        # the traced and untraced trajectories are identical
        if obs_trace.enabled():
            obs_trace.tuner_event(
                "ask", tuner="cameo", round=self._round_idx, k=k, eps=eps,
                eps_draws=eps_draws, kinds=kinds, n_candidates=len(cands),
                acq_max=float(np.max(alpha)), acq_mean=float(np.mean(alpha)),
                lam_mean=float(lam.mean()),
                reduced_names=list(self.reduced_names),
                picks=[{n: v for n, v in p.items()} for p in picks])

        out: List[Proposal] = []
        it = iter(picks)
        for kd in kinds:
            out.append(Proposal("observe") if kd == "observe"
                       else Proposal("intervene", next(it)))
        return out

    def tell(self, configs: Sequence[Dict], counters: Sequence[Dict],
             ys: Sequence[float], actions: Optional[Sequence[str]] = None,
             *, record: bool = True) -> None:
        """Ingest one round of measurements: constraint handling per point,
        trace bookkeeping per point, and ONE causal-graph / reduced-space
        refresh per round — fired iff the round crossed a
        ``rediscover_every`` boundary, which at ``k=1`` is exactly the
        sequential per-point schedule.  (Surrogates refresh lazily on the
        next ``ask``, also once per round.)  ``record=False`` skips trace
        and rediscovery bookkeeping — the cold-start convention of the
        sequential loop."""
        actions = (list(actions) if actions is not None
                   else ["intervene"] * len(configs))
        n0 = len(self.d_t)
        for cfg, cnt, y, act in zip(configs, counters, ys, actions):
            self.d_t.add(cfg, cnt, self._maybe_constrain(cnt, y))
            if record:
                self.trace.action.append(act)
                _, best_y = self.best
                self.trace.best_y.append(best_y)
        refreshed = record and (len(self.d_t) // self.rediscover_every
                                > n0 // self.rediscover_every)
        if refreshed:
            self._refresh_graph_t()
            # refresh the reduced space with target evidence: union of the
            # source blanket and any new strong target-side effects
            if self.g_t is not None:
                data_t, names_t = self.d_t.matrix(
                    self.space, self.counter_names,
                    maximize=self.query.maximize)
                ranked_t = rank_by_ace(data_t, names_t, "__objective__",
                                       self.g_t)
                extra = [n for n, v in ranked_t[:self.k]
                         if n in self.space.by_name
                         and n not in self.reduced_names]
                self.reduced_names.extend(extra)
        if obs_trace.enabled():
            _, best_y = self.best
            finite = [float(y) for y in ys if np.isfinite(y)]
            obs_trace.tuner_event(
                "tell", tuner="cameo", round=self._round_idx,
                told=len(list(configs)), actions=list(actions),
                best_y=best_y,
                round_best=(min(finite) if finite else None),
                graph_refreshed=bool(refreshed),
                g_t_edges=(self.trace.g_t_edges[-1]
                           if self.trace.g_t_edges else None),
                n_reduced=len(self.reduced_names),
                reduced_names=list(self.reduced_names))

    def _round(self, env, k: int,
               share_dims: Optional[Sequence[str]] = None) -> List[str]:
        """One ask → measure → tell round; returns the actions taken."""
        cold = len(self.d_t) < 2
        props = self.ask(k, allow_observe=hasattr(env, "observe"),
                         share_dims=share_dims)
        configs: List[Dict] = []
        counters: List[Dict] = []
        ys: List[float] = []
        actions: List[str] = []
        pending: List[Dict] = []
        for p in props:
            if p.kind == "observe":
                cfg, cnt, y = env.observe(self.rng)
                configs.append(cfg)
                counters.append(cnt)
                ys.append(y)
                actions.append("observe")
            else:
                pending.append(p.config)
        if pending:
            if len(pending) > 1 and hasattr(env, "intervene_batch"):
                results = env.intervene_batch(pending)
            else:
                results = [env.intervene(c) for c in pending]
            for cfg, (cnt, y) in zip(pending, results):
                configs.append(cfg)
                counters.append(cnt)
                ys.append(y)
                actions.append("intervene")
        self.tell(configs, counters, ys, actions, record=not cold)
        return actions

    # ---------------------------------------------- acquisition / selection

    def _score(self, cands: Sequence[Dict]) -> Tuple[np.ndarray, np.ndarray]:
        """λ-combined acquisition over ``cands`` (eqs. 5-7); deterministic —
        consumes no RNG, so re-scoring projected pools is parity-safe."""
        mu_w, sd_w = self._warm.predict(cands)
        mu_c, sd_c = self._cold.predict(cands)
        finite = self._ys_internal()[np.isfinite(self._ys_internal())]
        best_internal = float(np.min(finite)) if len(finite) else 0.0
        ei_w = expected_improvement(mu_w, sd_w, self._warm.best_observed)
        ei_c = expected_improvement(mu_c, sd_c, best_internal)
        return combined_acquisition(ei_w, ei_c, self.l_alpha)

    #: repulsion lengthscale in the normalized reduced subspace, and the
    #: acquisition discount for opening another expensive measurement group
    #: (``share_dims``) within one round
    batch_repulsion_ell = 0.25
    batch_new_group_discount = 0.25

    def _select_batch(self, cands: Sequence[Dict], alpha: np.ndarray,
                      n: int, taken_keys: Set[tuple],
                      share_dims: Optional[Sequence[str]] = None
                      ) -> List[Dict]:
        """Diverse top-``n``: anchor = argmax acquisition (the sequential
        pick), then greedy repulsion-penalized picks over the candidate set
        PROJECTED onto the anchor's non-reduced dims."""
        first = int(np.argmax(alpha))
        anchor = {nm: cands[first].get(nm, self.space.by_name[nm].default)
                  for nm in self.space.names}
        picked = [anchor]
        if n == 1:
            return picked

        reduced = [nm for nm in self.space.names if nm in self.reduced_names]
        if not reduced:
            reduced = list(self.space.names)
        other = [nm for nm in self.space.names if nm not in reduced]
        seen = set(taken_keys)
        seen.add(self._key(anchor))
        pool: List[Dict] = []
        for c in cands:
            pc = {nm: c.get(nm, self.space.by_name[nm].default)
                  for nm in self.space.names}
            for nm in other:
                pc[nm] = anchor[nm]
            key = self._key(pc)
            if key in seen:
                continue
            seen.add(key)
            pool.append(pc)
        if not pool:
            return picked

        alpha_p, _ = self._score(pool)
        alpha_p = np.maximum(np.asarray(alpha_p, np.float64), 1e-300)
        idx = [self.space.names.index(nm) for nm in reduced]
        xr = np.stack([self.space.encode(c) for c in pool])[:, idx]
        picked_x = [self.space.encode(anchor)[idx]]

        share = [nm for nm in (share_dims or ()) if nm in self.space.by_name]

        def group_key(cfg: Dict) -> tuple:
            return tuple(cfg[nm] for nm in share)

        open_groups = {group_key(anchor)} if share else set()
        alive = np.ones(len(pool), bool)
        ell2 = 2.0 * self.batch_repulsion_ell ** 2
        for _ in range(n - 1):
            if not alive.any():
                break
            pen = np.ones(len(pool))
            for px in picked_x:
                d2 = ((xr - px) ** 2).mean(axis=1)
                pen *= 1.0 - np.exp(-d2 / ell2)
            score = alpha_p * np.maximum(pen, 1e-12)
            if share:
                fresh = np.asarray([group_key(c) not in open_groups
                                    for c in pool])
                score = score * np.where(fresh,
                                         self.batch_new_group_discount, 1.0)
            score = np.where(alive, score, -np.inf)
            j = int(np.argmax(score))
            picked.append(pool[j])
            picked_x.append(xr[j])
            alive[j] = False
            if share:
                open_groups.add(group_key(pool[j]))
        return picked

    def _key(self, cfg: Dict) -> tuple:
        return tuple(cfg.get(n, self.space.by_name[n].default)
                     for n in self.space.names)

    def _maybe_constrain(self, counters: Dict[str, float], y: float) -> float:
        """Constraint handling (lines 17-19): infeasible -> ∞ (internal)."""
        metrics = dict(counters or {})
        metrics[self.query.objective] = y
        if not self.query.satisfies(metrics):
            return float("inf") * (self._sign)
        return y
