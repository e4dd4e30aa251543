"""Environment-shift transfer benchmarks: kernel-launch space under
``shifted:<kind>`` backends, and the serving stack under workload swaps —
the port of :mod:`repro.tuner.bench`.

The paper's central claim is that causal transfer survives *environmental
changes*.  This module measures exactly that on CPU-reproducible
environments, along two axes:

- **Kernel-launch sweep** (:func:`run_transfer_bench`): the source is the
  unshifted analytic launch-geometry model, the target is a
  :class:`~repro_torch.envs.measure.ShiftedAnalyticBackend` a fixed distance away
  (scaled hardware constants, workload-shape changes, heteroscedastic
  noise, tightened VMEM feasibility).
- **Serving sweep** (:func:`run_serving_bench`): the tuned surface is the
  whole serving stack (scheduler knobs + launch geometry,
  :class:`~repro_torch.envs.serving_env.ServingEnv`) and the environment
  change is a *workload-trace swap* — source trace → target trace, the
  paper's workload-fluctuation axis (``repro_torch.workloads`` registry
  kinds).
- **Fleet sweep** (:func:`run_fleet_bench`) and **sim-to-real sweep**
  (:func:`run_sim2real_bench`): a healthy fleet against a disrupted one,
  and the simulator against trace replays through the real batcher.

For every cell x change x method tuple the sweep runs ``transfer_tune``
under a fixed intervention budget and records best-y and regret-vs-round
trajectories against a pooled ground-truth optimum of the target.

Each sweep returns the document the reference's ``benchmarks/*_bench.py``
wrappers write (``BENCH_transfer.json`` ...); the ``gate`` block is what CI
asserts on (CAMEO's mean final regret must not exceed random search).  The
analytic and simulated environments price with one H100 SXM unless a cell
names its ``hardware`` (the parity tests pass the reference's constants);
the sim-to-real sweep replays on ``device`` (default ``cuda``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.envs.kernel_launch import KernelLaunchEnv, KernelWorkload
from repro_torch.envs.measure import HardwareSpec, ShiftedAnalyticBackend
from repro_torch.tuner.runner import transfer_tune
from repro_torch.utils.device import DeviceLike

#: regret assigned when a method never measured a feasible configuration —
#: far above any real relative regret so aggregate means stay ordered, while
#: trajectories keep ``None`` at those rounds (JSON has no inf)
INFEASIBLE_REGRET = 10.0

DEFAULT_SHIFTS = ("hardware", "workload", "feasibility")
DEFAULT_METHODS = ("cameo", "random")


@dataclass(frozen=True)
class BenchCell:
    """One workload cell the benchmark sweeps (``hardware``: the unshifted
    card the geometry prices with; ``None`` is one H100 SXM)."""

    name: str
    workload: KernelWorkload
    families: Optional[Tuple[str, ...]] = None
    hardware: Optional[HardwareSpec] = None


DEFAULT_CELLS: Tuple[BenchCell, ...] = (
    BenchCell("serve-8b", KernelWorkload()),
    BenchCell("train-2k", KernelWorkload(name="train-2k", batch=16,
                                         seq_len=2048)),
)


def cell_by_name(name: str, cells: Sequence[BenchCell] = DEFAULT_CELLS
                 ) -> BenchCell:
    for c in cells:
        if c.name == name:
            return c
    raise ValueError(f"unknown bench cell {name!r}; "
                     f"known: {[c.name for c in cells]}")


def make_shifted_pair(cell: BenchCell, shift: str, seed: int = 0
                      ) -> Tuple[KernelLaunchEnv, KernelLaunchEnv]:
    """(source, target) environments for one cell under one shift kind:
    unshifted analytic source, shifted analytic target, identical launch
    space.  The source env owns the family defaulting (modeled ∩ registered
    when the cell doesn't pin them) and the target reuses its choice."""
    src = KernelLaunchEnv(cell.workload, families=cell.families,
                          seed=seed + 1, backend="analytic",
                          backend_opts=({"hardware": cell.hardware}
                                        if cell.hardware else None))
    tgt_backend = ShiftedAnalyticBackend(cell.workload, src.families,
                                         seed=seed + 2, shifts=shift,
                                         hardware=cell.hardware)
    tgt = KernelLaunchEnv(cell.workload, backend=tgt_backend, seed=seed + 2)
    return src, tgt


def target_optimum(cell: BenchCell, shift: str, pool: int = 512,
                   seed: int = 99) -> float:
    """Ground-truth Y_opt of the shifted target: best measured value over a
    random pool (the paper's protocol, on a fresh noise stream)."""
    _, tgt = make_shifted_pair(cell, shift, seed=seed)
    rng = np.random.default_rng(seed)
    best = np.inf
    for cfg in tgt.space.sample(rng, pool):
        _, y = tgt.intervene(cfg)
        if np.isfinite(y) and y < best:
            best = float(y)
    if not np.isfinite(best):
        raise RuntimeError(
            f"no feasible configuration in a {pool}-sample pool for "
            f"cell={cell.name} shift={shift}")
    return best


def _regret(y: float, y_opt: float) -> Optional[float]:
    if not np.isfinite(y):
        return None
    return max(0.0, (float(y) - y_opt) / y_opt)


def _final_regret(trace: Sequence[float], y_opt: float) -> float:
    finite = [y for y in trace if np.isfinite(y)]
    if not finite:
        return INFEASIBLE_REGRET
    return _regret(min(finite), y_opt)


def _method_runs(make_pair, y_opt: float, *, methods: Sequence[str],
                 seeds: Sequence[int], budget: int, n_source: int,
                 n_target_init: int, query_batch: int = 1,
                 use_env_query: bool = False,
                 include_best_config: bool = False) -> Dict[str, Any]:
    """The per-method x per-seed run records every sweep shares: one
    ``transfer_tune`` per (method, seed) against a FRESH env pair from
    ``make_pair(seed)`` (backends' noise RNGs are stateful, so sharing a
    pair across methods would make results depend on run order), scored as
    regret trajectories against ``y_opt``.  ``query_batch`` restructures
    each run into ask/tell rounds of that many measurements (the budget is
    measurements either way); per-round sizes and wall-clock land in the
    run record's ``rounds``."""
    per_method: Dict[str, Any] = {}
    for method in methods:
        runs = []
        for seed in seeds:
            src, tgt = make_pair(seed)
            kw = {"query_text": tgt.query_text} if use_env_query else {}
            res = transfer_tune(method, src, tgt, budget=budget,
                                n_source=n_source,
                                n_target_init=n_target_init,
                                query_batch=query_batch, seed=seed,
                                **kw)
            trace = [float(y) for y in res.trace_best_y]
            run = {
                "seed": int(seed),
                "best_y": (float(res.best_y)
                           if np.isfinite(res.best_y) else None),
                "final_regret": _final_regret(trace, y_opt),
                "regret": [_regret(y, y_opt) for y in trace],
                "best_y_trace": [float(y) if np.isfinite(y) else None
                                 for y in trace],
                "wall_s": float(res.wall_s),
                "n_target_init": res.extras.get("n_target_init"),
                "rounds": [{"size": r["size"], "wall_s": r["wall_s"]}
                           for r in res.rounds],
            }
            if include_best_config:
                run["best_config"] = res.best_config
            runs.append(run)
        per_method[method] = {
            "runs": runs,
            "mean_final_regret": float(np.mean(
                [r["final_regret"] for r in runs])),
        }
    return per_method


def _finalize_doc(meta: Dict[str, Any], cells: List[Dict[str, Any]],
                  t_start: float) -> Dict[str, Any]:
    """Common document epilogue: meta + cells + the CI gate + wall time."""
    doc = {"meta": {**meta, "wall_s": None}, "cells": cells}
    doc["gate"] = gate_summary(doc)
    # repro: ignore[wall-clock] -- sweep wall time reported in the document's meta, allow-listed in the reference's bench.py
    doc["meta"]["wall_s"] = round(time.time() - t_start, 2)
    return doc


def run_transfer_bench(
    *,
    cells: Sequence[BenchCell] = DEFAULT_CELLS,
    shifts: Sequence[str] = DEFAULT_SHIFTS,
    methods: Sequence[str] = DEFAULT_METHODS,
    budget: int = 20,
    n_source: int = 64,
    n_target_init: int = 4,
    seeds: Sequence[int] = (0, 1),
    pool: int = 512,
    query_batch: int = 1,
) -> Dict[str, Any]:
    """The full sweep; returns the ``BENCH_transfer.json`` document."""
    # repro: ignore[wall-clock] -- sweep wall time reported in the document's meta, allow-listed in the reference's bench.py
    t_start = time.time()
    out_cells: List[Dict[str, Any]] = []
    for cell in cells:
        for shift in shifts:
            y_opt = target_optimum(cell, shift, pool=pool)
            out_cells.append({
                "cell": cell.name,
                "shift": shift,
                "y_opt": y_opt,
                "methods": _method_runs(
                    lambda seed: make_shifted_pair(cell, shift, seed=seed),
                    y_opt, methods=methods, seeds=seeds, budget=budget,
                    n_source=n_source, n_target_init=n_target_init,
                    query_batch=query_batch),
            })
    return _finalize_doc({
        "budget": int(budget),
        "n_source": int(n_source),
        "n_target_init": int(n_target_init),
        "seeds": [int(s) for s in seeds],
        "pool": int(pool),
        "query_batch": int(query_batch),
        "cells": [c.name for c in cells],
        "shifts": list(shifts),
        "methods": list(methods),
    }, out_cells, t_start)


# --------------------------------------------------------------------------
# serving sweep: source trace -> target trace
# --------------------------------------------------------------------------

#: the default cheap observational source — a calm memoryless arrival
#: process staging can always produce
DEFAULT_SOURCE_TRACE = "poisson:rate=2500"

#: target workload swaps the smoke sweep exercises: a burst regime, a
#: heavy-tailed length mixture (loaded enough that its y_opt is not tiny —
#: tiny optima amplify relative regret into gate noise), and a diurnal
#: rate cycle
DEFAULT_TARGET_TRACES: Tuple[str, ...] = (
    "bursty:rate=2500,burst=6",
    "heavy_tail:rate=2600",
    "diurnal:rate=2500",
)


@dataclass(frozen=True)
class ServingCell:
    """One served-model cell of the serving sweep: kernel dimensions plus
    the families the model dispatches, the source arrival process and the
    card the simulator prices with (``None``: one H100 SXM)."""

    name: str
    cell: KernelWorkload
    families: Tuple[str, ...] = ("flash_attention", "rmsnorm")
    source: str = DEFAULT_SOURCE_TRACE
    hardware: Optional[HardwareSpec] = None


DEFAULT_SERVING_CELLS: Tuple[ServingCell, ...] = (
    ServingCell("serve-8b", KernelWorkload()),
)


def serving_cell_by_name(name: str,
                         cells: Sequence[ServingCell] = DEFAULT_SERVING_CELLS
                         ) -> ServingCell:
    for c in cells:
        if c.name == name:
            return c
    raise ValueError(f"unknown serving cell {name!r}; "
                     f"known: {[c.name for c in cells]}")


def paged_serving_surface(cells: Sequence[Any]) -> Tuple[Any, ...]:
    """Each cell's family set with ``paged_attention`` joined: the sweep
    then tunes the paged-KV surface — ``pages.*`` scheduler knobs plus the
    family's launch options (page size, pages per slot, prefill chunk) —
    alongside ``serving.*`` and the other launch geometry.  Works for both
    :class:`ServingCell` and :class:`FleetCell`."""
    return tuple(
        c if "paged_attention" in c.families
        else replace(c, families=c.families + ("paged_attention",))
        for c in cells)


#: the trace realization every (cell, target) sweep point shares.  Unlike
#: the shifted kernel backends (where the seed only drives noise), a
#: ServingEnv's seed would otherwise pick the trace itself — and y_opt,
#: y_default, and every method run must score against the SAME arrival
#: process or regret compares different environments.
BENCH_TRACE_SEED = 0


def make_serving_bench_pair(cell: ServingCell, target: str, seed: int = 0):
    """(source, target) ServingEnv pair for one cell and one target trace.
    ``seed`` varies only the measurement-noise streams; the trace
    realization is pinned to ``BENCH_TRACE_SEED``."""
    from repro_torch.envs.serving_env import make_serving_pair

    return make_serving_pair(cell.source, target, cell.cell,
                             families=cell.families, seed=seed,
                             trace_seed=BENCH_TRACE_SEED,
                             hardware=cell.hardware)


def serving_target_optimum(cell: ServingCell, target: str, pool: int = 256,
                           seed: int = 99
                           ) -> Tuple[float, Optional[float]]:
    """(Y_opt, y_default) of the target serving environment: best measured
    value over a random pool plus the default configuration's measurement —
    the deploy-nothing baseline the tuned config must beat."""
    _, tgt = make_serving_bench_pair(cell, target, seed=seed)
    rng = np.random.default_rng(seed)
    _, y_default = tgt.intervene(tgt.space.default_config())
    best = y_default if np.isfinite(y_default) else np.inf
    for cfg in tgt.space.sample(rng, pool):
        _, y = tgt.intervene(cfg)
        if np.isfinite(y) and y < best:
            best = float(y)
    if not np.isfinite(best):
        raise RuntimeError(
            f"no feasible configuration in a {pool}-sample pool for "
            f"cell={cell.name} target={target}")
    return best, (float(y_default) if np.isfinite(y_default) else None)


def run_serving_bench(
    *,
    cells: Sequence[ServingCell] = DEFAULT_SERVING_CELLS,
    targets: Sequence[str] = DEFAULT_TARGET_TRACES,
    methods: Sequence[str] = DEFAULT_METHODS,
    budget: int = 12,
    n_source: int = 48,
    n_target_init: int = 3,
    seeds: Sequence[int] = (0, 1),
    pool: int = 256,
    query_batch: int = 1,
    paged: bool = False,
) -> Dict[str, Any]:
    """The serving-stack sweep (cell x target trace x method); returns the
    ``BENCH_serving.json`` document.  Shape mirrors the kernel-launch sweep
    with ``source``/``target`` trace specs instead of a shift kind, plus a
    per-cell ``y_default`` so 'tuned beats the default plan' is auditable.
    ``paged=True`` widens every cell to the paged-KV surface
    (:func:`paged_serving_surface`) and stamps the mode into ``meta``."""
    # repro: ignore[wall-clock] -- sweep wall time reported in the document's meta, allow-listed in the reference's bench.py
    t_start = time.time()
    if paged:
        cells = paged_serving_surface(cells)
    out_cells: List[Dict[str, Any]] = []
    for cell in cells:
        for target in targets:
            y_opt, y_default = serving_target_optimum(cell, target,
                                                      pool=pool)
            out_cells.append({
                "cell": cell.name,
                "source": cell.source,
                "target": target,
                "y_opt": y_opt,
                "y_default": y_default,
                "methods": _method_runs(
                    lambda seed: make_serving_bench_pair(cell, target,
                                                         seed=seed),
                    y_opt, methods=methods, seeds=seeds, budget=budget,
                    n_source=n_source, n_target_init=n_target_init,
                    query_batch=query_batch,
                    use_env_query=True, include_best_config=True),
            })
    return _finalize_doc({
        "budget": int(budget),
        "n_source": int(n_source),
        "n_target_init": int(n_target_init),
        "seeds": [int(s) for s in seeds],
        "pool": int(pool),
        "query_batch": int(query_batch),
        "cells": [c.name for c in cells],
        "sources": [c.source for c in cells],
        "targets": list(targets),
        "methods": list(methods),
        "paged": bool(paged),
    }, out_cells, t_start)


# --------------------------------------------------------------------------
# fleet sweep: healthy fleet source -> disrupted fleet target
# --------------------------------------------------------------------------

#: fleet-disruption shift kinds the fleet sweep defaults to — the two
#: registered by this subsystem (``shifted:straggler``/``shifted:resize``)
DEFAULT_FLEET_SHIFTS: Tuple[str, ...] = ("straggler", "resize")


@dataclass(frozen=True)
class FleetCell:
    """One fleet sweep point: a served model + arrival process + device
    budget, tuned with the ``fleet.*`` router/replica knobs joined in
    (``hardware``: as :class:`ServingCell`'s)."""

    name: str
    cell: KernelWorkload
    families: Tuple[str, ...] = ("flash_attention", "rmsnorm")
    workload: str = "bursty:rate=2500,burst=6"
    num_devices: int = 8
    hardware: Optional[HardwareSpec] = None


DEFAULT_FLEET_CELLS: Tuple[FleetCell, ...] = (
    FleetCell("serve-8b", KernelWorkload()),
)


def fleet_cell_by_name(name: str,
                       cells: Sequence[FleetCell] = DEFAULT_FLEET_CELLS
                       ) -> FleetCell:
    for c in cells:
        if c.name == name:
            return c
    raise ValueError(f"unknown fleet cell {name!r}; "
                     f"known: {[c.name for c in cells]}")


def make_fleet_bench_pair(cell: FleetCell, shift: str, seed: int = 0):
    """(healthy fleet source, disrupted fleet target) over the pinned trace
    realization — same workload, same device budget, the target additionally
    suffering ``shift`` (straggling devices / an elastic resize).  ``seed``
    varies only the measurement-noise streams."""
    from repro_torch.envs.serving_env import make_fleet_pair

    return make_fleet_pair(cell.workload, shift, cell.cell,
                           families=cell.families, seed=seed,
                           num_devices=cell.num_devices,
                           trace_seed=BENCH_TRACE_SEED,
                           hardware=cell.hardware)


def fleet_target_optimum(cell: FleetCell, shift: str, pool: int = 256,
                         seed: int = 99) -> Tuple[float, Optional[float]]:
    """(Y_opt, y_default) of the disrupted fleet target: best measured value
    over a random pool plus the default fleet configuration."""
    _, tgt = make_fleet_bench_pair(cell, shift, seed=seed)
    rng = np.random.default_rng(seed)
    _, y_default = tgt.intervene(tgt.space.default_config())
    best = y_default if np.isfinite(y_default) else np.inf
    for cfg in tgt.space.sample(rng, pool):
        _, y = tgt.intervene(cfg)
        if np.isfinite(y) and y < best:
            best = float(y)
    if not np.isfinite(best):
        raise RuntimeError(
            f"no feasible configuration in a {pool}-sample pool for "
            f"fleet cell={cell.name} shift={shift}")
    return best, (float(y_default) if np.isfinite(y_default) else None)


def run_fleet_bench(
    *,
    cells: Sequence[FleetCell] = DEFAULT_FLEET_CELLS,
    shifts: Sequence[str] = DEFAULT_FLEET_SHIFTS,
    methods: Sequence[str] = DEFAULT_METHODS,
    budget: int = 12,
    n_source: int = 48,
    n_target_init: int = 3,
    seeds: Sequence[int] = (0, 1),
    pool: int = 256,
    query_batch: int = 1,
    paged: bool = False,
) -> Dict[str, Any]:
    """The fleet sweep (cell x disruption x method); returns the
    ``BENCH_fleet.json`` document.  Both halves of every pair tune the full
    fleet surface (``fleet.*`` + ``serving.*`` + launch geometry); the
    environment change is the fleet disruption, so the gate asserts CAMEO's
    transfer survives stragglers and elastic resizes — with the winning
    replica count / routing policy auditable per run via ``best_config``.
    ``paged=True`` widens every cell to the paged-KV surface."""
    # repro: ignore[wall-clock] -- sweep wall time reported in the document's meta, allow-listed in the reference's bench.py
    t_start = time.time()
    if paged:
        cells = paged_serving_surface(cells)
    out_cells: List[Dict[str, Any]] = []
    for cell in cells:
        for shift in shifts:
            y_opt, y_default = fleet_target_optimum(cell, shift, pool=pool)
            out_cells.append({
                "cell": cell.name,
                "workload": cell.workload,
                "shift": shift,
                "num_devices": cell.num_devices,
                "y_opt": y_opt,
                "y_default": y_default,
                "methods": _method_runs(
                    lambda seed: make_fleet_bench_pair(cell, shift,
                                                       seed=seed),
                    y_opt, methods=methods, seeds=seeds, budget=budget,
                    n_source=n_source, n_target_init=n_target_init,
                    query_batch=query_batch,
                    use_env_query=True, include_best_config=True),
            })
    return _finalize_doc({
        "budget": int(budget),
        "n_source": int(n_source),
        "n_target_init": int(n_target_init),
        "seeds": [int(s) for s in seeds],
        "pool": int(pool),
        "query_batch": int(query_batch),
        "cells": [c.name for c in cells],
        "workloads": [c.workload for c in cells],
        "shifts": list(shifts),
        "methods": list(methods),
        "paged": bool(paged),
    }, out_cells, t_start)


# --------------------------------------------------------------------------
# sim-to-real sweep: simulator source -> real-batcher replay target
# --------------------------------------------------------------------------

#: pinned tiny traces the sim2real smoke sweep replays — small enough that a
#: real-batcher measurement (jit compile + replay) stays in CI budget
DEFAULT_SIM2REAL_WORKLOADS: Tuple[str, ...] = (
    "poisson:rate=1500,horizon=0.004,mean_prompt=6,mean_output=4,max_len=16",
    ("bursty:rate=1500,burst=6,horizon=0.004,mean_prompt=6,mean_output=4,"
     "max_len=16"),
)


@dataclass(frozen=True)
class Sim2RealCell:
    """One sim-to-real sweep point: a pinned trace replayed through the
    default tiny deployment
    (``repro_torch.envs.replay_env.default_replay_model``)."""

    name: str
    workload: str


DEFAULT_SIM2REAL_CELLS: Tuple[Sim2RealCell, ...] = (
    Sim2RealCell("tiny-poisson", DEFAULT_SIM2REAL_WORKLOADS[0]),
    Sim2RealCell("tiny-bursty", DEFAULT_SIM2REAL_WORKLOADS[1]),
)


def sim2real_cell_by_name(name: str,
                          cells: Sequence[Sim2RealCell] = DEFAULT_SIM2REAL_CELLS
                          ) -> Sim2RealCell:
    for c in cells:
        if c.name == name:
            return c
    raise ValueError(f"unknown sim2real cell {name!r}; "
                     f"known: {[c.name for c in cells]}")


def make_sim2real_bench_pair(cell: Sim2RealCell, seed: int = 0,
                             repeats: int = 3, device: DeviceLike = None):
    """(simulator source, replay target on ``device``) for one cell over
    the pinned trace realization (``BENCH_TRACE_SEED``, same convention as
    the serving sweep).  ``seed`` varies the source's noise stream only —
    the deployment (model weights, replay sampling) is part of the
    environment and stays fixed, exactly like real hardware across tuning
    runs."""
    from repro_torch.envs.replay_env import make_sim2real_pair

    return make_sim2real_pair(cell.workload, seed=seed,
                              trace_seed=BENCH_TRACE_SEED, repeats=repeats,
                              device=device)


def sim2real_target_optimum(cell: Sim2RealCell, pool: int = 16,
                            seed: int = 99, repeats: int = 3,
                            query_batch: int = 1, device: DeviceLike = None
                            ) -> Tuple[float, Optional[float]]:
    """(Y_opt, y_default) of the replay target over a random pool plus the
    default configuration — each entry a real batcher replay, so pools stay
    far smaller than the simulator sweeps'.

    ``query_batch > 1`` collects the pool in compile-key-sharing groups
    through ``intervene_batch`` (the first group anchored on the DEFAULT
    configuration's shared dims, so the default's deployment serves it
    too) — the dominant cost of the sim2real sweep is this pool's jit
    compiles, and grouping collapses them to one per group."""
    _, tgt = make_sim2real_bench_pair(cell, seed=seed, repeats=repeats,
                                      device=device)
    rng = np.random.default_rng(seed)
    default = tgt.space.default_config()
    if query_batch > 1:
        cfgs = tgt._grouped_sample(rng, pool, query_batch)
        share = [nm for nm in (tgt.batch_share_dims or ())
                 if nm in tgt.space.by_name]
        for c in cfgs[:query_batch]:
            for nm in share:
                c[nm] = default[nm]
        results = tgt.intervene_batch([default] + cfgs)
        y_default = results[0][1]
        ys = [y for _, y in results if np.isfinite(y)]
        best = min(ys) if ys else np.inf
    else:
        _, y_default = tgt.intervene(default)
        best = y_default if np.isfinite(y_default) else np.inf
        for cfg in tgt.space.sample(rng, pool):
            _, y = tgt.intervene(cfg)
            if np.isfinite(y) and y < best:
                best = float(y)
    if not np.isfinite(best):
        raise RuntimeError(
            f"no feasible configuration in a {pool}-sample pool for "
            f"sim2real cell={cell.name}")
    return best, (float(y_default) if np.isfinite(y_default) else None)


def run_sim2real_bench(
    *,
    cells: Sequence[Sim2RealCell] = DEFAULT_SIM2REAL_CELLS,
    methods: Sequence[str] = DEFAULT_METHODS,
    budget: int = 6,
    n_source: int = 32,
    n_target_init: int = 2,
    seeds: Sequence[int] = (0,),
    pool: int = 16,
    repeats: int = 3,
    query_batch: int = 1,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """The sim-to-real sweep (cell x method), replayed on ``device``; returns the
    ``BENCH_sim2real.json`` document.  The source is the deterministic
    serving simulator, the target is the real ``ContinuousBatcher`` replay —
    regret is measured IN THE REPLAY ENVIRONMENT (wall-clock ms), so the
    gate asserts that causal transfer survives the sim-to-real fidelity gap,
    not just a second simulator.  Document shape mirrors the serving sweep
    with a ``workload`` field per cell instead of ``source``/``target``."""
    # repro: ignore[wall-clock] -- sweep wall time reported in the document's meta, allow-listed in the reference's bench.py
    t_start = time.time()
    out_cells: List[Dict[str, Any]] = []
    for cell in cells:
        y_opt, y_default = sim2real_target_optimum(cell, pool=pool,
                                                   repeats=repeats,
                                                   query_batch=query_batch,
                                                   device=device)
        out_cells.append({
            "cell": cell.name,
            "workload": cell.workload,
            "y_opt": y_opt,
            "y_default": y_default,
            "methods": _method_runs(
                lambda seed: make_sim2real_bench_pair(cell, seed=seed,
                                                      repeats=repeats,
                                                      device=device),
                y_opt, methods=methods, seeds=seeds, budget=budget,
                n_source=n_source, n_target_init=n_target_init,
                query_batch=query_batch,
                use_env_query=True, include_best_config=True),
        })
    return _finalize_doc({
        "budget": int(budget),
        "n_source": int(n_source),
        "n_target_init": int(n_target_init),
        "seeds": [int(s) for s in seeds],
        "pool": int(pool),
        "repeats": int(repeats),
        "query_batch": int(query_batch),
        "cells": [c.name for c in cells],
        "workloads": [c.workload for c in cells],
        "methods": list(methods),
    }, out_cells, t_start)


def gate_summary(doc: Dict[str, Any], champion: str = "cameo",
                 reference: str = "random") -> Dict[str, Any]:
    """CI acceptance: the champion's mean final regret (over every
    cell x shift x seed) must not exceed the reference's.  Absent methods
    make the gate vacuously pass (``checked: False``)."""
    champ, ref = [], []
    for cell in doc["cells"]:
        methods = cell["methods"]
        if champion in methods and reference in methods:
            champ.extend(r["final_regret"] for r in methods[champion]["runs"])
            ref.extend(r["final_regret"] for r in methods[reference]["runs"])
    if not champ:
        return {"checked": False, "passed": True,
                "champion": champion, "reference": reference}
    c, r = float(np.mean(champ)), float(np.mean(ref))
    return {"checked": True, "passed": bool(c <= r),
            "champion": champion, "reference": reference,
            "champion_mean_final_regret": c,
            "reference_mean_final_regret": r}
