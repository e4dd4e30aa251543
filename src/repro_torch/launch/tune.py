"""Shared tuning plumbing for the launchers — the port of
:mod:`repro.launch.tune`.

The serve launcher closes the CAMEO loop before serving a workload: build
the :class:`KernelWorkload` cell matching the assignment, transfer-tune the
serving stack (scheduler knobs and kernel launch geometry) in the
simulator, and deploy the winner on the batcher.  The family gating
(``launch_families_for``) lives here once.  Kernel-launch tuning
(``tune_launch_config``, the launchers' ``--tune-launch`` /
``--measure-backend`` and the backend-name validator those flags take)
comes with the kernel-launch slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


def launch_workload_for(cfg, batch: int, seq_len: int, *,
                        kind: str = "serve"):
    """A KernelWorkload cell matching this assignment — attention dims from
    the config, and for ssm/hybrid models the mamba surface too (d_inner
    channels, recurrent state, mamba-2 head geometry), so the tuned
    chunk/block optimum is for the kernels this model actually runs."""
    from repro_torch.envs.measure import KernelWorkload

    kw = KernelWorkload()
    d_inner = cfg.ssm_expand * cfg.d_model
    is_ssm = cfg.family in ("ssm", "hybrid")
    return KernelWorkload(
        name=f"{kind}-{cfg.name}", batch=batch, seq_len=seq_len,
        heads=cfg.num_heads or kw.heads,
        kv_heads=cfg.num_kv_heads or cfg.num_heads or kw.kv_heads,
        head_dim=getattr(cfg, "head_dim", 0) or kw.head_dim,
        d_model=cfg.d_model,
        channels=d_inner if is_ssm else kw.channels,
        scan_state=(cfg.ssm_state or kw.scan_state) if is_ssm else kw.scan_state,
        ssm_heads=cfg.ssm_num_heads or kw.ssm_heads,
        ssm_head_dim=(d_inner // cfg.ssm_num_heads if cfg.ssm_num_heads
                      else kw.ssm_head_dim),
        ssm_state=(cfg.ssm_state or kw.ssm_state) if is_ssm else kw.ssm_state)


def tune_serving_config(cfg, workload: str, budget: int, *,
                        source_workload: Optional[str] = None,
                        n_source: int = 48, n_target_init: int = 3,
                        method: str = "cameo", query_batch: int = 1,
                        seed: int = 0):
    """Transfer-tune the full serving stack (scheduler knobs + kernel launch
    geometry) for one workload trace: cheap ``source_workload`` trace
    (default: the benchmark's canonical calm-Poisson source) as the
    observational source, the requested ``workload`` as the target.  Returns
    the :class:`TuneResult`; deploy with ``ServingEnv.plan_of(best_config)``
    + ``TuneResult.launch_config``."""
    from repro_torch.envs.serving_env import make_serving_pair
    from repro_torch.tuner.bench import DEFAULT_SOURCE_TRACE
    from repro_torch.tuner.runner import transfer_tune
    from repro_torch.tuner.space import launch_families_for

    source_workload = source_workload or DEFAULT_SOURCE_TRACE

    cell = launch_workload_for(cfg, batch=1, seq_len=512, kind="serve")
    src, tgt = make_serving_pair(source_workload, workload, cell,
                                 families=launch_families_for(cfg),
                                 seed=seed)
    result = transfer_tune(method, src, tgt, budget=budget,
                           n_source=n_source, n_target_init=n_target_init,
                           query_batch=query_batch,
                           query_text=tgt.query_text, seed=seed)
    print(f"[serve] tuned serving config ({result.method}, budget={budget}, "
          f"p99={result.best_y:.0f} us modeled): {result.best_config}")
    return result


def predicted_serving_report(cfg, trace, config: Optional[Dict[str, Any]]):
    """Price a serving configuration on ``trace`` in the deterministic
    simulator — the sim-predicted half of ``--sim2real-eval`` (the replayed
    half comes from ``serving/replay.py``).  Uses the same cell derivation
    and family gating as serving tuning, so the prediction is for the model
    the batcher actually deploys."""
    from repro_torch.envs import measure as measure_mod
    from repro_torch.tuner.space import launch_families_for
    from repro_torch.workloads import ServingPlan, ServingSimulator

    config = config or {}
    cell = launch_workload_for(cfg, batch=1, seq_len=512, kind="serve")
    modeled = measure_mod.modeled_families()
    families = [f for f in launch_families_for(cfg) if f in modeled]
    sim = ServingSimulator(cell, families)
    return sim.run(trace, ServingPlan.from_config(config), config)

