"""The framework's own tunable surface as a CAMEO ConfigSpace.

These are the cross-stack knobs a performance engineer actually turns —
the analogue of the paper's cpu_frequency / swappiness / dirty_ratio, with
the same properties: they interact, some combinations are invalid, and their
effect flips across environments (a tp that is optimal for a 15B dense model
is over-sharded for a 1B one).
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.core.spaces import ConfigSpace, Option
from repro_torch.utils.config import ModelConfig, ParallelConfig


def launch_families_for(cfg: ModelConfig) -> list:
    """Kernel families this architecture actually dispatches — the single
    source of the applicability rules shared by
    ``framework_space(include_kernel_launch=True)`` and the serve launcher's
    ``--tune-launch``.  Tuning (and, under the wallclock backend, timing) a
    family the model never runs wastes intervention budget on knobs with
    zero effect."""
    fams = ["rmsnorm"]
    if not cfg.is_attention_free:
        fams.append("flash_attention")
    if cfg.family in ("ssm", "hybrid"):
        # ssm_num_heads == 0 -> mamba-1 (selective scan); > 0 -> mamba-2 (ssd)
        fams.append("ssd" if cfg.ssm_num_heads else "mamba_scan")
    return fams


def framework_space(cfg: ModelConfig, kind: str = "train",
                    include_kernel_launch: bool = False) -> ConfigSpace:
    opts = [
        Option("microbatch", (1, 2, 4, 8), default=1),
        Option("remat", ("none", "dots", "full"), default="none",
               kind="categorical"),
        Option("sp", (0, 1), default=0, kind="boolean"),
        Option("grad_compression", ("none", "bf16", "int8_ef"),
               default="none", kind="categorical"),
        Option("scan_layers", (0, 1), default=1, kind="boolean"),
        Option("fsdp", (1, 2), default=2),
    ]
    if not cfg.is_attention_free:
        opts.append(Option("attn_q_block", (256, 512, 1024), default=512))
        opts.append(Option("attn_kv_block", (512, 1024, 2048), default=1024))
    if cfg.family in ("ssm", "hybrid"):
        opts.append(Option("ssm_chunk", (128, 256, 512), default=256))
    if cfg.is_moe:
        opts.append(Option("moe_group_size", (256, 512, 1024), default=512))
        opts.append(Option("moe_expert_axis", ("model", "data"),
                           default="model", kind="categorical"))
    if kind != "train":
        opts = [o for o in opts
                if o.name in ("attn_kv_block", "sp", "scan_layers",
                              "moe_group_size", "moe_expert_axis",
                              "ssm_chunk")]
        if not opts:
            opts = [Option("scan_layers", (0, 1), default=1, kind="boolean")]
    if include_kernel_launch:
        # the dispatch registry's launch parameters (``family.param`` keys)
        # replace the plan-level block knobs — one source of truth per
        # parameter, since an active ``dispatch.use_launch_config`` outranks
        # the ``ParallelConfig`` values at the call sites.  Apply the tuned
        # values with ``use_launch_config(launch_config_of(config))`` around
        # the measured step (and rebuild the steps: launch params are baked
        # in when a step is made).
        from repro_torch.kernels import dispatch

        overlap = {"attn_q_block": "flash_attention.q_block",
                   "attn_kv_block": "flash_attention.kv_block",
                   "ssm_chunk": "mamba_scan.chunk"}
        opts = [o for o in opts if o.name not in overlap]
        opts = opts + list(dispatch.launch_space(launch_families_for(cfg)).options)
    return ConfigSpace(opts)


def config_to_parallel_kv(config: Dict[str, Any]) -> str:
    """Tuner config -> the dryrun --parallel override string."""
    items = []
    for k, v in config.items():
        if k == "ssm_chunk" or "." in k:
            continue  # model-config / kernel-launch knobs, handled separately
        items.append(f"{k}={v}")
    return ",".join(items)


def launch_config_of(config: Dict[str, Any]) -> Dict[str, Any]:
    """The kernel-launch subset (``family.param`` keys) of a tuner config —
    feed it to ``repro_torch.kernels.dispatch.use_launch_config`` around the step.
    ``serving.*`` scheduler options, ``fleet.*`` router options and
    ``pages.*`` paging options are dotted but are NOT launch knobs (they
    deploy through ``ServingPlan.from_config`` / ``FleetPlan.from_config`` /
    ``PagedPlan.from_config``), so they are excluded.  The prefix literals
    match ``repro_torch.workloads.sim.SERVING_PREFIX`` / ``FLEET_PREFIX`` /
    ``repro_torch.serving.paging.PAGES_PREFIX`` — kept inline so this hot
    extraction path does not import the scheduler/model stack."""
    return {k: v for k, v in config.items()
            if "." in k and not k.startswith(("serving.", "fleet.",
                                              "pages."))}


def apply_config(par: ParallelConfig, config: Dict[str, Any]) -> ParallelConfig:
    kw = {}
    for k, v in config.items():
        if k == "ssm_chunk" or "." in k:
            continue  # kernel-launch keys apply via dispatch.use_launch_config
        cur = getattr(par, k)
        if isinstance(cur, bool):
            kw[k] = bool(v)
        elif isinstance(cur, int):
            kw[k] = int(v)
        else:
            kw[k] = v
    return par.replace(**kw)
