"""Analytic TPU performance environment — the benchmark workhorse.  Carried
over from :mod:`repro.envs.analytic` bit for bit (numpy only): a synthetic
environment for the paper's transfer experiments, priced with the
reference's TPU specs (``repro_torch.utils.hardware``), not a model of the
H100.

Deterministic (plus measurement noise) roofline + contention model of one
(architecture x shape x mesh x hardware) cell of the framework, with the
parallelism plan as the configuration space.  It exists because the paper's
evaluation needs hundreds of tuning iterations x 6 methods x seeds x
environments — the reference's compiled dry-run (``tuner/compiled_env.py``,
not ported) is the ground-truth backend but costs ~10 s per intervention.

The model reproduces the paper's *spurious correlation mechanism*: e.g.
``collective_bytes`` correlates positively with step time in a
bandwidth-degraded environment (cross-pod or v5e links) but negatively in a
compute-bound one (higher TP adds collective bytes yet removes step time),
exactly like IPC in Fig. 2 — while ``remat``/``microbatch`` effects stay
invariant.  Configuration interactions and invalid configurations
(divisibility, HBM overflow) are first-class.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.spaces import ConfigSpace, Option
from repro_torch.envs.base import PooledEnv
from repro_torch.utils.hardware import HARDWARE, HardwareSpec, TPU_V5E


@dataclass(frozen=True)
class ArchDims:
    name: str
    params: float            # total parameters
    active_params: float     # = params for dense
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    moe: bool = False


ARCH_DIMS = {
    "llama3.2-1b": ArchDims("llama3.2-1b", 1.24e9, 1.24e9, 2048, 16, 32, 8),
    "nemotron-4-15b": ArchDims("nemotron-4-15b", 15.2e9, 15.2e9, 6144, 32, 48, 8),
    "command-r-35b": ArchDims("command-r-35b", 35e9, 35e9, 8192, 40, 64, 8),
    "falcon-mamba-7b": ArchDims("falcon-mamba-7b", 7.3e9, 7.3e9, 4096, 64, 0, 0),
    "deepseek-v3-671b": ArchDims("deepseek-v3-671b", 671e9, 37e9, 7168, 61, 128, 128, moe=True),
}


@dataclass(frozen=True)
class TPUEnvSpec:
    """One environment: hardware x workload x software x topology."""
    arch: str = "llama3.2-1b"
    hardware: str = "tpu_v5e"
    seq_len: int = 4096
    global_batch: int = 256
    chips: int = 256
    cross_pod: bool = False
    noise: float = 0.02


def tpu_config_space(arch: str = "llama3.2-1b") -> ConfigSpace:
    dims = ARCH_DIMS[arch]
    opts = [
        Option("tp", (1, 2, 4, 8, 16, 32), default=8),
        Option("microbatch", (1, 2, 4, 8), default=1),
        Option("remat", ("none", "dots", "full"), default="none",
               kind="categorical"),
        Option("seq_parallel", (0, 1), default=0, kind="boolean"),
        Option("grad_compression", ("none", "bf16", "int8"), default="none",
               kind="categorical"),
        Option("attn_kv_block", (256, 512, 1024, 2048), default=1024),
        Option("collective_overlap", (0, 1), default=0, kind="boolean"),
        Option("compute_dtype", ("bf16", "f32"), default="bf16",
               kind="categorical"),
    ]
    if dims.moe:
        opts.append(Option("ep", (1, 4, 16, 64), default=16))
        opts.append(Option("capacity_factor", (1.0, 1.25, 1.5, 2.0),
                           default=1.25))
    if dims.n_heads == 0:  # attention-free: scan chunk replaces attn block
        opts = [o for o in opts if o.name != "attn_kv_block"]
        opts.append(Option("scan_chunk", (64, 128, 256, 512), default=256))
    return ConfigSpace(opts)


_REMAT_FLOPS = {"none": 1.0, "dots": 1.18, "full": 1.34}
_REMAT_BYTES = {"none": 1.55, "dots": 1.0, "full": 0.62}
_COMP_BYTES = {"none": 4.0, "bf16": 2.0, "int8": 1.0}


class AnalyticTPUEnv(PooledEnv):
    counter_names = ("flops_per_chip", "hbm_bytes", "collective_bytes",
                     "peak_mem_gb", "compute_s", "memory_s", "collective_s",
                     "energy")

    #: objective selector — "step_time" (default) or "energy"
    objective: str = "step_time"

    def __init__(self, spec: TPUEnvSpec, seed: int = 0):
        self.spec = spec
        self.dims = ARCH_DIMS[spec.arch]
        self.hw = HARDWARE[spec.hardware]
        super().__init__(tpu_config_space(spec.arch), self.counter_names,
                         seed=seed)
        self._rng = np.random.default_rng(seed + 7)

    # -- the performance model ------------------------------------------

    def _step_model(self, config) -> Tuple[Dict[str, float], float, bool]:
        s, d = self.spec, self.dims
        hw = self.hw
        tp = int(config["tp"])
        micro = int(config["microbatch"])
        remat = str(config["remat"])
        sp = bool(config.get("seq_parallel", 0))
        comp = str(config.get("grad_compression", "none"))
        dtype = str(config.get("compute_dtype", "bf16"))
        kv_block = int(config.get("attn_kv_block", 1024))
        chunk = int(config.get("scan_chunk", 256))
        overlap = bool(config.get("collective_overlap", 0))
        ep = int(config.get("ep", 1))
        cap = float(config.get("capacity_factor", 1.25))

        # ---- validity -----------------------------------------------------
        valid = True
        if tp > s.chips:
            valid = False
        dp = max(s.chips // tp, 1)
        if s.global_batch % (dp * micro) != 0:
            valid = False
        if d.n_heads and tp > d.n_heads:
            valid = False
        if d.moe and ep > 256:
            valid = False

        tokens = s.global_batch * s.seq_len
        peak = hw.peak_flops_bf16 * (1.0 if dtype == "bf16" else 0.45)

        # ---- compute ------------------------------------------------------
        flops = 6.0 * d.active_params * tokens / s.chips
        flops *= _REMAT_FLOPS[remat]
        if d.moe:
            flops *= cap / 1.25  # capacity padding wastes expert compute
        if d.n_heads:
            attn_flops = (12.0 * d.n_layers * s.seq_len * s.seq_len
                          * d.d_model * s.global_batch / s.chips)
            flops += attn_flops * _REMAT_FLOPS[remat]
        # skinny-matmul MXU derate: per-chip matmul width d_ff/tp
        width = max(d.d_model * 4 // max(tp, 1), 1)
        mxu_eff = min(1.0, 0.55 + 0.45 * min(width / 1024.0, 1.0))
        compute_s = flops / (peak * mxu_eff)

        # ---- memory ---------------------------------------------------------
        bpe = 2.0 if dtype == "bf16" else 4.0
        act_bytes = (28.0 * tokens * d.d_model * bpe / s.chips
                     * _REMAT_BYTES[remat] * d.n_layers / 16.0)
        if sp:
            act_bytes /= min(tp, 4)  # sequence-sharded norms/residuals
        param_traffic = 3.0 * d.params * 2.0 / s.chips
        kv_ineff = 1.0 + (0.25 if kv_block > 1024 else 0.0) \
            + (0.15 if kv_block < 512 else 0.0)
        scan_ineff = 1.0 + (0.2 if chunk < 128 else 0.0) \
            + (0.1 if chunk > 256 else 0.0)
        hbm_bytes = (act_bytes * kv_ineff * scan_ineff + param_traffic)
        memory_s = hbm_bytes / hw.hbm_bandwidth

        # HBM capacity: optimizer + params + activations working set
        opt_state = d.params * 12.0 / s.chips
        act_resident = act_bytes / max(micro, 1)
        peak_mem = opt_state + act_resident + d.params * 2.0 / s.chips
        if peak_mem > hw.hbm_capacity:
            valid = False

        # ---- collectives ----------------------------------------------------
        link = hw.dci_bandwidth if s.cross_pod else hw.ici_bandwidth
        tp_coll = (2.0 * tokens * d.d_model * bpe / dp
                   * (tp - 1) / max(tp, 1)) / max(tp, 1)
        if sp:
            tp_coll *= 0.7  # reduce-scatter/all-gather replaces all-reduce
        dp_coll = d.params * _COMP_BYTES[comp] / s.chips * (dp - 1) / max(dp, 1)
        moe_coll = 0.0
        if d.moe:
            moe_coll = 2.0 * tokens * d.d_model * bpe / s.chips \
                * min(ep, 8) / 8.0
        coll_bytes = tp_coll + dp_coll + moe_coll
        collective_s = coll_bytes / link
        if overlap:
            collective_s = max(collective_s - 0.55 * compute_s, 0.15 * collective_s)

        # microbatching: pipeline fill bubbles on collectives, smaller working set
        collective_s *= 1.0 + 0.03 * (micro - 1)

        step = compute_s + memory_s + collective_s
        # per-step energy: busy chips draw more when MXU-utilized; f32 and
        # high capacity factors burn extra joules per useful token
        util = compute_s / max(step, 1e-12)
        watts = 160.0 + 260.0 * util + (40.0 if dtype == "f32" else 0.0)
        energy = step * watts * s.chips
        counters = {
            "flops_per_chip": flops,
            "hbm_bytes": hbm_bytes,
            "collective_bytes": coll_bytes,
            "peak_mem_gb": peak_mem / 2 ** 30,
            "compute_s": compute_s,
            "memory_s": memory_s,
            "collective_s": collective_s,
            "energy": energy,
        }
        return counters, step, valid

    def _measure(self, config) -> Tuple[Dict[str, float], float]:
        counters, step, valid = self._step_model(config)
        if not valid:
            return counters, float("inf")
        noise = 1.0 + self.spec.noise * float(self._rng.standard_normal())
        y = counters["energy"] if self.objective == "energy" else step
        return counters, float(y * max(noise, 0.5))

    # -- ground truth for RE% -------------------------------------------

    def optimum(self, max_points: int = 4096) -> Tuple[Dict, float]:
        best, best_cfg = math.inf, None
        rng = np.random.default_rng(123)
        for cfg in self.space.grid(max_points, rng):
            counters, step, valid = self._step_model(cfg)
            y = counters["energy"] if self.objective == "energy" else step
            if valid and y < best:
                best, best_cfg = y, cfg
        return best_cfg, float(best)


class PaddedAnalyticEnv(AnalyticTPUEnv):
    """Analytic env with a long tail of weak/inert extra options (real
    configuration spaces have dozens of knobs with tiny effects — Tables
    7-12 of the paper list 28-100+). The pads perturb the objective by a
    small deterministic amount and leak weak correlations into synthetic
    event counters, so model-free optimizers must spend budget ruling them
    out while causal ranking prunes them offline."""

    N_PAD_EVENTS = 3

    def __init__(self, spec: TPUEnvSpec, extra_options: int = 0,
                 seed: int = 0):
        super().__init__(spec, seed=seed)
        self.extra_options = extra_options
        if extra_options:
            opts = list(self.space.options)
            for i in range(extra_options):
                opts.append(Option(f"pad{i}", (0, 1, 2, 3), default=0))
            self.space = ConfigSpace(opts)
        self._pad_rng = np.random.default_rng(1234)  # env-invariant weights
        self._pad_w = self._pad_rng.normal(size=max(extra_options, 1)) * 0.004
        self.counter_names = AnalyticTPUEnv.counter_names + tuple(
            f"pad_evt{i}" for i in range(self.N_PAD_EVENTS))

    def _measure(self, config):
        counters, y = super()._measure(config)
        bump = sum(self._pad_w[i] * float(config.get(f"pad{i}", 0))
                   for i in range(self.extra_options))
        import zlib
        key = zlib.crc32(repr(sorted(config.items())).encode())  # stable
        nz = np.random.default_rng(key)
        for i in range(self.N_PAD_EVENTS):
            counters[f"pad_evt{i}"] = (
                float(config.get(f"pad{i}", 0)) * 0.3
                + 0.1 * nz.standard_normal())
        if np.isfinite(y):
            y = y * (1.0 + bump)
        return counters, y

    def optimum(self, max_points: int = 4096):
        cfg, y = super().optimum(max_points)
        # pads at their best values shave at most sum(min(w*v)) off
        return cfg, y


def environment_pair(change: str, seed: int = 0, padded: int = 16
                     ) -> Tuple[AnalyticTPUEnv, AnalyticTPUEnv]:
    """The paper's four environmental-change axes, instantiated natively."""
    base = TPUEnvSpec()
    if change == "hardware":
        tgt = replace(base, hardware="tpu_v4_like")
    elif change == "workload":
        tgt = replace(base, seq_len=32768, global_batch=32)
    elif change == "software":
        tgt = replace(base, arch="nemotron-4-15b")
    elif change == "topology":
        tgt = replace(base, chips=512, cross_pod=True)
    elif change == "severe":
        tgt = replace(base, arch="command-r-35b", hardware="tpu_v4_like",
                      seq_len=32768, global_batch=32, chips=512,
                      cross_pod=True)
    else:
        raise ValueError(change)
    if padded:
        return (PaddedAnalyticEnv(base, padded, seed=seed),
                PaddedAnalyticEnv(tgt, padded, seed=seed + 1))
    return (AnalyticTPUEnv(base, seed=seed),
            AnalyticTPUEnv(tgt, seed=seed + 1))
