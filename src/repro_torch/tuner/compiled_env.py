"""CompiledPerfEnv — the expensive tuning target, the port of
:mod:`repro.tuner.compiled_env`.

``intervene(config)`` turns a parallel plan from ``framework_space`` into
``--parallel`` overrides (``config_to_parallel_kv``) and runs
:func:`repro_torch.launch.dryrun.dryrun_cell` on it in this process: the
cell's step as rank 0 of the production mesh executes it, traced on
``meta`` tensors with its collectives recorded (``lower_step``).  Its
objective is the three-term roofline bound of the step on an H100
(compute, memory, collectives; no overlap), the terms and the per-chip
counts its system-event counters.

This is the paper's "production environment is expensive to query"
setting: an intervention costs a trace of the whole step (seconds to
minutes on the host), which is why CAMEO warm-starts from the cheap
analytic source (:func:`make_aligned_source`).  A plan that
``RunConfig.validate`` rejects, whose trace fails, or whose per-chip peak
exceeds the card's memory scores ``inf``.  Records are cached under a
temporary directory by (arch, shape, plan).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional, Tuple

from repro_torch.envs.base import PooledEnv
from repro_torch.tuner.space import config_to_parallel_kv, framework_space
from repro_torch.utils.hardware import H100_SXM, HardwareSpec


def make_aligned_source(arch: str = "llama3.2-1b", seed: int = 0):
    """An AnalyticTPUEnv whose option vocabulary matches the framework's
    (``seq_parallel`` -> ``sp``, ``int8`` -> ``int8_ef``), so its
    observational dataset transfers onto ``framework_space`` by name."""
    from repro_torch.core.spaces import ConfigSpace, Option
    from repro_torch.envs.analytic import AnalyticTPUEnv, TPUEnvSpec

    rename = {"seq_parallel": "sp"}
    value_map = {"grad_compression": {"int8": "int8_ef"}}

    class AlignedAnalyticEnv(AnalyticTPUEnv):
        def __init__(self):
            base_arch = arch if arch in ("llama3.2-1b", "nemotron-4-15b",
                                         "command-r-35b", "falcon-mamba-7b",
                                         "deepseek-v3-671b") else "llama3.2-1b"
            super().__init__(TPUEnvSpec(arch=base_arch), seed=seed)
            opts = []
            for o in self.space.options:
                name = rename.get(o.name, o.name)
                vals = tuple(value_map.get(o.name, {}).get(v, v)
                             for v in o.values)
                dflt = value_map.get(o.name, {}).get(o.default, o.default)
                opts.append(Option(name, vals, default=dflt, kind=o.kind))
            self.space = ConfigSpace(opts)

        def _measure(self, config):
            inner = {}
            inv_rename = {v: k for k, v in rename.items()}
            for k, v in config.items():
                ik = inv_rename.get(k, k)
                if ik in value_map:
                    inv_vals = {nv: ov for ov, nv in value_map[ik].items()}
                    v = inv_vals.get(v, v)
                inner[ik] = v
            return super()._measure(inner)

    return AlignedAnalyticEnv()


class CompiledPerfEnv(PooledEnv):
    counter_names = ("compute_s", "memory_s", "collective_s",
                     "flops_per_chip", "hbm_bytes", "collective_bytes",
                     "peak_mem_gb")

    def __init__(self, arch: str, shape: str, *, multi_pod: bool = False,
                 hardware: HardwareSpec = H100_SXM, seed: int = 0,
                 cache_dir: Optional[str] = None):
        from repro_torch.configs.registry import get_model_config

        self.arch = arch
        self.shape_name = shape
        self.multi_pod = multi_pod
        self.hw = hardware
        cfg = get_model_config(arch)
        kind = "train" if shape.startswith("train") else (
            "prefill" if shape.startswith("prefill") else "decode")
        space = framework_space(cfg, kind)
        super().__init__(space, self.counter_names, seed=seed, pool_size=64)
        self.cache_dir = cache_dir or os.path.join(
            tempfile.gettempdir(), "repro_torch_compiled_env")
        os.makedirs(self.cache_dir, exist_ok=True)

    def _cache_key(self, kv: str) -> str:
        safe = kv.replace("=", "-").replace(",", "_") or "default"
        return os.path.join(
            self.cache_dir,
            f"{self.arch}__{self.shape_name}__"
            f"{'multipod' if self.multi_pod else 'pod'}__{safe}.json")

    def _measure(self, config) -> Tuple[Dict[str, float], float]:
        from repro_torch.launch.dryrun import dryrun_cell

        kv = config_to_parallel_kv(config)
        cache = self._cache_key(kv)
        if os.path.exists(cache):
            with open(cache) as f:
                rec = json.load(f)
        else:
            try:
                rec = dryrun_cell(self.arch, self.shape_name,
                                  multi_pod=self.multi_pod, par_kv=kv or None,
                                  save=False, tag="tuner")
            except (ValueError, KeyError, TypeError, RuntimeError,
                    NotImplementedError):
                # an invalid plan (divisibility, a layout the rules
                # refuse) or a trace that fails: infeasible
                return {n: 0.0 for n in self.counter_names}, float("inf")
            with open(cache, "w") as f:
                json.dump(rec, f)

        h = rec["hlo_analysis"]
        compute_s = h["flops_per_chip"] / self.hw.peak_flops_bf16
        memory_s = h["bytes_per_chip"] / self.hw.hbm_bandwidth
        coll_s = h["total_collective_bytes_per_chip"] / self.hw.ici_bandwidth
        # the records' memory analysis is per chip
        peak_gb = rec["memory_analysis"]["peak_bytes"] / 2**30
        step = max(compute_s, memory_s, coll_s)  # no-overlap roofline bound
        counters = {
            "compute_s": compute_s, "memory_s": memory_s,
            "collective_s": coll_s,
            "flops_per_chip": h["flops_per_chip"],
            "hbm_bytes": h["bytes_per_chip"],
            "collective_bytes": h["total_collective_bytes_per_chip"],
            "peak_mem_gb": peak_gb,
        }
        if peak_gb > self.hw.hbm_capacity / 2**30:
            return counters, float("inf")
        return counters, float(step)
