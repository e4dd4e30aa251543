"""Architecture registry — the slice of :mod:`repro.configs.registry` the
port runs so far: the reference's ten archs (dense, moe, ssm, hybrid, the
vlm ``llama-3.2-vision-11b`` and the audio encoder-decoder
``whisper-large-v3``), in the reference's order.  The shape cells and the
dry-run input specs come in a later slice.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.utils.config import ModelConfig, ParallelConfig

_ARCH_MODULES: Dict[str, str] = {
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2p7b",
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "llama3.2-1b": "repro_torch.configs.llama3p2_1b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1p8b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama3p2_vision_11b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch])


def get_model_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def default_parallel(arch: str, kind: str) -> ParallelConfig:
    return _module(arch).default_parallel(kind)
