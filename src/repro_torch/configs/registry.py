"""Architecture registry — the slice of :mod:`repro.configs.registry` the
port runs so far: ``llama3.2-1b`` (served), ``falcon-mamba-7b`` and
``zamba2-2.7b`` (trained).  The other seven configs, the shape cells and
the dry-run input specs come in later slices.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.utils.config import ModelConfig, ParallelConfig

_ARCH_MODULES: Dict[str, str] = {
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2p7b",
    "llama3.2-1b": "repro_torch.configs.llama3p2_1b",
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
