"""Model factory for the dense, ssm and hybrid families, plus parameter
counting — the port of :mod:`repro.models.model`.

``build_model(cfg, par, device=...)`` binds the functions of one
architecture to one device (``cuda`` unless the caller passes ``cpu``).
Parameters are counted from the port's own parameter tree built on the
``meta`` device (no allocation), where the reference used
``jax.eval_shape``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, NamedTuple, Optional, Union

import torch

from repro_torch.models import transformer
from repro_torch.utils.config import ModelConfig, ParallelConfig
from repro_torch.utils.device import DeviceLike, resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; known: {list(_DTYPES)}")


class Model(NamedTuple):
    """Bound model functions for one architecture on one device."""
    cfg: ModelConfig
    init: Callable[..., Dict]
    forward: Callable[..., Any]           # prefill / decode forward
    init_decode_state: Callable[..., Dict]
    # paged-KV variant: (batch, pool_pages, page_size, pages_per_slot_max)
    # -> stacked decode state
    init_paged_decode_state: Optional[Callable[..., Dict]] = None
    device: torch.device = torch.device("cpu")


def build_model(cfg: ModelConfig, par: Optional[ParallelConfig] = None, *,
                device: DeviceLike = None) -> Model:
    par = par or ParallelConfig()
    dtype = torch_dtype(cfg.dtype)
    dev = resolve_device(device)
    transformer.block_pattern(cfg)  # unported families fail here, early

    def init(seed: Union[int, torch.Generator] = 0) -> Dict:
        """Parameters drawn from a seeded generator on the model's device."""
        gen = seed
        if isinstance(seed, int):
            gen = torch.Generator(device=dev).manual_seed(seed)
        return transformer.init_lm_params(cfg, gen, dtype, dev)

    def forward(params, tokens, *, decode_state=None, decode=False,
                positions=None, return_hidden=False, **kw):
        return transformer.forward(
            params, cfg, par, tokens, positions=positions,
            decode_state=decode_state, decode=decode,
            return_hidden=return_hidden)

    def init_state(batch, max_len):
        return transformer.init_decode_state(cfg, batch, max_len, dtype, dev)

    def init_paged_state(batch, pool_pages, page_size, pages_per_slot_max):
        return transformer.init_paged_decode_state(
            cfg, batch, pool_pages, page_size, pages_per_slot_max, dtype, dev)

    return Model(cfg, init, forward, init_state, init_paged_state, dev)


@functools.lru_cache(maxsize=64)
def _param_numels(cfg: ModelConfig) -> Dict[str, int]:
    params = transformer.init_lm_params(cfg, None, torch_dtype(cfg.dtype),
                                        torch.device("meta"))
    out: Dict[str, int] = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out[f"{prefix}{k}"] = v.numel()
    walk(params, "")
    return out


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count from the parameter tree on the ``meta``
    device.  ``active_only`` matters only for MoE, not ported yet."""
    return sum(_param_numels(cfg).values())
