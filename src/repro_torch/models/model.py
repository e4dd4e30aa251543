"""Model factory for the ten assigned families' archs (dense, moe, ssm,
hybrid and vlm through :mod:`~repro_torch.models.transformer`, the audio
encoder-decoder through :mod:`~repro_torch.models.encdec`), plus parameter
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

from repro_torch.models import encdec, transformer
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
    # -> stacked decode state; None for families without a paged serving
    # path (audio)
    init_paged_decode_state: Optional[Callable[..., Dict]] = None
    device: torch.device = torch.device("cpu")


def init_params_tree(cfg: ModelConfig, gen: Optional[torch.Generator],
                     dtype, device) -> Dict[str, Any]:
    """The family's parameter tree (the reference's ``init_encdec_params``
    for audio, ``init_lm_params`` otherwise), drawn from ``gen``."""
    if cfg.family == "audio":
        return encdec.init_encdec_params(cfg, gen, dtype, device)
    return transformer.init_lm_params(cfg, gen, dtype, device)


def build_model(cfg: ModelConfig, par: Optional[ParallelConfig] = None, *,
                device: DeviceLike = None) -> Model:
    par = par or ParallelConfig()
    dtype = torch_dtype(cfg.dtype)
    dev = resolve_device(device)

    def init(seed: Union[int, torch.Generator] = 0) -> Dict:
        """Parameters drawn from a seeded generator on the model's device."""
        gen = seed
        if isinstance(seed, int) and dev.type != "meta":  # meta: shapes only
            gen = torch.Generator(device=dev).manual_seed(seed)
        return init_params_tree(cfg, gen, dtype, dev)

    if cfg.family == "audio":
        def forward(params, tokens, *, frames=None, decode_state=None,
                    decode=False, positions=None, layout=None, last=False,
                    **kw):
            enc_out = encdec.encode(params, cfg, par, frames, layout)
            logits, state = encdec.decode_forward(
                params, cfg, par, tokens, enc_out, positions=positions,
                decode_state=decode_state, decode=decode, layout=layout,
                last=last)
            return logits, state, torch.zeros((), dtype=torch.float32,
                                              device=logits.device)

        def init_state(batch, max_len, layout=None):
            return encdec.init_encdec_decode_state(cfg, batch, max_len, dtype,
                                                   dev, layout)

        return Model(cfg, init, forward, init_state, None, dev)

    def forward(params, tokens, *, vision_embeds=None, decode_state=None,
                decode=False, positions=None, return_hidden=False,
                layout=None, last=False, **kw):
        return transformer.forward(
            params, cfg, par, tokens, positions=positions,
            vision_embeds=vision_embeds, decode_state=decode_state,
            decode=decode, return_hidden=return_hidden, layout=layout,
            last=last)

    def init_state(batch, max_len, layout=None):
        return transformer.init_decode_state(cfg, batch, max_len, dtype, dev,
                                             layout)

    def init_paged_state(batch, pool_pages, page_size, pages_per_slot_max):
        return transformer.init_paged_decode_state(
            cfg, batch, pool_pages, page_size, pages_per_slot_max, dtype, dev)

    return Model(cfg, init, forward, init_state, init_paged_state, dev)


@functools.lru_cache(maxsize=64)
def _param_numels(cfg: ModelConfig) -> Dict[str, int]:
    params = init_params_tree(cfg, None, torch_dtype(cfg.dtype),
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
    device.  With ``active_only`` (MoE), routed-expert parameters are
    scaled by top_k / num_experts — the "active parameters" convention."""
    numels = _param_numels(cfg)
    total = sum(numels.values())
    expert = sum(n for path, n in numels.items()
                 if "moe" in path and "shared" not in path
                 and any(w in path for w in ("w_gate", "w_up", "w_down")))
    if active_only and cfg.is_moe and expert:
        total = total - expert + int(expert * cfg.moe_top_k
                                     / cfg.moe_num_experts)
    return total
