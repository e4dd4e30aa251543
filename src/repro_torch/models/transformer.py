"""Decoder-only LM, dense family — the dense part of
:mod:`repro.models.transformer` (the moe / ssm / hybrid / vlm families come
in later slices).

Parameters and decode state keep the reference's layout: super-block
weights stacked on a leading ``nsb`` axis under ``params["blocks"]``, and
per-super-block caches stacked the same way (the batcher's row scatter
relies on it).  Where the reference scans over the stacked axis with
``jax.lax.scan``, :func:`forward` loops over it; each layer's weights and
cache are views into the stacked tensors, and the caches are updated in
place (see :mod:`repro_torch.models.attention`).  This port runs on one
device, so the reference's activation sharding constraint is dropped.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_mlp, apply_rmsnorm, embed_tokens, init_embed, init_mlp,
    init_rmsnorm, lm_logits,
)
from repro_torch.utils.config import ModelConfig, ParallelConfig


# --------------------------------------------------------------------------
# super-block patterns
# --------------------------------------------------------------------------

def block_pattern(cfg: ModelConfig) -> List[str]:
    """Sub-layer kinds within one super-block."""
    if cfg.family != "dense" or cfg.is_moe or cfg.attn_type == "mla":
        raise NotImplementedError(
            f"{cfg.name}: only the dense GQA family is ported so far "
            f"(family={cfg.family!r}, attn_type={cfg.attn_type!r})")
    return ["dense"]


def num_superblocks(cfg: ModelConfig) -> int:
    pat = len(block_pattern(cfg))
    assert cfg.num_layers % pat == 0, (cfg.num_layers, pat)
    return cfg.num_layers // pat


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _init_sublayer(gen, cfg: ModelConfig, kind: str, dtype, device,
                   lead: Tuple[int, ...]) -> Dict:
    return {
        "attn_norm": init_rmsnorm(cfg.d_model, dtype, device, lead),
        "attn": attn.init_gqa(gen, cfg, dtype, device, lead),
        "mlp_norm": init_rmsnorm(cfg.d_model, dtype, device, lead),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype,
                        device, lead),
    }


def init_lm_params(cfg: ModelConfig, gen: Optional[torch.Generator], dtype,
                   device) -> Dict[str, Any]:
    """The reference's parameter tree (``init_lm_params``), drawn from
    ``gen``; block leaves carry the leading ``nsb`` axis."""
    pat = block_pattern(cfg)
    lead = (num_superblocks(cfg),)
    return {
        "embed": init_embed(gen, cfg.vocab_size, cfg.d_model, dtype, device,
                            cfg.tie_embeddings),
        "blocks": {f"sub{i}": _init_sublayer(gen, cfg, kind, dtype, device,
                                             lead)
                   for i, kind in enumerate(pat)},
        "final_norm": init_rmsnorm(cfg.d_model, dtype, device),
    }


# --------------------------------------------------------------------------
# caches / decode state
# --------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      device) -> Dict:
    """Stacked per-super-block KV caches: leaves (nsb, B, ...)."""
    lead = (num_superblocks(cfg),)
    return {f"sub{i}": attn.init_kv_cache(cfg, batch, max_len, dtype, device,
                                          lead)
            for i, _ in enumerate(block_pattern(cfg))}


def init_paged_decode_state(cfg: ModelConfig, batch: int, pool_pages: int,
                            page_size: int, pages_per_slot_max: int, dtype,
                            device) -> Dict:
    """Paged variant of :func:`init_decode_state`: every KV cache becomes a
    :class:`~repro_torch.models.attention.PagedKVCache` over a per-layer
    ``pool_pages``-page pool (plus its scratch page)."""
    if cfg.attn_type == "mla":
        raise NotImplementedError(
            "paged serving does not support the MLA compressed cache yet; "
            "serve MLA models dense")
    lead = (num_superblocks(cfg),)
    return {f"sub{i}": attn.init_paged_kv_cache(
                cfg, batch, pool_pages, page_size, pages_per_slot_max, dtype,
                device, lead)
            for i, _ in enumerate(block_pattern(cfg))}


def _layer(cache, i: int):
    """Layer ``i``'s cache: views into the stacked tensors."""
    return type(cache)(*(t[i] for t in cache))


def _restack(cache, layers: List) -> Any:
    """The stacked state after a forward: k/v (pools, tables) were updated
    in place through the per-layer views, so only the lengths are new."""
    lengths = torch.stack([c.length for c in layers])
    return cache._replace(length=lengths)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _apply_sublayer(sub_p, cfg, par, kind, h, positions, cache, decode):
    """Returns (h, new_cache).  ``cache`` may be present in decode (one
    token) and in prefill (the whole prompt, filling the cache)."""
    hn = apply_rmsnorm(sub_p["attn_norm"], h, cfg.norm_eps)
    y, kv = attn.apply_gqa(sub_p["attn"], cfg, par, hn, positions,
                           cache=cache, decode=decode)
    h = h + y
    hm = apply_rmsnorm(sub_p["mlp_norm"], h, cfg.norm_eps)
    h = h + apply_mlp(sub_p["mlp"], hm, cfg.mlp_type)
    return h, kv


def forward(
    params: Dict,
    cfg: ModelConfig,
    par: ParallelConfig,
    tokens: torch.Tensor,            # (B, S) int
    *,
    positions: Optional[torch.Tensor] = None,
    decode_state: Optional[Dict] = None,
    decode: bool = False,
    return_hidden: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (logits, new_decode_state, aux_loss)."""
    pat = block_pattern(cfg)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device)
    h = embed_tokens(params["embed"], tokens, cfg.d_model)
    use_cache = decode_state is not None
    new_layers: Dict[str, List] = {f"sub{i}": [] for i in range(len(pat))}
    for layer in range(num_superblocks(cfg)):
        for i, kind in enumerate(pat):
            key = f"sub{i}"
            sub_p = {n: {w: t[layer] for w, t in leaf.items()}
                     for n, leaf in params["blocks"][key].items()}
            cache = _layer(decode_state[key], layer) if use_cache else None
            h, nc = _apply_sublayer(sub_p, cfg, par, kind, h, positions,
                                    cache, decode)
            if use_cache:
                new_layers[key].append(nc)
    new_state = ({key: _restack(decode_state[key], caches)
                  for key, caches in new_layers.items()}
                 if use_cache else None)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    h = apply_rmsnorm(params["final_norm"], h, cfg.norm_eps)
    if return_hidden:
        return h, new_state, aux
    return lm_logits(params["embed"], h), new_state, aux
