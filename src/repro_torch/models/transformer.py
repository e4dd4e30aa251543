"""Decoder-only LM: the dense, ssm (Mamba-1) and hybrid (Mamba-2 + one
shared attention block) families of :mod:`repro.models.transformer` (moe,
MLA and vlm come in later slices).

Parameters and decode state keep the reference's layout: super-block
weights stacked on a leading ``nsb`` axis under ``params["blocks"]``, and
per-super-block caches stacked the same way (the batcher's row scatter
relies on it).  Where the reference scans over the stacked axis with
``jax.lax.scan``, :func:`forward` unbinds it once and loops (the unbind's
backward stacks the layers' gradients in one allocation); each layer's
cache is a view into the stacked tensors, updated in place (see
:mod:`repro_torch.models.attention`).  The hybrid family's
``shared_attn`` block has one set of weights, applied in every
super-block, so its gradients add up over them.  This port runs on one
device, so the reference's activation sharding constraint and its
``remat`` policies are dropped (the train CLI's ``ParallelConfig()`` has
``remat="none"``).  Decode state for the SSM families comes with SSM
serving, in a later slice.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import ssm
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
    if cfg.family == "ssm":
        return ["mamba1"]
    if cfg.family == "hybrid":
        period = cfg.hybrid_attn_period or 6
        return ["mamba2"] * (period - 1) + ["mamba2_shared_attn"]
    if cfg.family != "dense" or cfg.is_moe or cfg.attn_type == "mla":
        raise NotImplementedError(
            f"{cfg.name}: only the dense GQA, ssm and hybrid families are "
            f"ported so far (family={cfg.family!r}, "
            f"attn_type={cfg.attn_type!r}, moe={cfg.is_moe})")
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
    if kind == "mamba1":
        return {"norm": init_rmsnorm(cfg.d_model, dtype, device, lead),
                "mixer": ssm.init_mamba1(gen, cfg, dtype, device, lead)}
    if kind in ("mamba2", "mamba2_shared_attn"):
        return {"norm": init_rmsnorm(cfg.d_model, dtype, device, lead),
                "mixer": ssm.init_mamba2(gen, cfg, dtype, device, lead)}
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
    params = {
        "embed": init_embed(gen, cfg.vocab_size, cfg.d_model, dtype, device,
                            cfg.tie_embeddings),
        "blocks": {f"sub{i}": _init_sublayer(gen, cfg, kind, dtype, device,
                                             lead)
                   for i, kind in enumerate(pat)},
        "final_norm": init_rmsnorm(cfg.d_model, dtype, device),
    }
    if cfg.family == "hybrid":
        params["shared_attn"] = {
            "norm": init_rmsnorm(cfg.d_model, dtype, device),
            "attn": attn.init_gqa(gen, cfg, dtype, device),
            "mlp_norm": init_rmsnorm(cfg.d_model, dtype, device),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype,
                            device),
        }
    return params


# --------------------------------------------------------------------------
# caches / decode state
# --------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      device) -> Dict:
    """Stacked per-super-block KV caches: leaves (nsb, B, ...)."""
    _require_attention_only(cfg)
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
    _require_attention_only(cfg)
    lead = (num_superblocks(cfg),)
    return {f"sub{i}": attn.init_paged_kv_cache(
                cfg, batch, pool_pages, page_size, pages_per_slot_max, dtype,
                device, lead)
            for i, _ in enumerate(block_pattern(cfg))}


def _require_attention_only(cfg: ModelConfig) -> None:
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: decode state for the SSM families (serving) is not "
            f"ported yet; this slice trains them")


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

def _apply_sublayer(sub_p, cfg, par, kind, h, positions, shared_p, cache,
                    decode):
    """Returns (h, new_cache).  ``cache`` may be present in decode (one
    token) and in prefill (the whole prompt, filling the cache); the SSM
    kinds run cacheless (training) only."""
    if kind == "mamba1":
        y, _ = ssm.apply_mamba1(sub_p["mixer"], cfg,
                                apply_rmsnorm(sub_p["norm"], h, cfg.norm_eps))
        return h + y, None
    if kind in ("mamba2", "mamba2_shared_attn"):
        y, _ = ssm.apply_mamba2(sub_p["mixer"], cfg,
                                apply_rmsnorm(sub_p["norm"], h, cfg.norm_eps))
        h = h + y
        if kind == "mamba2_shared_attn":
            y2, _ = attn.apply_gqa(
                shared_p["attn"], cfg, par,
                apply_rmsnorm(shared_p["norm"], h, cfg.norm_eps), positions)
            h = h + y2
            h = h + apply_mlp(
                shared_p["mlp"],
                apply_rmsnorm(shared_p["mlp_norm"], h, cfg.norm_eps),
                cfg.mlp_type)
        return h, None
    hn = apply_rmsnorm(sub_p["attn_norm"], h, cfg.norm_eps)
    y, kv = attn.apply_gqa(sub_p["attn"], cfg, par, hn, positions,
                           cache=cache, decode=decode)
    h = h + y
    hm = apply_rmsnorm(sub_p["mlp_norm"], h, cfg.norm_eps)
    h = h + apply_mlp(sub_p["mlp"], hm, cfg.mlp_type)
    return h, kv


def _unstack(tree: Dict, n: int) -> List[Dict]:
    """A tree of stacked leaves -> ``n`` trees of per-layer leaves."""
    out: List[Dict] = [{} for _ in range(n)]
    for key, val in tree.items():
        parts = (_unstack(val, n) if isinstance(val, dict)
                 else val.unbind(0))
        for i in range(n):
            out[i][key] = parts[i]
    return out


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
    nsb = num_superblocks(cfg)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device)
    h = embed_tokens(params["embed"], tokens, cfg.d_model)
    shared_p = params.get("shared_attn")
    use_cache = decode_state is not None
    if use_cache:
        _require_attention_only(cfg)
    layers = _unstack(params["blocks"], nsb)
    new_layers: Dict[str, List] = {f"sub{i}": [] for i in range(len(pat))}
    for layer in range(nsb):
        for i, kind in enumerate(pat):
            key = f"sub{i}"
            cache = _layer(decode_state[key], layer) if use_cache else None
            h, nc = _apply_sublayer(layers[layer][key], cfg, par, kind, h,
                                    positions, shared_p, cache, decode)
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
