"""Whisper-style encoder-decoder backbone — the port of
:mod:`repro.models.encdec`.

As in the reference the conv / mel frontend is a stub: ``frames``
(B, T_enc, D) are precomputed frame embeddings, handed to the encoder
through the ``frame_proj`` adapter.  The encoder is bidirectional
self-attention (rope on q and k, non-causal ``ops.flash_attention``); the
decoder has causal self-attention with a KV cache, then cross-attention
over the encoder output (recomputed at every call, as in the reference),
then the MLP.

The layout is the reference's: ``enc_blocks`` / ``dec_blocks`` leaves
stacked on a leading layer axis, unbound and looped here where the
reference scans; the decode state is one
:class:`~repro_torch.models.attention.KVCache` whose leaves are stacked
over the decoder layers.  A forward with a cache writes the KV rows in
place and the new lengths into the stacked storage, as
:mod:`repro_torch.models.transformer` does.  The reference's ``remat`` is
dropped: the kernels' recompute backward (:mod:`repro_torch.kernels.ops`)
already keeps only their inputs, and the train step runs with
``remat="none"``.

Mixed dtypes follow jax's promotion (:func:`~repro_torch.models.layers.mm`):
fp32 ``frames`` in a bf16 model make the whole encoder, and the decoder's
cross K/V, fp32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_mlp, apply_rmsnorm, apply_rope, dense_init, embed_tokens,
    init_embed, init_mlp, init_rmsnorm, lm_logits, mm,
)
from repro_torch.models.transformer import _layer, _restack, _unstack
from repro_torch.utils.config import ModelConfig, ParallelConfig


def _init_enc_layer(gen, cfg: ModelConfig, dtype, device,
                    lead: Tuple[int, ...]) -> Dict:
    return {
        "attn_norm": init_rmsnorm(cfg.d_model, dtype, device, lead),
        "attn": attn.init_gqa(gen, cfg, dtype, device, lead),
        "mlp_norm": init_rmsnorm(cfg.d_model, dtype, device, lead),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype,
                        device, lead),
    }


def _init_dec_layer(gen, cfg: ModelConfig, dtype, device,
                    lead: Tuple[int, ...]) -> Dict:
    return {
        "attn_norm": init_rmsnorm(cfg.d_model, dtype, device, lead),
        "attn": attn.init_gqa(gen, cfg, dtype, device, lead),
        "cross_norm": init_rmsnorm(cfg.d_model, dtype, device, lead),
        "cross": attn.init_cross_attn(gen, cfg, cfg.d_model, dtype, device,
                                      lead),
        "mlp_norm": init_rmsnorm(cfg.d_model, dtype, device, lead),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype,
                        device, lead),
    }


def _encoder_layers(cfg: ModelConfig) -> int:
    return cfg.encoder_layers or cfg.num_layers


def init_encdec_params(cfg: ModelConfig, gen: Optional[torch.Generator],
                       dtype, device) -> Dict[str, Any]:
    """The reference's parameter tree (``init_encdec_params``), drawn from
    ``gen``; block leaves carry the leading layer axis."""
    return {
        "embed": init_embed(gen, cfg.vocab_size, cfg.d_model, dtype, device,
                            cfg.tie_embeddings),
        # the stub frontend's adapter
        "frame_proj": dense_init(gen, cfg.d_model, cfg.d_model, dtype,
                                 device),
        "enc_blocks": _init_enc_layer(gen, cfg, dtype, device,
                                      (_encoder_layers(cfg),)),
        "dec_blocks": _init_dec_layer(gen, cfg, dtype, device,
                                      (cfg.num_layers,)),
        "enc_norm": init_rmsnorm(cfg.d_model, dtype, device),
        "final_norm": init_rmsnorm(cfg.d_model, dtype, device),
    }


def encode(params: Dict, cfg: ModelConfig, par: ParallelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T_enc, D) precomputed frame embeddings (stub
    frontend) -> the encoder output (B, T_enc, D)."""
    h = mm(frames, params["frame_proj"])
    b, t, _ = h.shape
    hd = cfg.head_dim
    positions = torch.arange(t, device=h.device)
    for p in _unstack(params["enc_blocks"], _encoder_layers(cfg)):
        hn = apply_rmsnorm(p["attn_norm"], h, cfg.norm_eps)
        q = mm(hn, p["attn"]["wq"]).reshape(b, t, cfg.num_heads, hd)
        k = mm(hn, p["attn"]["wk"]).reshape(b, t, cfg.num_kv_heads, hd)
        v = mm(hn, p["attn"]["wv"]).reshape(b, t, cfg.num_kv_heads, hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        o = ops.flash_attention(q, k, v, causal=False,
                                q_block=par.attn_q_block,
                                kv_block=par.attn_kv_block)
        h = h + mm(o.reshape(b, t, -1), p["attn"]["wo"])
        hm = apply_rmsnorm(p["mlp_norm"], h, cfg.norm_eps)
        h = h + apply_mlp(p["mlp"], hm, cfg.mlp_type)
    return apply_rmsnorm(params["enc_norm"], h, cfg.norm_eps)


def decode_forward(
    params: Dict,
    cfg: ModelConfig,
    par: ParallelConfig,
    tokens: torch.Tensor,       # (B, S)
    enc_out: torch.Tensor,      # (B, T_enc, D)
    *,
    positions: Optional[torch.Tensor] = None,
    decode_state: Optional[attn.KVCache] = None,
    decode: bool = False,
) -> Tuple[torch.Tensor, Optional[attn.KVCache]]:
    """Returns (logits, new_decode_state).  With ``decode_state`` the
    self-attention caches are filled (prefill) or extended by one row
    (decode) in place, and the returned state holds the same tensors."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device)
    h = embed_tokens(params["embed"], tokens, cfg.d_model)
    use_cache = decode_state is not None
    caches = []
    for i, p in enumerate(_unstack(params["dec_blocks"], cfg.num_layers)):
        cache = _layer(decode_state, i) if use_cache else None
        hn = apply_rmsnorm(p["attn_norm"], h, cfg.norm_eps)
        y, kv = attn.apply_gqa(p["attn"], cfg, par, hn, positions,
                               cache=cache, decode=decode)
        h = h + y
        hc = apply_rmsnorm(p["cross_norm"], h, cfg.norm_eps)
        h = h + attn.apply_cross_attn(p["cross"], cfg, par, hc, enc_out)
        hm = apply_rmsnorm(p["mlp_norm"], h, cfg.norm_eps)
        h = h + apply_mlp(p["mlp"], hm, cfg.mlp_type)
        caches.append(kv)
    new_state = _restack(decode_state, caches) if use_cache else None
    h = apply_rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return lm_logits(params["embed"], h), new_state


def init_encdec_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                             dtype, device) -> attn.KVCache:
    """The decoder's self-attention caches, stacked: leaves (L, B, ...)."""
    return attn.init_kv_cache(cfg, batch, max_len, dtype, device,
                              lead=(cfg.num_layers,))
