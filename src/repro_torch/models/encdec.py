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
:mod:`repro_torch.models.transformer` does.  As the reference's
``_maybe_remat`` wraps its scanned bodies, each encoder layer, and each
decoder layer of a forward without a cache, runs under
``ParallelConfig.remat`` when gradients are taken
(:func:`repro_torch.models.transformer.remat`).

In a sharded train step both stacks take the layout's scopes
(``layout``): ``frame_proj`` is split by columns and its product
all-gathered back to the whole ``d_model`` (its gradient sliced back),
the encoder's and the decoder's attention run on the rank's heads, the
MLPs on its hidden columns, the cross-attention on its heads over an
encoder output that enters the split once for every decoder layer.  As in
the reference no activation of this family is constrained: ``sp`` does
not cut its sequence.

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
from repro_torch.models.transformer import (_layer, _restack, _unstack,
                                           remat)
from repro_torch.sharding import collectives
from repro_torch.sharding.layout import Scope
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
           frames: torch.Tensor, layout=None) -> torch.Tensor:
    """frames: (B, T_enc, D) precomputed frame embeddings (stub
    frontend) -> the encoder output (B, T_enc, D); ``layout`` as
    :func:`repro_torch.models.transformer.forward` takes it."""
    top = Scope(layout)
    # the stub input takes no gradient: nothing to sum where it enters
    h = mm(frames, params["frame_proj"])
    if top.model_dim("frame_proj") == 1:
        h = collectives.gather(h, top.model, -1, backward="slice")
    hd = cfg.head_dim
    positions = torch.arange(h.shape[1], device=h.device)
    # the train step gathers the stacks' FSDP blocks whole before this
    sc = Scope(layout, "enc_blocks/", scanned=True)
    plan = attn.head_split(sc["attn"], cfg.num_heads, cfg.num_kv_heads, hd)

    def layer(h, p):
        hn = sc["attn"].gather_in(
            apply_rmsnorm(p["attn_norm"], h, cfg.norm_eps), plan.split)
        q, k, v = attn.project_heads(p["attn"], hn, hn, plan, sc["attn"], hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        o = ops.flash_attention(q, k, v, causal=False,
                                q_block=par.attn_q_block,
                                kv_block=par.attn_kv_block)
        h = h + sc["attn"].leave_out(attn.attend_out(o, p["attn"], plan),
                                     plan.split)
        hm = apply_rmsnorm(p["mlp_norm"], h, cfg.norm_eps)
        return h + apply_mlp(p["mlp"], hm, cfg.mlp_type, sc["mlp"])

    body = remat(layer, par)
    for p in _unstack(params["enc_blocks"], _encoder_layers(cfg)):
        h = body(h, p)
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
    layout=None,
    last: bool = False,
) -> Tuple[torch.Tensor, Optional[attn.KVCache]]:
    """Returns (logits, new_decode_state).  With ``decode_state`` the
    self-attention caches are filled (prefill) or extended by one row
    (decode) in place, and the returned state holds the same tensors;
    ``layout`` as :func:`encode` takes it; ``last``: the last position's
    logits only."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device)
    top = Scope(layout)
    sc = Scope(layout, "dec_blocks/", scanned=True)
    h = embed_tokens(params["embed"], tokens, cfg.d_model, top["embed"])
    if sc["cross"].model_dim("wk") == 1:
        # every layer's cross K/V projections are column-split: their
        # partial input gradients are summed once
        enc_out = top.enter(enc_out)
    use_cache = decode_state is not None

    def layer(h, p, cache):
        hn = apply_rmsnorm(p["attn_norm"], h, cfg.norm_eps)
        y, kv = attn.apply_gqa(p["attn"], cfg, par, hn, positions,
                               cache=cache, decode=decode, sc=sc["attn"])
        h = h + y
        hc = apply_rmsnorm(p["cross_norm"], h, cfg.norm_eps)
        h = h + attn.apply_cross_attn(p["cross"], cfg, par, hc, enc_out,
                                      sc["cross"])
        hm = apply_rmsnorm(p["mlp_norm"], h, cfg.norm_eps)
        return h + apply_mlp(p["mlp"], hm, cfg.mlp_type, sc["mlp"]), kv

    body = remat(layer, par, not use_cache)
    caches = []
    for i, p in enumerate(_unstack(params["dec_blocks"], cfg.num_layers)):
        h, kv = body(h, p, _layer(decode_state, i) if use_cache else None)
        caches.append(kv)
    new_state = _restack(decode_state, caches) if use_cache else None
    h = apply_rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return lm_logits(params["embed"], h, top["embed"], last), new_state


def init_encdec_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                             dtype, device, layout=None) -> attn.KVCache:
    """The decoder's self-attention caches, stacked: leaves (L, B, ...),
    at the rank's KV heads on a ``layout``."""
    return attn.init_kv_cache(cfg, batch, max_len, dtype, device,
                              lead=(cfg.num_layers,),
                              sc=Scope(layout, "dec_blocks/", True)["attn"])
