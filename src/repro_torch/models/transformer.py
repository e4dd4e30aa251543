"""Decoder-only LM: the dense (GQA or MLA attention), moe, ssm (Mamba-1),
hybrid (Mamba-2 + one shared attention block) and vlm (dense layers with
a gated cross-attention image layer every ``cross_attn_period``-th) families
of :mod:`repro.models.transformer`, with deepseek's multi-token-prediction
head.  The audio encoder-decoder is :mod:`repro_torch.models.encdec`.

Parameters and decode state keep the reference's layout: super-block
weights stacked on a leading ``nsb`` axis under ``params["blocks"]``, and
per-super-block caches stacked the same way (the batcher's row scatter
relies on it).  Where the reference scans over the stacked axis with
``jax.lax.scan``, :func:`forward` unbinds it once and loops (the unbind's
backward stacks the layers' gradients in one allocation); each layer's
cache is a view into the stacked tensors, updated in place (see
:mod:`repro_torch.models.attention`).  The hybrid family's
``shared_attn`` block has one set of weights, applied in every
super-block, so its gradients add up over them.  In a sharded train
step the forward executes the reference's activation sharding constraint
(:func:`~repro_torch.sharding.specs.activation_sharding`: under ``sp``
the stream between sublayers is the rank's sequence block).  As the
reference checkpoints its scanned layer body, a forward that takes
gradients without a cache runs each super-block under
``ParallelConfig.remat`` (:func:`remat`): ``"full"`` keeps only the
super-block's input for the backward, ``"dots"`` also the outputs of its
products without batch dims; the rest, the attention and the kernels
among it, is recomputed in the backward, with the layer slice's FSDP
gather.

Decode state follows the reference's trees: a KV cache for a dense,
cross or moe layer (an :class:`~repro_torch.models.attention.MLACache`
with MLA attention), a :class:`~repro_torch.models.ssm.MambaState` for a
Mamba-1 layer,
``{"mixer": MambaState}`` for a Mamba-2 layer and ``{"mixer": MambaState,
"shared_kv": KV cache}`` for the hybrid's shared-attention layer, every
leaf stacked over the super-blocks.  A forward with a cache updates those
stacked tensors in place and returns a tree over the same tensors: the KV
rows are written where they lie, and the new lengths and the recurrent
states a layer returns are written back into the stacked storage
(:func:`_restack`), so a step captured in a CUDA graph keeps writing where
the caller's state lies.  :func:`forward` returns the sum of the MoE
layers' load-balance losses as its aux (a zero without MoE layers).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.layers import (
    apply_mlp, apply_rmsnorm, embed_tokens, init_embed, init_mlp,
    init_rmsnorm, lm_logits,
)
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.sharding.layout import LOCAL, Scope
from repro_torch.sharding.specs import activation_sharding
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
    if cfg.family == "vlm":
        period = cfg.cross_attn_period or 5
        return ["dense"] * (period - 1) + ["cross"]
    if cfg.is_moe:
        if cfg.moe_layer_period > 1:
            return ["dense"] * (cfg.moe_layer_period - 1) + ["moe"]
        return ["moe"]
    return ["dense"]


def num_superblocks(cfg: ModelConfig) -> int:
    pat = len(block_pattern(cfg))
    assert cfg.num_layers % pat == 0, (cfg.num_layers, pat)
    return cfg.num_layers // pat


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _init_sublayer(gen, cfg: ModelConfig, kind: str, dtype, device,
                   lead: Tuple[int, ...] = ()) -> Dict:
    if kind == "mamba1":
        return {"norm": init_rmsnorm(cfg.d_model, dtype, device, lead),
                "mixer": ssm.init_mamba1(gen, cfg, dtype, device, lead)}
    if kind in ("mamba2", "mamba2_shared_attn"):
        return {"norm": init_rmsnorm(cfg.d_model, dtype, device, lead),
                "mixer": ssm.init_mamba2(gen, cfg, dtype, device, lead)}
    init_attn = attn.init_mla if cfg.attn_type == "mla" else attn.init_gqa
    p = {
        "attn_norm": init_rmsnorm(cfg.d_model, dtype, device, lead),
        "attn": init_attn(gen, cfg, dtype, device, lead),
        "mlp_norm": init_rmsnorm(cfg.d_model, dtype, device, lead),
    }
    if kind == "moe":
        p["moe"] = init_moe(gen, cfg, dtype, device, lead)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype,
                            device, lead)
    if kind == "cross":
        p["cross_norm"] = init_rmsnorm(cfg.d_model, dtype, device, lead)
        p["cross"] = attn.init_cross_attn(
            gen, cfg, cfg.vision_dim or cfg.d_model, dtype, device, lead)
        # gated cross-attention (llama3.2-vision): tanh(0) closes the gate
        p["cross_gate"] = torch.zeros(lead, dtype=dtype, device=device)
    return p


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
    if cfg.mtp_depth > 0:
        d2 = 2 * cfg.d_model
        params["mtp"] = {
            "proj": _normal((d2, cfg.d_model), gen, dtype, device,
                            d2 ** -0.5),
            "block": _init_sublayer(gen, cfg,
                                    "moe" if cfg.is_moe else "dense", dtype,
                                    device),
            "norm": init_rmsnorm(cfg.d_model, dtype, device),
        }
    return params


def _normal(shape: Tuple[int, ...], gen, dtype, device,
            scale: float) -> torch.Tensor:
    """A standard normal draw cast to ``dtype``, then scaled in ``dtype``
    (the reference's MTP projection)."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return t.to(dtype) * scale


# --------------------------------------------------------------------------
# caches / decode state
# --------------------------------------------------------------------------

def _init_sub_state(cfg: ModelConfig, kind: str, batch: int, kv_cache,
                    dtype, device, lead: Tuple[int, ...],
                    sc: Scope = LOCAL, shared_sc: Scope = LOCAL):
    """One sub-layer's decode state; ``kv_cache(scope)`` makes the KV cache
    of the attention at ``scope`` (``sc``: the sublayer's, ``shared_sc``:
    the hybrid's shared block's)."""
    if kind == "mamba1":
        return ssm.init_mamba1_state(cfg, batch, dtype, device, lead,
                                     sc["mixer"])
    if kind in ("mamba2", "mamba2_shared_attn"):
        st = {"mixer": ssm.init_mamba2_state(cfg, batch, dtype, device, lead,
                                             sc["mixer"])}
        if kind == "mamba2_shared_attn":
            st["shared_kv"] = kv_cache(shared_sc["attn"])
        return st
    return kv_cache(sc["attn"])


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      device, layout=None) -> Dict:
    """Stacked per-super-block decode state: leaves (nsb, B, ...).  On a
    ``layout`` (a sharded serve step's) each leaf is what the rank holds:
    a GQA cache at its KV heads, a Mamba-1 state at its channels, a
    Mamba-2 state at its heads; MLA's latent cache is whole (the latents
    enter the split whole)."""
    lead = (num_superblocks(cfg),)

    def kv_cache(sc):
        if cfg.attn_type == "mla":
            return attn.init_mla_cache(cfg, batch, max_len, dtype, device,
                                       lead)
        return attn.init_kv_cache(cfg, batch, max_len, dtype, device, lead,
                                  sc)
    return {f"sub{i}": _init_sub_state(
        cfg, kind, batch, kv_cache, dtype, device, lead,
        Scope(layout, f"blocks/sub{i}/", True), Scope(layout)["shared_attn"])
        for i, kind in enumerate(block_pattern(cfg))}


def init_paged_decode_state(cfg: ModelConfig, batch: int, pool_pages: int,
                            page_size: int, pages_per_slot_max: int, dtype,
                            device) -> Dict:
    """Paged variant of :func:`init_decode_state`: every KV cache becomes a
    :class:`~repro_torch.models.attention.PagedKVCache` over a per-layer
    ``pool_pages``-page pool (plus its scratch page); recurrent states
    (O(1) a slot) are as in the dense state."""
    if cfg.attn_type == "mla":
        raise NotImplementedError(
            "paged serving does not support the MLA compressed cache yet; "
            "serve MLA models dense")
    lead = (num_superblocks(cfg),)

    def kv_cache(sc):
        return attn.init_paged_kv_cache(cfg, batch, pool_pages, page_size,
                                        pages_per_slot_max, dtype, device,
                                        lead)
    return {f"sub{i}": _init_sub_state(cfg, kind, batch, kv_cache, dtype,
                                       device, lead)
            for i, kind in enumerate(block_pattern(cfg))}


def _layer(cache, i: int):
    """Layer ``i``'s cache: views into the stacked tensors."""
    if isinstance(cache, dict):
        return {k: _layer(v, i) for k, v in cache.items()}
    return type(cache)(*(t[i] for t in cache))


def _restack(cache, layers: List) -> Any:
    """The stacked state after a forward, over the same tensors.  KV rows
    (pools, tables) were written in place through the per-layer views; the
    layers' new lengths and recurrent states are stacked into the state's
    own storage."""
    if isinstance(cache, dict):
        return {k: _restack(v, [c[k] for c in layers])
                for k, v in cache.items()}
    if isinstance(cache, ssm.MambaState):
        for stacked, new in zip(cache, zip(*layers)):
            torch.stack(new, out=stacked)
        return cache
    torch.stack([c.length for c in layers], out=cache.length)
    return cache


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _apply_sublayer(sub_p, cfg, par, kind, h, positions, shared_p,
                    vision_kv, cache, decode, sc: Scope = LOCAL,
                    shared_sc: Scope = LOCAL):
    """Returns (h, new_cache, aux): aux is a MoE layer's load-balance loss,
    None for the other kinds (``sc``: the sublayer's scope, whose data
    ranks its statistics are averaged over; ``shared_sc``: the hybrid's
    shared block's).  ``cache`` may be present in decode (one
    token, the recurrent step) and in prefill (the whole prompt, filling
    the KV cache and computing the final recurrent state).  A ``cross``
    sublayer attends over ``vision_kv`` between its self-attention and its
    MLP, every call (its cache is the self-attention's)."""
    use_cache = cache is not None
    if kind == "mamba1":
        y, st = ssm.apply_mamba1(sub_p["mixer"], cfg,
                                 apply_rmsnorm(sub_p["norm"], h, cfg.norm_eps),
                                 state=cache if decode else None,
                                 decode=decode,
                                 return_state=use_cache and not decode,
                                 sc=sc["mixer"])
        return h + y, st, None
    if kind in ("mamba2", "mamba2_shared_attn"):
        y, st = ssm.apply_mamba2(sub_p["mixer"], cfg,
                                 apply_rmsnorm(sub_p["norm"], h, cfg.norm_eps),
                                 state=cache["mixer"] if decode else None,
                                 decode=decode,
                                 return_state=use_cache and not decode,
                                 sc=sc["mixer"])
        h = h + y
        new_cache = {"mixer": st} if use_cache else None
        if kind == "mamba2_shared_attn":
            y2, kv = attn.apply_gqa(
                shared_p["attn"], cfg, par,
                apply_rmsnorm(shared_p["norm"], h, cfg.norm_eps), positions,
                cache=cache["shared_kv"] if use_cache else None,
                decode=decode, sc=shared_sc["attn"])
            h = h + y2
            h = h + apply_mlp(
                shared_p["mlp"],
                apply_rmsnorm(shared_p["mlp_norm"], h, cfg.norm_eps),
                cfg.mlp_type, shared_sc["mlp"])
            if use_cache:
                new_cache["shared_kv"] = kv
        return h, new_cache, None
    # attention (GQA | MLA) [+ cross] + (mlp | moe)
    hn = apply_rmsnorm(sub_p["attn_norm"], h, cfg.norm_eps)
    apply_attn = attn.apply_mla if cfg.attn_type == "mla" else attn.apply_gqa
    y, kv = apply_attn(sub_p["attn"], cfg, par, hn, positions, cache=cache,
                       decode=decode, sc=sc["attn"])
    h = h + y
    if kind == "cross":
        hc = apply_rmsnorm(sub_p["cross_norm"], h, cfg.norm_eps)
        yc = attn.apply_cross_attn(sub_p["cross"], cfg, par, hc, vision_kv,
                                   sc["cross"])
        h = h + gated(sub_p["cross_gate"], yc)
    hm = apply_rmsnorm(sub_p["mlp_norm"], h, cfg.norm_eps)
    aux = None
    if kind == "moe":
        # dropless at decode: dropping a token would corrupt a live request
        y, aux = apply_moe(sub_p["moe"], cfg, hm, router_mode=cfg.moe_router,
                           group_size=par.moe_group_size, dropless=decode,
                           sc=sc["moe"])
        h = h + y
    else:
        h = h + apply_mlp(sub_p["mlp"], hm, cfg.mlp_type, sc["mlp"])
    return h, kv, aux


def gated(gate: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The vlm cross sublayer's output ``tanh(gate) * y``, its own function
    so that a check can hook the product (``chip_smoke.py`` bounds the
    gate's gradient by the sum of its products' magnitudes)."""
    return torch.tanh(gate) * y


def _unstack(tree: Dict, n: int) -> List[Dict]:
    """A tree of stacked leaves -> ``n`` trees of per-layer leaves."""
    out: List[Dict] = [{} for _ in range(n)]
    for key, val in tree.items():
        parts = (_unstack(val, n) if isinstance(val, dict)
                 else val.unbind(0))
        for i in range(n):
            out[i][key] = parts[i]
    return out


def _no_batch_product(func, args) -> bool:
    """Whether an aten op is a product without batch dims, the outputs
    jax's ``checkpoint_dots_with_no_batch_dims`` saves: ``mm`` / ``addmm``
    (``x @ W``, a 3-D ``x`` folded into rows), or a ``bmm`` whose batch is
    one (``torch.einsum`` of a product without batch dims) or broadcast
    (``matmul`` of a 3-D input by an expanded 2-D weight).  A batched
    einsum over a batch of one (a MoE layer's single routing group)
    reaches the same ``bmm`` and is saved, where the reference
    recomputes it."""
    name = func.overloadpacket.__name__
    if name in ("mm", "addmm"):
        return True
    if name == "bmm":
        a, b = args
        return a.shape[0] == 1 or a.stride(0) == 0 or b.stride(0) == 0
    return False


def _save_dots(ctx, func, *args, **kwargs) -> CheckpointPolicy:
    """The ``"dots"`` policy: save the products without batch dims,
    recompute the rest (attention and the kernels among it)."""
    if _no_batch_product(func, args):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(body: Callable, par: ParallelConfig, active: bool = True
          ) -> Callable:
    """``body`` under the reference's ``remat`` policy (``jax.checkpoint``
    of a layer body): with ``par.remat`` ``"full"`` the backward keeps
    only the body's inputs and recomputes the rest, with ``"dots"`` it
    also keeps the outputs of the products without batch dims
    (:func:`_save_dots`).  The body itself when ``remat`` is ``"none"``,
    when not ``active`` (a forward with a cache) or when no gradient is
    taken.  A recompute runs the body's collectives again (an FSDP layer
    slice is gathered again) and launches its kernels again."""
    if par.remat not in ("none", "dots", "full"):
        raise ValueError(f"unknown remat policy {par.remat!r}")
    if par.remat == "none" or not active or not torch.is_grad_enabled():
        return body
    context = (functools.partial(create_selective_checkpoint_contexts,
                                 _save_dots)
               if par.remat == "dots" else noop_context_fn)

    def run(*args):
        # the bodies draw no random numbers
        return checkpoint(body, *args, use_reentrant=False,
                          context_fn=context, preserve_rng_state=False)
    return run


def forward(
    params: Dict,
    cfg: ModelConfig,
    par: ParallelConfig,
    tokens: torch.Tensor,            # (B, S) int
    *,
    positions: Optional[torch.Tensor] = None,
    vision_embeds: Optional[torch.Tensor] = None,  # (B, T, D_v) for vlm
    decode_state: Optional[Dict] = None,
    decode: bool = False,
    return_hidden: bool = False,
    layout=None,
    last: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (logits, new_decode_state, aux_loss); with ``last`` the
    logits of the last position only (:func:`~repro_torch.models.layers.
    lm_logits`).

    ``layout``: the :class:`~repro_torch.sharding.layout.Layout` a
    sharded train step executes on, ``params`` this rank's blocks with
    every leaf but the stacked ``blocks/`` ones already gathered over
    FSDP (:meth:`Layout.gather`; the layers' slices are gathered here).
    The activations are held to
    :func:`~repro_torch.sharding.specs.activation_sharding` where the
    reference constrains them (under ``sp`` the stream is the rank's
    sequence block from the embedding to the final norm, and the hidden
    state ``return_hidden`` gives is that block), and the MoE statistics
    are averaged over its data ranks.  Without a cache and with gradients
    each super-block (its FSDP gathers included) runs under
    :func:`remat`."""
    pat = block_pattern(cfg)
    nsb = num_superblocks(cfg)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device)
    top = Scope.top(layout, s)
    blocks = 1 if top.seq is None else top.seq.size
    h = embed_tokens(params["embed"], tokens, cfg.d_model, top["embed"])
    if layout is not None:
        h = activation_sharding(h, par, layout.mesh, s, blocks)
    shared_p = params.get("shared_attn")
    use_cache = decode_state is not None

    def superblock(h, block_p, block_cache):
        """One super-block: (h, its sublayers' new caches, its aux)."""
        new_caches, aux = {}, None
        for i, kind in enumerate(pat):
            key = f"sub{i}"
            sub_p = block_p[key]
            if layout is not None:
                sub_p = layout.gather(sub_p, f"blocks/{key}/")
            h, nc, a = _apply_sublayer(
                sub_p, cfg, par, kind, h, positions, shared_p, vision_embeds,
                block_cache[key] if use_cache else None, decode,
                Scope(layout, f"blocks/{key}/", True, top.seq),
                top["shared_attn"])
            if layout is not None:
                h = activation_sharding(h, par, layout.mesh, s, blocks)
            new_caches[key] = nc
            if a is not None:
                aux = a if aux is None else aux + a
        return h, new_caches, aux

    body = remat(superblock, par, not use_cache)
    new_layers: Dict[str, List] = {f"sub{i}": [] for i in range(len(pat))}
    aux = None
    for layer, block_p in enumerate(_unstack(params["blocks"], nsb)):
        block_cache = ({key: _layer(c, layer) for key, c in
                        decode_state.items()} if use_cache else None)
        h, new_caches, a = body(h, block_p, block_cache)
        if use_cache:
            for key, nc in new_caches.items():
                new_layers[key].append(nc)
        if a is not None:
            aux = a if aux is None else aux + a
    new_state = ({key: _restack(decode_state[key], caches)
                  for key, caches in new_layers.items()}
                 if use_cache else None)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    h = apply_rmsnorm(params["final_norm"], h, cfg.norm_eps)
    if return_hidden:
        return h, new_state, aux
    return lm_logits(params["embed"], h, top["embed"], last), new_state, aux


# --------------------------------------------------------------------------
# MTP head (deepseek multi-token prediction)
# --------------------------------------------------------------------------

def mtp_logits(params: Dict, cfg: ModelConfig, par: ParallelConfig,
               h: torch.Tensor, tokens: torch.Tensor,
               positions: torch.Tensor, layout=None) -> torch.Tensor:
    """Predict token t+2 from hidden t combined with the embedding of token
    t+1 (``tokens``); ``h`` and ``layout`` as :func:`forward` gives and
    takes them.  Under the sequence split the head runs on the whole
    sequence, gathered first (its loss shifts across the blocks'
    boundaries; every model rank's gradient of the gathered ``h`` is
    complete, so its backward takes the rank's block).  ``mtp/proj`` is
    column-split over the model axis by the rules, so under a split its
    product is all-gathered back to the whole ``d_model``."""
    from repro_torch.sharding import collectives

    h = collectives.gather(h, Scope.top(layout, tokens.shape[1]).seq, 1,
                           "slice")
    top = Scope(layout)
    mtp = params["mtp"]
    emb_next = embed_tokens(params["embed"], tokens, cfg.d_model,
                            top["embed"])
    x = torch.cat([h, emb_next], dim=-1)
    if top["mtp"].model_dim("proj") == 1:
        sc = top["mtp"]
        hh = collectives.gather(sc.enter(x) @ mtp["proj"], sc.model, -1,
                                backward="slice")
    else:
        hh = x @ mtp["proj"]
    kind = "moe" if "moe" in mtp["block"] else "dense"
    hh, _, _ = _apply_sublayer(mtp["block"], cfg, par, kind, hh, positions,
                               None, None, None, False, top["mtp"]["block"])
    hh = apply_rmsnorm(mtp["norm"], hh, cfg.norm_eps)
    return lm_logits(params["embed"], hh, top["embed"])
