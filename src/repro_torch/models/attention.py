"""Grouped-query attention with dense, ring (sliding-window) and paged KV
caches, DeepSeek's multi-head latent attention (MLA) with its compressed
cache, and the cross-attention of the vlm image layers and of the
encoder-decoder — the port of :mod:`repro.models.attention`.

The attention contraction dispatches to :mod:`repro_torch.kernels.ops`
(the CUDA kernels on the GPU, the plain versions on the CPU).

Caches are updated **in place** — the dense cache rows, the paged pool rows
and the prefill slice are written where they lie — instead of the
reference's functional copies; at llama3.2-1b that saves a full copy of
every layer's cache per decode step.  The returned cache records hold the
same (updated) tensors plus the new lengths.

Two index semantics of the reference are reproduced exactly, because JAX
never faults on an out-of-range index and PyTorch does (a device-side
assert on the GPU).  An empty batcher slot keeps decoding pad tokens and
its length grows every tick, so both cases occur in normal serving:

- dense decode (GQA and MLA) writes through a one-hot (``_scatter_time``),
  so a write at an index >= the cache length writes nothing: the port
  masks the write;
- paged decode gathers ``page_table[b, length // page_size]``, and JAX
  clamps an out-of-range gather index: the port clamps the column, which
  lands on a parked slot's scratch page.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init, mm
from repro_torch.sharding.layout import LOCAL, Scope
from repro_torch.utils.config import ModelConfig, ParallelConfig


class KVCache(NamedTuple):
    """Append cache. k/v: (B, S_max, H_kv, D); length: (B,) int32."""
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor


class MLACache(NamedTuple):
    """DeepSeek MLA compressed cache: latent c_kv + rope key."""
    c_kv: torch.Tensor  # (B, S_max, kv_lora_rank)
    k_pe: torch.Tensor  # (B, S_max, qk_rope_head_dim)
    length: torch.Tensor


class PagedKVCache(NamedTuple):
    """Block-paged KV cache over a shared page pool.

    ``k_pages``/``v_pages``: ``(P, page_size, H_kv, D)``, shared by every
    slot.  ``page_table``: ``(B, pages_per_slot_max)`` int32 — token ``t``
    of slot ``b`` lives at pool page ``page_table[b, t // page_size]``, row
    ``t % page_size``.  Unused entries hold valid pool indices.
    ``length``: ``(B,)`` int32.
    """
    k_pages: torch.Tensor
    v_pages: torch.Tensor
    page_table: torch.Tensor
    length: torch.Tensor


# --------------------------------------------------------------------------
# GQA
# --------------------------------------------------------------------------

def init_gqa(gen, cfg: ModelConfig, dtype, device,
             lead: Tuple[int, ...] = ()) -> Dict:
    hd = cfg.head_dim
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.num_heads * hd, dtype, device,
                         lead=lead),
        "wk": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype,
                         device, lead=lead),
        "wv": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype,
                         device, lead=lead),
        "wo": dense_init(gen, cfg.num_heads * hd, cfg.d_model, dtype, device,
                         lead=lead),
    }


def apply_gqa(
    p: Dict,
    cfg: ModelConfig,
    par: ParallelConfig,
    x: torch.Tensor,          # (B, S, D)
    positions: torch.Tensor,  # (S,) at prefill, (B, 1) at decode
    cache=None,
    decode: bool = False,
    sc: Scope = LOCAL,
):
    """Under a model split of ``wq`` / ``wk`` / ``wv`` (columns) and ``wo``
    (rows) each rank attends with its query and KV heads (``sc``)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    heads, kv_heads = _local_heads(
        sc, ("wq", "wk", "wv", "wo"),
        (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads, cfg.num_heads),
        hd)
    if heads != cfg.num_heads:
        x = sc.enter(x)
    q = (x @ p["wq"]).reshape(b, s, heads, hd)
    k = (x @ p["wk"]).reshape(b, s, kv_heads, hd)
    v = (x @ p["wv"]).reshape(b, s, kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if decode and isinstance(cache, PagedKVCache):
        assert s == 1
        if cfg.sliding_window > 0:
            raise NotImplementedError(
                "paged KV cache does not support sliding-window attention "
                "(the ring layout and the page layout disagree about where "
                "token t lives); serve sliding-window models dense")
        ps = cache.k_pages.shape[1]
        n_pages = cache.page_table.shape[1]
        rows = torch.arange(b, device=x.device)
        # JAX clamps the out-of-range column of an empty slot whose length
        # grew past its table: it lands on the slot's (scratch) last entry
        col = torch.clamp(cache.length // ps, max=n_pages - 1).long()
        page_ids = cache.page_table[rows, col].long()    # (B,)
        row_ids = (cache.length % ps).long()             # (B,)
        # in place: the new token's K/V go straight into the shared pool
        cache.k_pages[page_ids, row_ids] = k[:, 0]
        cache.v_pages[page_ids, row_ids] = v[:, 0]
        new_len = cache.length + 1
        o = ops.paged_decode_attention(
            q, cache.k_pages, cache.v_pages, cache.page_table, new_len,
            logit_softcap=cfg.attn_logit_softcap)
        new_cache = PagedKVCache(cache.k_pages, cache.v_pages,
                                 cache.page_table, new_len)
    elif decode:
        assert cache is not None and s == 1
        size = cache.k.shape[1]
        ring = cfg.sliding_window > 0 and size <= cfg.sliding_window
        idx = cache.length % size if ring else cache.length  # (B,)
        _scatter_time_(cache.k, k, idx)
        _scatter_time_(cache.v, v, idx)
        new_len = cache.length + 1
        # a ring cache holds exactly the window -> validity mask suffices;
        # the window mask is needed only when the cache outgrows the window
        attn_len = torch.clamp(new_len, max=size) if ring else new_len
        window = 0 if ring else cfg.sliding_window
        o = ops.decode_attention(
            q, cache.k, cache.v, attn_len,
            sliding_window=window, logit_softcap=cfg.attn_logit_softcap,
            kv_block=par.attn_kv_block)
        new_cache = KVCache(cache.k, cache.v, new_len)
    else:
        if isinstance(cache, PagedKVCache):
            # prefill runs dense (batch 1) and the batcher scatters the
            # filled rows into the slot's pages
            raise NotImplementedError(
                "prefill directly into a paged cache is not supported; "
                "prefill dense and scatter the rows into pages")
        o = ops.flash_attention(
            q, k, v, causal=True, sliding_window=cfg.sliding_window,
            logit_softcap=cfg.attn_logit_softcap,
            q_block=par.attn_q_block, kv_block=par.attn_kv_block)
        new_cache = None
        if cache is not None:  # prefill into the cache, in place
            size = cache.k.shape[1]
            if s <= size:
                cache.k[:, :s] = k
                cache.v[:, :s] = v
            else:
                # ring cache smaller than the prompt (sliding window): pack
                # the last `size` keys at their ring slots (pos % size)
                j = torch.arange(size, device=x.device)
                tok = s - size + ((j - s) % size)
                cache.k.copy_(k[:, tok])
                cache.v.copy_(v[:, tok])
            new_cache = KVCache(cache.k, cache.v, cache.length + s)
    out = o.reshape(b, s, heads * hd) @ p["wo"]
    return (sc.leave(out) if heads != cfg.num_heads else out), new_cache


def _local_heads(sc: Scope, names, heads, width: int):
    """The heads this model rank computes of each weight in ``names``
    (``heads[i]`` of ``width`` each; the last weight row-split, the others
    column-split): all of them when no weight is split, a 1/tp share of
    each when every one is.  A split that cuts through a head, or splits
    some of them only, raises with the shapes."""
    dims = [sc.model_dim(n) for n in names]
    if all(d is None for d in dims):
        return heads[0], heads[1]
    tp = sc.model.size
    want = [1] * (len(names) - 1) + [0]
    if dims != want or any(h % tp for h in heads):
        raise ValueError(
            f"attention at {sc.prefix}: {list(zip(names, heads))} heads of "
            f"{width} split on dims {dims} over {tp} model ranks: a split "
            f"must give every rank whole heads of every weight")
    return heads[0] // tp, heads[1] // tp


def _scatter_time_(cache: torch.Tensor, new: torch.Tensor,
                   idx: torch.Tensor) -> None:
    """In place: write ``new`` (B, 1, ...) at per-slot time ``idx`` (B,)
    of ``cache`` (B, S, ...).  An index past the cache writes nothing, as
    the reference's one-hot write does; the row at the clamped index is
    rewritten with itself."""
    size = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    col = torch.clamp(idx, max=size - 1).long()
    keep = cache[rows, col]
    inside = (idx < size).view((-1,) + (1,) * (keep.ndim - 1))
    cache[rows, col] = torch.where(inside, new[:, 0], keep)


def init_paged_kv_cache(cfg: ModelConfig, batch: int, pool_pages: int,
                        page_size: int, pages_per_slot_max: int, dtype,
                        device, lead: Tuple[int, ...] = ()) -> PagedKVCache:
    """Paged cache with ``pool_pages`` allocatable pages plus one *scratch*
    page (index ``pool_pages``).  Every table entry starts on the scratch
    page, and the scheduler points freed slots back at it: an empty slot's
    decode step still writes its pad-token K/V, so it must land on a page
    no live request owns."""
    hd = cfg.head_dim
    if cfg.sliding_window > 0:
        raise NotImplementedError(
            "paged KV cache does not support sliding-window attention")
    pool = lead + (pool_pages + 1, page_size, cfg.num_kv_heads, hd)
    return PagedKVCache(
        k_pages=torch.zeros(pool, dtype=dtype, device=device),
        v_pages=torch.zeros(pool, dtype=dtype, device=device),
        page_table=torch.full(lead + (batch, pages_per_slot_max), pool_pages,
                              dtype=torch.int32, device=device),
        length=torch.zeros(lead + (batch,), dtype=torch.int32, device=device),
    )


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device,
                  lead: Tuple[int, ...] = ()) -> KVCache:
    hd = cfg.head_dim
    if cfg.sliding_window > 0:
        # ring buffer: the cache never needs to exceed the attention window
        max_len = min(max_len, cfg.sliding_window)
    shape = lead + (batch, max_len, cfg.num_kv_heads, hd)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros(lead + (batch,), dtype=torch.int32, device=device),
    )


# --------------------------------------------------------------------------
# MLA (DeepSeek-V3 multi-head latent attention)
# --------------------------------------------------------------------------

def init_mla(gen, cfg: ModelConfig, dtype, device,
             lead: Tuple[int, ...] = ()) -> Dict:
    qk_dim = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    h = cfg.num_heads
    return {
        "w_dq": dense_init(gen, cfg.d_model, cfg.q_lora_rank, dtype, device,
                           lead=lead),
        "w_uq": dense_init(gen, cfg.q_lora_rank, h * qk_dim, dtype, device,
                           lead=lead),
        "w_dkv": dense_init(gen, cfg.d_model,
                            cfg.kv_lora_rank + cfg.qk_rope_head_dim, dtype,
                            device, lead=lead),
        "w_uk": dense_init(gen, cfg.kv_lora_rank, h * cfg.qk_nope_head_dim,
                           dtype, device, lead=lead),
        "w_uv": dense_init(gen, cfg.kv_lora_rank, h * cfg.v_head_dim, dtype,
                           device, lead=lead),
        "wo": dense_init(gen, h * cfg.v_head_dim, cfg.d_model, dtype, device,
                         lead=lead),
    }


def apply_mla(
    p: Dict,
    cfg: ModelConfig,
    par: ParallelConfig,
    x: torch.Tensor,          # (B, S, D)
    positions: torch.Tensor,  # (S,) at prefill, (B, 1) at decode
    cache=None,
    decode: bool = False,
    sc: Scope = LOCAL,
):
    """Prefill: the full keys and values are expanded from the latent and
    attended by ``ops.flash_attention`` with q/k of width ``dn + dr`` and
    v of width ``dv``; the latent and the rope key fill the cache from row
    0.  Decode: the reference's absorbed attention over the compressed
    cache (``q_nope . W_uk`` against ``c_kv``, ``q_pe`` against ``k_pe``,
    ``o_lat . W_uv``) in plain PyTorch, as the reference has no kernel for
    it; the new row is written in place.

    Under a model split of the head projections (``w_uq`` / ``w_uk`` /
    ``w_uv`` by head, ``wo`` by rows) each rank computes its heads from
    the latents every rank holds whole: ``c_q``, ``c_kv`` and the rope
    key enter the split heads through ``sc.enter``, so the gradients of
    ``w_dq`` and ``w_dkv`` sum every head's share."""
    b, s, _ = x.shape
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    h, _ = _local_heads(sc, ("w_uq", "w_uk", "w_uv", "wo"),
                        (cfg.num_heads,) * 4, dn + dr)
    split = h != cfg.num_heads
    enter = sc.enter if split else (lambda t: t)
    rank = cfg.kv_lora_rank

    q = (enter(x @ p["w_dq"]) @ p["w_uq"]).reshape(b, s, h, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)

    ckv_full = x @ p["w_dkv"]
    c_kv, k_pe_flat = (enter(ckv_full[..., :rank]),
                       enter(ckv_full[..., rank:]))
    k_pe = apply_rope(k_pe_flat[:, :, None, :], positions,
                      cfg.rope_theta)[:, :, 0, :]

    if decode:
        assert cache is not None and s == 1
        _scatter_time_(cache.c_kv, c_kv, cache.length)
        _scatter_time_(cache.k_pe, k_pe, cache.length)
        new_len = cache.length + 1
        # absorbed attention: score = q_nope^T W_uk c + q_pe^T k_pe
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope,
                             p["w_uk"].reshape(rank, h, dn))
        scale = (dn + dr) ** -0.5
        logits = (torch.einsum("bshr,btr->bhst", q_lat, cache.c_kv)
                  + torch.einsum("bshr,btr->bhst", q_pe, cache.k_pe)) * scale
        t_pos = torch.arange(cache.c_kv.shape[1], device=x.device)[None, :]
        valid = t_pos < new_len[:, None]
        logits = logits.masked_fill(~valid[:, None, None, :], -1e30)
        probs = torch.softmax(logits.to(torch.float32), dim=-1).to(x.dtype)
        o_lat = torch.einsum("bhst,btr->bshr", probs, cache.c_kv)
        o = torch.einsum("bshr,rhv->bshv", o_lat,
                         p["w_uv"].reshape(rank, h, dv))
        new_cache = MLACache(cache.c_kv, cache.k_pe, new_len)
    else:
        k_nope = (c_kv @ p["w_uk"]).reshape(b, s, h, dn)
        vfull = (c_kv @ p["w_uv"]).reshape(b, s, h, dv)
        k = torch.cat([k_nope, k_pe[:, :, None, :].expand(b, s, h, dr)], -1)
        q_cat = torch.cat([q_nope, q_pe], -1)
        o = ops.flash_attention(q_cat, k, vfull, causal=True,
                                q_block=par.attn_q_block,
                                kv_block=par.attn_kv_block)
        new_cache = None
        if cache is not None:  # prefill into the cache, in place
            cache.c_kv[:, :s] = c_kv
            cache.k_pe[:, :s] = k_pe
            new_cache = MLACache(cache.c_kv, cache.k_pe, cache.length + s)
    out = o.reshape(b, s, h * dv) @ p["wo"]
    return (sc.leave(out) if split else out), new_cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device, lead: Tuple[int, ...] = ()) -> MLACache:
    return MLACache(
        c_kv=torch.zeros(lead + (batch, max_len, cfg.kv_lora_rank),
                         dtype=dtype, device=device),
        k_pe=torch.zeros(lead + (batch, max_len, cfg.qk_rope_head_dim),
                         dtype=dtype, device=device),
        length=torch.zeros(lead + (batch,), dtype=torch.int32, device=device),
    )


# --------------------------------------------------------------------------
# Cross-attention (VLM image layers / enc-dec)
# --------------------------------------------------------------------------

def init_cross_attn(gen, cfg: ModelConfig, kv_dim: int, dtype, device,
                    lead: Tuple[int, ...] = ()) -> Dict:
    hd = cfg.head_dim
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.num_heads * hd, dtype, device,
                         lead=lead),
        "wk": dense_init(gen, kv_dim, cfg.num_kv_heads * hd, dtype, device,
                         lead=lead),
        "wv": dense_init(gen, kv_dim, cfg.num_kv_heads * hd, dtype, device,
                         lead=lead),
        "wo": dense_init(gen, cfg.num_heads * hd, cfg.d_model, dtype, device,
                         lead=lead),
    }


def apply_cross_attn(p: Dict, cfg: ModelConfig, par: ParallelConfig,
                     x: torch.Tensor, kv_src: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D); kv_src: (B, T, D_kv) — no causal mask, no rope on K/V.
    As in the reference there is no cross K/V cache: every call (every
    decode step) projects the whole ``kv_src``.  An fp32 ``kv_src`` (the
    stub frontends' inputs) gives fp32 K/V, as ``jnp.einsum`` promotes;
    the output takes ``x``'s dtype."""
    b, s, _ = x.shape
    t = kv_src.shape[1]
    hd = cfg.head_dim
    q = mm(x, p["wq"]).reshape(b, s, cfg.num_heads, hd)
    k = mm(kv_src, p["wk"]).reshape(b, t, cfg.num_kv_heads, hd)
    v = mm(kv_src, p["wv"]).reshape(b, t, cfg.num_kv_heads, hd)
    o = ops.flash_attention(q, k, v, causal=False, q_block=par.attn_q_block,
                            kv_block=par.attn_kv_block)
    return mm(o.reshape(b, s, cfg.num_heads * hd), p["wo"])
