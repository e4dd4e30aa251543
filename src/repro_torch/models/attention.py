"""Grouped-query attention with dense, ring (sliding-window) and paged KV
caches — the GQA part of :mod:`repro.models.attention` (MLA and
cross-attention come in a later slice).

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

- dense decode writes through a one-hot (``_scatter_time``), so a write at
  an index >= the cache length writes nothing: the port masks the write;
- paged decode gathers ``page_table[b, length // page_size]``, and JAX
  clamps an out-of-range gather index: the port clamps the column, which
  lands on a parked slot's scratch page.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init
from repro_torch.utils.config import ModelConfig, ParallelConfig


class KVCache(NamedTuple):
    """Append cache. k/v: (B, S_max, H_kv, D); length: (B,) int32."""
    k: torch.Tensor
    v: torch.Tensor
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
):
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, hd)
    k = (x @ p["wk"]).reshape(b, s, cfg.num_kv_heads, hd)
    v = (x @ p["wv"]).reshape(b, s, cfg.num_kv_heads, hd)
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
    out = o.reshape(b, s, cfg.num_heads * hd) @ p["wo"]
    return out, new_cache


def _scatter_time_(cache: torch.Tensor, new: torch.Tensor,
                   idx: torch.Tensor) -> None:
    """In place: write ``new`` (B, 1, H, D) at per-slot time ``idx`` (B,).
    An index past the cache writes nothing, as the reference's one-hot
    write does; the row at the clamped index is rewritten with itself."""
    size = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    col = torch.clamp(idx, max=size - 1).long()
    keep = cache[rows, col]
    cache[rows, col] = torch.where((idx < size)[:, None, None], new[:, 0],
                                   keep)


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
