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

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init, mm
from repro_torch.sharding import collectives as C
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
    (rows) each rank attends with the query and KV heads its ``wo`` rows
    read (``sc``, :func:`head_split`); ``x`` is the stream (the rank's
    sequence block under the sequence split, gathered before the
    projections, so ``positions`` are the whole sequence's)."""
    hd = cfg.head_dim
    plan = head_split(sc, cfg.num_heads, cfg.num_kv_heads, hd)
    x = sc.gather_in(x, plan.split)
    b, s, _ = x.shape
    q, k, v = project_heads(p, x, x, plan, sc, hd)
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
    return sc.leave_out(attend_out(o, p, plan), plan.split), new_cache


class HeadSplit(NamedTuple):
    """What one model rank computes of an attention (:func:`head_split`):
    the query heads ``q`` and KV heads ``kv`` (``[start, stop)`` of the
    whole model's), whether the rank's product of ``wq`` (``gather_q``)
    and of ``wk`` / ``wv`` (``gather_kv``) is all-gathered over the model
    axis first because its columns cut through heads, whether a split
    of the others leaves ``wk`` / ``wv`` whole (``kv_whole``), the columns ``out`` of the heads'
    output ``(q heads x width)`` that the rank's ``wo`` rows read, and
    ``group``: each local query head's local KV head, None where it is
    ``j // (q heads / KV heads)`` (the kernels' grouped layout)."""
    q: Tuple[int, int]
    kv: Tuple[int, int]
    gather_q: bool
    gather_kv: bool
    kv_whole: bool
    out: Tuple[int, int]
    group: Optional[Tuple[int, ...]]
    split: bool


def head_split(sc: Scope, heads: int, kv_heads: int, width: int,
               names=("wq", "wk", "wv", "wo")) -> HeadSplit:
    """This model rank's share of an attention of ``heads`` query and
    ``kv_heads`` KV heads of ``width`` (the weights ``names``: query, key,
    value column-split, output row-split; the key and value may stay
    whole).  The rank's ``wo`` rows read the output columns of the query
    heads they cross; those heads and the KV heads they read are what it
    computes.  Where the rules' split cuts through heads (more ranks than
    KV heads: llama-3.2-vision-11b's 8 at tp=16; or a query block of 2.5
    heads: llama4-maverick's 40 at tp=16) the rank's products are
    all-gathered over the model axis and it takes its heads of the whole
    (the backward reduce-scatters: a head two ranks read gets both
    shares).  Any other split raises with the shapes."""
    dims = [sc.model_dim(n) for n in names]
    if all(d is None for d in dims):
        return HeadSplit((0, heads), (0, kv_heads), False, False, False,
                         (0, heads * width), None, False)
    if dims[0] != 1 or dims[3] != 0 or dims[1] not in (None, 1) or \
            dims[2] != dims[1]:
        raise ValueError(
            f"attention at {sc.prefix}: {names} of {heads} / {kv_heads} "
            f"heads of {width} split on dims {dims}: the query, key and "
            f"value weights split by columns, the output by rows")
    return split_heads(heads, kv_heads, width, sc.model.size,
                       sc.model.rank, dims[1] == 1)


def split_heads(heads: int, kv_heads: int, width: int, m: int, r: int,
                kv_split: bool) -> HeadSplit:
    """:func:`head_split` of rank ``r`` of ``m`` model ranks, the query
    and output weights split, the key and value ones where ``kv_split``
    (shapes only).  The gathers do not depend on the rank: the query
    product's columns cut through heads where ``m`` does not divide the
    query heads, the key / value product's where it does not divide the
    KV heads (dividing those, it divides the query heads and each rank's
    KV columns are the heads its query heads read)."""
    lo, hi = r * heads * width // m, (r + 1) * heads * width // m
    q0, q1 = lo // width, -(-hi // width)
    g = heads // kv_heads
    k0, k1 = q0 // g, (q1 - 1) // g + 1
    nq, nkv = q1 - q0, k1 - k0
    group = tuple((q0 + j) // g - k0 for j in range(nq))
    regular = nq % nkv == 0 and group == tuple(
        j // (nq // nkv) for j in range(nq))
    return HeadSplit((q0, q1), (k0, k1), heads % m != 0,
                     kv_split and kv_heads % m != 0, not kv_split,
                     (lo - q0 * width, hi - q0 * width),
                     None if regular else group, True)


def _take(y: torch.Tensor, sc: Scope, heads: Tuple[int, int],
          gather: bool, whole: bool, width: int) -> torch.Tensor:
    """Heads ``[start, stop)`` of a projection's product ``y`` (this
    rank's columns, or the whole weight's when ``whole``), all-gathered
    first when ``gather``: ``(..., heads, width)``."""
    if gather:
        y = C.gather(y, sc.model, -1, "reduce-scatter", grad_dtype=None)
    if gather or whole:
        y = y[..., heads[0] * width:heads[1] * width]
    return y.unflatten(-1, (-1, width))


def project_heads(p: Dict, x: torch.Tensor, src: torch.Tensor,
                  plan: HeadSplit, sc: Scope, width: int):
    """``q`` of ``x``, ``k`` / ``v`` of ``src`` at this rank's heads
    (``plan``); K/V repeated to one a query head where the local heads
    do not group."""
    q = _take(mm(x, p["wq"]), sc, plan.q, plan.gather_q, False, width)
    k, v = (_take(mm(src, p[w]), sc, plan.kv, plan.gather_kv,
                  plan.kv_whole, width) for w in ("wk", "wv"))
    if plan.group is not None:
        idx = torch.tensor(plan.group, device=k.device)
        k, v = k.index_select(-2, idx), v.index_select(-2, idx)
    return q, k, v


def attend_out(o: torch.Tensor, p: Dict, plan: HeadSplit) -> torch.Tensor:
    """The output projection of the heads' output ``o`` ``(B, S, heads,
    width)``: the columns this rank's ``wo`` rows read (the partial sum
    under a split)."""
    o = o.flatten(-2)
    if o.shape[-1] != plan.out[1] - plan.out[0]:
        o = o[..., plan.out[0]:plan.out[1]]
    return mm(o, p["wo"])


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


def cache_heads(sc: Scope, cfg: ModelConfig) -> int:
    """The KV heads a GQA cache holds on this model rank: those the rank's
    ``wo`` rows read (:func:`head_split`'s ``kv``), or one a local query
    head where they do not group (:func:`project_heads` repeats them).
    Where KV heads are fewer than the model ranks two ranks hold the same
    head."""
    plan = head_split(sc, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    if plan.group is not None:
        return plan.q[1] - plan.q[0]
    return plan.kv[1] - plan.kv[0]


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device,
                  lead: Tuple[int, ...] = (), sc: Scope = LOCAL) -> KVCache:
    """The dense cache of ``batch`` slots over ``max_len`` rows, at the
    rank's heads under a model split (``sc``: the attention's scope,
    :func:`cache_heads`)."""
    hd = cfg.head_dim
    if cfg.sliding_window > 0:
        # ring buffer: the cache never needs to exceed the attention window
        max_len = min(max_len, cfg.sliding_window)
    shape = lead + (batch, max_len, cache_heads(sc, cfg), hd)
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
    ``w_dq`` and ``w_dkv`` sum every head's share (and the gradient of
    ``x`` is complete on every rank: under the sequence split its gather
    takes the rank's slice back)."""
    x = sc.gather_in(x, False)
    b, s, _ = x.shape
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    plan = head_split(sc, cfg.num_heads, cfg.num_heads, dn + dr,
                      ("w_uq", "w_uk", "w_uv", "wo"))
    if plan.gather_q or plan.gather_kv:
        raise ValueError(f"MLA at {sc.prefix}: {cfg.num_heads} heads over "
                         f"{sc.model.size} model ranks: a split must give "
                         f"every rank whole heads")
    h, split = plan.q[1] - plan.q[0], plan.split
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
    return sc.leave_out(out, split), new_cache


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
                     x: torch.Tensor, kv_src: torch.Tensor,
                     sc: Scope = LOCAL) -> torch.Tensor:
    """x: (B, S, D), the stream; kv_src: (B, T, D_kv), which every model
    rank holds whole — no causal mask, no rope on K/V.  As in the
    reference there is no cross K/V cache: every call (every decode step)
    projects the whole ``kv_src``.  An fp32 ``kv_src`` (the stub
    frontends' inputs) gives fp32 K/V, as ``jnp.einsum`` promotes; the
    output takes ``x``'s dtype.  Under a model split of ``wq`` / ``wk`` /
    ``wv`` (columns) and ``wo`` (rows) each rank attends with its heads;
    a ``kv_src`` that needs a gradient (the encoder's output) must have
    entered the split (``sc.enter``) before."""
    plan = head_split(sc, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    x = sc.gather_in(x, plan.split)
    q, k, v = project_heads(p, x, kv_src, plan, sc, cfg.head_dim)
    o = ops.flash_attention(q, k, v, causal=False, q_block=par.attn_q_block,
                            kv_block=par.attn_kv_block)
    return sc.leave_out(attend_out(o, p, plan), plan.split)
