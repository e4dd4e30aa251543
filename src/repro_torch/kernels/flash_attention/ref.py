"""Plain PyTorch attention (GQA / causal / sliding window / softcap) — the
port of :mod:`repro.kernels.flash_attention.ref`, and the plain versions
beside the CUDA kernels in :mod:`.kernel`.

Layouts as in the reference: q (B, Sq, Hq, D); k/v (B, Skv, Hkv, D);
out (B, Sq, Hq, Dv).  Masked logits are set to -1e30, so a fully masked row
gets a uniform softmax here — the kernels (and the Pallas kernels they
replace) give 0 for such a row instead.  Decode never produces one: every
slot attends to at least its newest token.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sliding_window: int = 0,
    logit_softcap: float = 0.0,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_len: Optional[torch.Tensor] = None,  # (B,) valid kv length for decode
) -> torch.Tensor:
    """Grouped-query attention oracle. Returns (B, Sq, Hq, Dv)."""
    b, sq, hq, d = q.shape
    _, skv, hkv, dv = v.shape
    assert hq % hkv == 0, (hq, hkv)
    g = hq // hkv
    if scale is None:
        scale = d ** -0.5

    qf = q.to(torch.float32) * scale
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)

    qg = qf.reshape(b, sq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf)
    if logit_softcap > 0.0:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)

    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if sliding_window > 0:
        mask &= k_pos > q_pos - sliding_window
    mask_b = mask.expand(b, 1, 1, sq, skv)
    if kv_len is not None:
        valid = k_pos < kv_len[:, None]
        mask_b = mask_b & valid[:, None, None, None, :]
    logits = torch.where(mask_b, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, vf)
    return out.reshape(b, sq, hq, dv).to(q.dtype)


def attention_blockwise_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sliding_window: int = 0,
    logit_softcap: float = 0.0,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_block: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over kv blocks: mathematically
    :func:`attention_ref`, streamed like the kernel (the reference's
    ``lax.scan`` becomes a loop)."""
    b, sq, hq, d = q.shape
    _, skv, hkv, dv = v.shape
    g = hq // hkv
    if scale is None:
        scale = d ** -0.5
    kv_block = max(8, min(kv_block, skv))
    n_blocks = -(-skv // kv_block)

    qf = (q.to(torch.float32) * scale).reshape(b, sq, hkv, g, d)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, dv), dtype=torch.float32,
                      device=q.device)
    for blk in range(n_blocks):
        start = blk * kv_block
        kb = k[:, start:start + kv_block].to(torch.float32)
        vb = v[:, start:start + kv_block].to(torch.float32)
        pad = kv_block - kb.shape[1]
        if pad:
            kb = torch.nn.functional.pad(kb, (0, 0, 0, 0, 0, pad))
            vb = torch.nn.functional.pad(vb, (0, 0, 0, 0, 0, pad))
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kb)
        if logit_softcap > 0.0:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        k_pos = start + torch.arange(kv_block, device=q.device)
        mask = (k_pos[None, :] < skv).expand(sq, kv_block)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if sliding_window > 0:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - sliding_window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(mask, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vb)
        m = m_new
    denom = torch.where(l == 0.0, 1.0, l)
    out = (acc / denom[..., None]).permute(0, 3, 1, 2, 4)  # (b, sq, hkv, g, dv)
    return out.reshape(b, sq, hq, dv).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,          # (B, 1, Hq, D)
    k_cache: torch.Tensor,    # (B, Skv, Hkv, D)
    v_cache: torch.Tensor,    # (B, Skv, Hkv, Dv)
    cache_len: torch.Tensor,  # (B,) int — valid entries incl. the new one
    *,
    sliding_window: int = 0,
    logit_softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode attention over a (possibly ring) KV cache."""
    b, sq, hq, d = q.shape
    _, skv, hkv, dv = v_cache.shape
    g = hq // hkv
    if scale is None:
        scale = d ** -0.5
    qf = q.to(torch.float32) * scale
    qg = qf.reshape(b, sq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache.to(torch.float32))
    if logit_softcap > 0.0:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    k_pos = torch.arange(skv, device=q.device)[None, :]
    valid = k_pos < cache_len[:, None]
    if sliding_window > 0:
        valid &= k_pos >= (cache_len[:, None] - sliding_window)
    logits = torch.where(valid[:, None, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs,
                       v_cache.to(torch.float32))
    return out.reshape(b, sq, hq, dv).to(q.dtype)
