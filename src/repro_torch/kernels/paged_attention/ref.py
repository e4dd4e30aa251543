"""Plain PyTorch paged decode attention — the port of
:mod:`repro.kernels.paged_attention.ref`, and the plain version beside the
CUDA kernel in :mod:`.kernel`.

K/V live in a shared pool of ``(pool_pages, page_size)`` rows; token ``t``
of slot ``b`` is in pool page ``page_table[b, t // page_size]`` at row
``t % page_size``.  The oracle gathers each slot's pages back into a
contiguous cache and runs the dense decode math, so with one full-size
page per slot and an identity table it is the dense path bit for bit.
Unused table entries must hold valid pool indices (the gather reads them;
``cache_len`` masks their rows).  No sliding window.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ref import decode_attention_ref


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """(P, ps, Hkv, D) pool + (B, n_pages) table -> (B, n_pages*ps, Hkv, D)."""
    b, n_pages = page_table.shape
    _, ps, hkv, d = pool.shape
    gathered = pool[page_table.long()]  # (B, n_pages, ps, Hkv, D)
    return gathered.reshape(b, n_pages * ps, hkv, d)


def paged_decode_attention_ref(
    q: torch.Tensor,           # (B, 1, Hq, D)
    k_pages: torch.Tensor,     # (P, page_size, Hkv, D) shared pool
    v_pages: torch.Tensor,     # (P, page_size, Hkv, Dv)
    page_table: torch.Tensor,  # (B, n_pages) int pool indices
    cache_len: torch.Tensor,   # (B,) int valid tokens (incl. the new one)
    *,
    logit_softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode attention over a block-paged KV pool."""
    k_cache = gather_pages(k_pages, page_table)
    v_cache = gather_pages(v_pages, page_table)
    return decode_attention_ref(
        q, k_cache, v_cache, cache_len,
        logit_softcap=logit_softcap, scale=scale)
