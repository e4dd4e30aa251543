"""CUDA paged decode attention wrapper (kernel:
``repro_torch/csrc/paged_attention.cu``).

Replaces the TPU kernel
``repro/kernels/paged_attention/kernel.py::paged_decode_attention_pallas``
(``_paged_decode_kernel``).  Bound by bytes, like dense decode.  The kernel
is the dense decode kernel's body with each K/V row fetched through the
slot's page table, which the block reads itself (the TPU kernel took it by
scalar prefetch); pages at or past a slot's length are never dereferenced.
It streams :data:`KV_TILE` rows per step — the dense kernel's default
``flash_attention.kv_block`` — so paged and dense decode run the same
arithmetic in the same order and agree bit for bit on the same rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.paged_attention.ref import paged_decode_attention_ref

#: K/V rows staged in shared memory per step
KV_TILE = 64


def paged_decode_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor, page_table: torch.Tensor,
                                cache_len: torch.Tensor, *,
                                logit_softcap: float = 0.0,
                                scale: Optional[float] = None) -> torch.Tensor:
    """q (B, 1, Hq, D) over pools (P, page_size, Hkv, D) through the table
    (B, n_pages) with per-slot lengths (B,) -> (B, 1, Hq, D).  A CPU tensor
    takes the plain version."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(
            q, k_pages, v_pages, page_table, cache_len,
            logit_softcap=logit_softcap, scale=scale)
    table = cuda_lib.as_int32(page_table)
    lens = cuda_lib.as_int32(cache_len)
    cuda_lib.require("paged_decode_attention", q, k_pages, v_pages,
                     dtype=q.dtype)
    cuda_lib.require("paged_decode_attention", q, table, lens)
    b, sq, hq, d = q.shape
    _, page_size, hkv, dv = v_pages.shape
    if sq != 1 or k_pages.shape != v_pages.shape or dv != d or hq % hkv \
            or table.shape[0] != b or lens.shape != (b,):
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)}, pool "
                         f"{tuple(k_pages.shape)}, table {tuple(table.shape)},"
                         f" lens {tuple(lens.shape)}")
    if scale is None:
        scale = d ** -0.5
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    err = cuda_lib.library().repro_paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), table.data_ptr(),
        lens.data_ptr(), o.data_ptr(), b, page_size, table.shape[1], hq, hkv,
        d, float(logit_softcap), float(scale), KV_TILE,
        cuda_lib.dtype_code(q), cuda_lib.stream_of(q))
    cuda_lib.check(err, "paged_decode_attention")
    cuda_lib.LAUNCHES["paged_decode_attention"] += 1
    return o
