"""CUDA paged decode attention wrapper (kernel:
``repro_torch/csrc/paged_attention.cu``).

Replaces the TPU kernel
``repro/kernels/paged_attention/kernel.py::paged_decode_attention_pallas``
(``_paged_decode_kernel``).  Bound by bytes, like dense decode.  The kernel
is the dense decode kernel's body with each K/V row fetched through the
slot's page table, which the block reads itself (the TPU kernel took it by
scalar prefetch); pages at or past a slot's length are never dereferenced.
It streams :data:`KV_TILE` rows per step — the dense kernel's default
``flash_attention.kv_block`` — and splits the KV axis by the same plan as
dense decode (``plan_decode_splits`` in
:mod:`repro_torch.kernels.flash_attention.kernel`, from the capacity
``n_pages * page_size``), so paged and dense decode of equal capacity run
the same arithmetic in the same order and agree bit for bit on the same
rows.

The family's launch options shape the pool (``page_size`` rows a page,
``pages_per_slot_max`` pages a slot) and the batcher's admission
(``prefill_chunk``), not the call: :func:`launch_records` gives the decode
over a pool of that geometry.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.cuda_lib import LaunchRecord, LaunchWork
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.kernel import launch_split_decode
from repro_torch.kernels.paged_attention.ref import paged_decode_attention_ref
from repro_torch.utils.hardware import H100_SM_COUNT

#: K/V rows staged in shared memory per step
KV_TILE = 64


def launch_shapes(cfgs: Iterable[Any]) -> List[Dict[str, Any]]:
    """The decode shapes of the model configs ``cfgs`` (those the split
    decode takes: :func:`flash_attention.kernel.launch_shapes`'s decoded
    ones)."""
    return [s for s in flash_kernel.launch_shapes(cfgs) if s["decode"]]


def launch_records(shape: Dict[str, Any], dtype: torch.dtype, *,
                   page_size: int = 64, pages_per_slot_max: int = 8,
                   prefill_chunk: int = 0,
                   sm_count: int = H100_SM_COUNT) -> List[LaunchRecord]:
    """The launch of one paged decode step at ``shape`` over tables of
    ``pages_per_slot_max`` pages of ``page_size`` rows (``prefill_chunk``
    changes only the batcher's admission)."""
    return [flash_kernel.decode_record(
        dtype, True, shape["batch"], shape["kv_heads"], shape["g"],
        shape["d"], page_size * pages_per_slot_max, KV_TILE, sm_count)]


def launch_work(shape: Dict[str, Any], dtype: torch.dtype, *,
                page_size: int = 64, pages_per_slot_max: int = 8,
                prefill_chunk: int = 0,
                sm_count: int = H100_SM_COUNT) -> List[LaunchWork]:
    """The work of :func:`launch_records`' decode: slots of ``lens`` rows
    (the shape's; default full), each row read through its page."""
    return [flash_kernel.decode_work(
        dtype, shape["batch"], shape["kv_heads"], shape["g"], shape["d"],
        page_size * pages_per_slot_max, KV_TILE, shape.get("lens"),
        page_size=page_size, sm_count=sm_count)]


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
            or table.shape[0] != b or lens.shape != (b,) or d % 8:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)}, pool "
                         f"{tuple(k_pages.shape)}, table {tuple(table.shape)},"
                         f" lens {tuple(lens.shape)} (head dim a multiple of "
                         f"8)")
    cuda_lib.require_aligned("paged_decode_attention", q, k_pages, v_pages)
    if scale is None:
        scale = d ** -0.5
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    n_pages = table.shape[1]
    launch_split_decode(
        "repro_paged_decode_attention", q, n_pages * page_size, hkv, KV_TILE,
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), table.data_ptr(),
        lens.data_ptr(), o.data_ptr(), b, page_size, n_pages, hq, hkv, d,
        float(logit_softcap), float(scale))
    cuda_lib.LAUNCHES["paged_decode_attention"] += 1
    return o
