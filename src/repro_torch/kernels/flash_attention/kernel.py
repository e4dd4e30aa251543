"""CUDA prefill and decode attention wrappers (kernels:
``repro_torch/csrc/flash_attention.cu`` and
``repro_torch/csrc/decode_attention.cu``).

- :func:`flash_attention_cuda` replaces the TPU kernel
  ``repro/kernels/flash_attention/kernel.py::flash_attention_pallas``
  (``_attn_kernel``).  At serving prompt lengths it is bound by bytes, at
  long prompts by tensor-core flops; this first kernel computes with fp32
  FMAs, one thread per query row (q row and accumulator in registers), one
  CUDA block per (q tile of ``q_block`` rows, q head, batch), ``kv_block``
  K/V rows staged in shared memory per step, fully masked tiles skipped.
- :func:`decode_attention_cuda` replaces
  ``repro/kernels/flash_attention/kernel.py::decode_attention_pallas``
  (``_decode_kernel``).  Bound by bytes (every valid K/V row read once per
  step); one CUDA block per (slot, kv head) holds the group's query heads so
  each K/V row is read once per group.  Only B * Hkv blocks run — the known
  limit, to be lifted by splitting the KV axis.

Block sizes outside the kernels' domains (the reference's TPU-sized
``ParallelConfig.attn_*_block`` defaults) are snapped down into them, as
the Pallas kernels clamp theirs to the sequence length.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cuda_lib, dispatch
from repro_torch.kernels.flash_attention.ref import (
    attention_blockwise_ref, decode_attention_ref)

#: head dims the prefill kernel is instantiated for (80: zamba2-2.7b's and
#: h2o-danube-1.8b's attention)
PREFILL_HEAD_DIMS = (16, 32, 64, 80, 128)


def _block(name: str, value: int) -> int:
    return dispatch.snap_down(
        value, dispatch.get_family("flash_attention").option(name).values)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, sliding_window: int = 0,
                         logit_softcap: float = 0.0,
                         scale: Optional[float] = None, q_offset: int = 0,
                         q_block: int = 64, kv_block: int = 64) -> torch.Tensor:
    """Prefill attention, q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D) ->
    (B, Sq, Hq, D).  A CPU tensor takes the plain version."""
    if q.device.type == "cpu":
        return attention_blockwise_ref(
            q, k, v, causal=causal, sliding_window=sliding_window,
            logit_softcap=logit_softcap, scale=scale, q_offset=q_offset,
            kv_block=kv_block)
    cuda_lib.require("flash_attention", q, k, v, dtype=q.dtype)
    b, sq, hq, d = q.shape
    _, skv, hkv, dv = v.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if dv != d or d not in PREFILL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} (v {dv}) not in "
                         f"{PREFILL_HEAD_DIMS}")
    if hq % hkv:
        raise ValueError(f"flash_attention: {hq} q heads over {hkv} kv heads")
    if scale is None:
        scale = d ** -0.5
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    err = cuda_lib.library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq, skv,
        hq, hkv, d, int(causal), int(sliding_window), float(logit_softcap),
        float(scale), int(q_offset), _block("q_block", q_block),
        _block("kv_block", kv_block), cuda_lib.dtype_code(q),
        cuda_lib.stream_of(q))
    cuda_lib.check(err, "flash_attention")
    cuda_lib.LAUNCHES["flash_attention"] += 1
    return o


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                          sliding_window: int = 0, logit_softcap: float = 0.0,
                          scale: Optional[float] = None,
                          kv_block: int = 64) -> torch.Tensor:
    """Decode attention, q (B, 1, Hq, D) over k/v (B, Skv, Hkv, D) with
    per-slot lengths (B,) -> (B, 1, Hq, D).  A CPU tensor takes the plain
    version."""
    if q.device.type == "cpu":
        return decode_attention_ref(
            q, k_cache, v_cache, cache_len, sliding_window=sliding_window,
            logit_softcap=logit_softcap, scale=scale)
    lens = cuda_lib.as_int32(cache_len)
    cuda_lib.require("decode_attention", q, k_cache, v_cache, dtype=q.dtype)
    cuda_lib.require("decode_attention", q, lens)
    b, sq, hq, d = q.shape
    _, skv, hkv, dv = v_cache.shape
    if sq != 1 or k_cache.shape != v_cache.shape or k_cache.shape[0] != b \
            or dv != d or lens.shape != (b,) or hq % hkv:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)}, lens {tuple(lens.shape)}")
    if scale is None:
        scale = d ** -0.5
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    err = cuda_lib.library().repro_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        o.data_ptr(), b, skv, hq, hkv, d, int(sliding_window),
        float(logit_softcap), float(scale), _block("kv_block", kv_block),
        cuda_lib.dtype_code(q), cuda_lib.stream_of(q))
    cuda_lib.check(err, "decode_attention")
    cuda_lib.LAUNCHES["decode_attention"] += 1
    return o
