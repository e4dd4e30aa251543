"""CUDA prefill and decode attention wrappers (kernels:
``repro_torch/csrc/flash_attention.cu`` and
``repro_torch/csrc/decode_attention.cu``).

- :func:`flash_attention_cuda` replaces the TPU kernel
  ``repro/kernels/flash_attention/kernel.py::flash_attention_pallas``
  (``_attn_kernel``).  At serving prompt lengths it is bound by bytes, at
  long prompts by tensor-core operations.  The dtype picks the route: bf16
  runs a FlashAttention-2 kernel on the tensor cores (``mma.sync``, K/V
  staged as bf16 by ``cp.async`` in a two-stage ring), ``q_block`` query
  rows per CUDA block (16 per warp) and ``kv_block`` K/V rows per stage;
  fp32 runs a SIMT kernel with fp32 FMAs, one thread per query row, since
  tensor cores cannot meet fp32's tolerance.  Fully masked tiles are
  skipped on both.  V (and the output) may be narrower than Q/K, as MLA
  prefill passes them; both kernels are templated on the two head dims
  (:data:`PREFILL_HEAD_DIMS`).
- :func:`decode_attention_cuda` replaces
  ``repro/kernels/flash_attention/kernel.py::decode_attention_pallas``
  (``_decode_kernel``).  Bound by bytes (every valid K/V row read once per
  step).  One CUDA block per (kv head, slot, split) holds the group's query
  heads, so each K/V row is read once per group; the KV axis is split
  (flash-decoding) by :func:`plan_decode_splits`, from shapes only, and the
  splits are combined in the same launch.

Block sizes outside the kernels' domains (the reference's TPU-sized
``ParallelConfig.attn_*_block`` defaults) are snapped down into them, as
the Pallas kernels clamp theirs to the sequence length.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import torch

from repro_torch.kernels import cuda_lib, dispatch
from repro_torch.kernels.flash_attention.ref import (
    attention_blockwise_ref, decode_attention_ref)

#: (Q/K head dim, V head dim) pairs the prefill kernel is instantiated for:
#: equal dims (80: zamba2-2.7b's and h2o-danube-1.8b's attention) and the
#: MLA prefill's (192, 128) of deepseek-v3-671b and (16, 8) of its smoke
#: config
PREFILL_HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (80, 80), (128, 128),
                     (192, 128), (16, 8))

#: split decode: blocks per SM the planner aims for.  A decode block holds
#: ~38 KB of shared memory (bf16, kv_block 64), so five or six reside on an
#: SM: 8 per SM is about one and a half waves of resident blocks, enough
#: bytes in flight to cover the memory latency, while longer ranges keep
#: the combine's share small (``chip_smoke.py`` phase 5 times 8, 16 and 32
#: at 32 slots x 2048 rows)
DECODE_BLOCKS_PER_SM = 8


@lru_cache(maxsize=256)
def plan_decode_splits(capacity: int, kv_block: int, batch: int,
                       kv_heads: int, sm_count: int) -> Tuple[int, int]:
    """``(n_split, split_rows)`` for a decode over caches of ``capacity``
    rows (dense rows per slot, or ``n_pages * page_size``): the KV axis cut
    into ``n_split`` contiguous ranges of ``split_rows`` rows, a multiple of
    ``kv_block``, the last one clipped to the capacity, so that the grid
    ``(kv_heads, batch, n_split)`` fills about
    :data:`DECODE_BLOCKS_PER_SM` blocks per SM.  Shapes only: the slots'
    lengths are never read on the host, which would synchronise the device
    every step.  Equal capacities give equal plans, so paged and dense
    decode split alike."""
    n_tiles = max(1, -(-capacity // kv_block))
    groups = max(1, batch * kv_heads)
    want = -(-DECODE_BLOCKS_PER_SM * sm_count // groups)
    per = -(-n_tiles // max(1, min(n_tiles, want)))
    return -(-n_tiles // per), per * kv_block


def launch_split_decode(entry: str, q: torch.Tensor, capacity: int,
                        hkv: int, kv_block: int, *args) -> None:
    """Plan the split, fetch the scratch and call ``entry`` with ``args``
    (everything up to ``kv_block``) followed by the plan, the scratch, the
    dtype and the stream."""
    b, _, hq, d = q.shape
    n_split, split_rows = plan_decode_splits(
        capacity, kv_block, b, hkv, cuda_lib.sm_count(q.device))
    partial, counters = cuda_lib.decode_scratch(
        q.device, b * hkv * n_split * (hq // hkv) * (d + 2), b * hkv)
    err = getattr(cuda_lib.library(), entry)(
        *args, kv_block, n_split, split_rows, partial.data_ptr(),
        counters.data_ptr(), cuda_lib.dtype_code(q), cuda_lib.stream_of(q))
    cuda_lib.check(err, entry[len("repro_"):])


def _block(name: str, value: int) -> int:
    return dispatch.snap_down(
        value, dispatch.get_family("flash_attention").option(name).values)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, sliding_window: int = 0,
                         logit_softcap: float = 0.0,
                         scale: Optional[float] = None, q_offset: int = 0,
                         q_block: int = 64, kv_block: int = 64) -> torch.Tensor:
    """Prefill attention, q (B, Sq, Hq, D), k (B, Skv, Hkv, D), v
    (B, Skv, Hkv, Dv) -> (B, Sq, Hq, Dv).  A CPU tensor takes the plain
    version."""
    if q.device.type == "cpu":
        return attention_blockwise_ref(
            q, k, v, causal=causal, sliding_window=sliding_window,
            logit_softcap=logit_softcap, scale=scale, q_offset=q_offset,
            kv_block=kv_block)
    cuda_lib.require("flash_attention", q, k, v, dtype=q.dtype)
    b, sq, hq, d = q.shape
    _, skv, hkv, dv = v.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if (d, dv) not in PREFILL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dims (q/k {d}, v {dv}) not "
                         f"in {PREFILL_HEAD_DIMS}")
    if hq % hkv:
        raise ValueError(f"flash_attention: {hq} q heads over {hkv} kv heads")
    cuda_lib.require_aligned("flash_attention", q, k, v)
    if scale is None:
        scale = d ** -0.5
    o = q.new_empty((b, sq, hq, dv))
    if o.numel() == 0:
        return o
    err = cuda_lib.library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq, skv,
        hq, hkv, d, dv, int(causal), int(sliding_window),
        float(logit_softcap), float(scale), int(q_offset),
        _block("q_block", q_block),
        _block("kv_block", kv_block), cuda_lib.dtype_code(q),
        cuda_lib.stream_of(q))
    cuda_lib.check(err, "flash_attention")
    cuda_lib.LAUNCHES["flash_attention"] += 1
    # windowed: the window bites
    inst = (d, dv, 0 < sliding_window < skv, bool(causal))
    cuda_lib.PREFILL_INSTANCES[inst] = cuda_lib.PREFILL_INSTANCES.get(inst,
                                                                      0) + 1
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
            or dv != d or lens.shape != (b,) or hq % hkv or d % 8:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)}, lens {tuple(lens.shape)} "
                         f"(head dim a multiple of 8)")
    cuda_lib.require_aligned("decode_attention", q, k_cache, v_cache)
    if scale is None:
        scale = d ** -0.5
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    launch_split_decode(
        "repro_decode_attention", q, skv, hkv, _block("kv_block", kv_block),
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        o.data_ptr(), b, skv, hq, hkv, d, int(sliding_window),
        float(logit_softcap), float(scale))
    cuda_lib.LAUNCHES["decode_attention"] += 1
    return o
