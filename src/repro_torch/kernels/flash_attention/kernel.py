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

:func:`launch_records` gives, from shapes alone, the launches a prefill and
a decode at those shapes make (:class:`cuda_lib.LaunchRecord`), with their
shared memory sized by the mirrors of the C++ (:func:`prefill_smem_bytes`,
:func:`decode_smem_bytes`); :func:`launch_shapes` the shapes the
registry's archs give these kernels.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import cuda_lib, dispatch
from repro_torch.kernels.cuda_lib import LaunchRecord, LaunchWork, Tile
from repro_torch.kernels.flash_attention.ref import (
    attention_blockwise_ref, decode_attention_ref)
from repro_torch.utils.hardware import H100_SM_COUNT

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


#: threads of a decode block (``kDecodeThreads``), the stages of its K/V
#: ring (``kDecodeStages``) and its static shared bytes: ``last_block``, an
#: int, padded to the 16-byte alignment of the dynamic region (ptxas
#: reports 16)
DECODE_THREADS = 128
DECODE_STAGES = 2
DECODE_STATIC_SMEM = 16
#: stages of the tensor-core prefill's K/V ring (``kStages``)
MMA_STAGES = 2


def prefill_smem_bytes(d: int, dv: int, kv_block: int, itemsize: int) -> int:
    """Shared bytes of one prefill block: the fp32 SIMT kernel's K and V
    tiles, ``kv_block * (D + Dv)`` floats (``launch_simt_hd``), or the
    tensor-core kernel's ring, ``MmaTile<D, Dv, kv_block>::smem_bytes()``:
    two stages of K rows padded to D + 8 and V rows padded to Dv rounded up
    to 16, plus 8, in bf16."""
    if itemsize == 4:
        return kv_block * (d + dv) * 4
    dvp = -(-dv // 16) * 16
    return MMA_STAGES * kv_block * ((d + 8) + (dvp + 8)) * 2


def decode_smem_bytes(kv_block: int, d: int, g: int, itemsize: int) -> int:
    """Dynamic shared bytes of one decode block
    (``decode_smem_bytes<T>`` in ``decode_attention.cuh``): the two-stage
    K/V ring in the cache's type, K rows padded by 16 bytes, then the fp32
    Q, accumulator, probabilities and the m, l, alpha of ``g`` heads."""
    kv = DECODE_STAGES * kv_block * ((d + 16 // itemsize) + d) * itemsize
    floats = 2 * g * d + g * kv_block + 3 * g
    return kv + floats * 4


def decode_record(dtype: torch.dtype, paged: bool, batch: int, kv_heads: int,
                  g: int, d: int, capacity: int, kv_block: int,
                  sm_count: int) -> LaunchRecord:
    """The split decode's launch (dense or paged): grid (Hkv, B, n_split)
    of :func:`plan_decode_splits`; each block writes its split's partial,
    and whichever block of a (slot, kv head) comes last writes the group's
    output, so the split axis is combined in order."""
    n_split, _ = plan_decode_splits(capacity, kv_block, batch, kv_heads,
                                    sm_count)

    def writes(idx):
        hk, b, split = idx
        bh = b * kv_heads + hk
        return (Tile("o", ((b, b + 1), (0, 1), (hk * g, (hk + 1) * g),
                           (0, d))),
                Tile("partial", ((bh, bh + 1), (split, split + 1))),
                Tile("counters", ((bh, bh + 1),)))

    return LaunchRecord(
        f"repro::decode_attention_kernel<{cuda_lib.CTYPE_NAMES[dtype]}, "
        f"{str(paged).lower()}>", (kv_heads, batch, n_split),
        (DECODE_THREADS, 1, 1),
        decode_smem_bytes(kv_block, d, g, dtype.itemsize),
        DECODE_STATIC_SMEM, in_order=(2,), writes=writes)


def prefill_record(dtype: torch.dtype, batch: int, sq: int, heads: int,
                   d: int, dv: int, q_block: int,
                   kv_block: int) -> LaunchRecord:
    """The prefill's launch: fp32 takes the SIMT kernel, grid (q tiles, Hq,
    B) of ``q_block`` threads; bf16 the tensor-core kernel, grid (Hq, B, q
    tiles) of ``2 * q_block`` threads, its q tiles taken backwards."""
    qb, kb = _block("q_block", q_block), _block("kv_block", kv_block)
    tiles = -(-sq // qb)

    def rows(b, h, tile):
        return (Tile("o", ((b, b + 1), (tile * qb, min((tile + 1) * qb, sq)),
                           (h, h + 1), (0, dv))),)

    if dtype == torch.float32:
        return LaunchRecord(
            f"repro::flash_attention_kernel<float, {d}, {dv}>",
            (tiles, heads, batch), (qb, 1, 1),
            prefill_smem_bytes(d, dv, kb, 4),
            writes=lambda idx: rows(idx[2], idx[1], idx[0]))
    return LaunchRecord(
        f"repro::flash_attention_mma_kernel<{d}, {dv}, {kb}>",
        (heads, batch, tiles), (2 * qb, 1, 1),
        prefill_smem_bytes(d, dv, kb, 2),
        writes=lambda idx: rows(idx[1], idx[0], tiles - 1 - idx[2]))


#: batch, kv heads and rows of the shapes :func:`launch_shapes` gives:
#: small, ragged against every block size, with more than one block on
#: every grid axis
SHAPE_BATCH, SHAPE_KV_HEADS, SHAPE_ROWS, SHAPE_CROSS_ROWS = 2, 2, 80, 100


def launch_shapes(cfgs: Iterable[Any]) -> List[Dict[str, Any]]:
    """The attention shapes the model configs ``cfgs`` give the kernels:
    every (q/k dim, v dim, G) of their self-attention (MLA's prefill: its
    192 / 128 with one query head a key head; causal, decoded by the split
    decode where the dims agree and MLA's plain decode does not take it),
    their cross-attention (vlm) and their encoder's (audio), non-causal,
    at :data:`SHAPE_BATCH` slots of :data:`SHAPE_KV_HEADS` kv heads."""
    out: Dict[Tuple, Dict[str, Any]] = {}

    def add(d, dv, g, causal, skv, decode):
        key = (d, dv, g, causal, skv, decode)
        out.setdefault(key, dict(
            d=d, dv=dv, g=g, causal=causal, decode=decode,
            batch=SHAPE_BATCH, kv_heads=SHAPE_KV_HEADS, sq=SHAPE_ROWS,
            skv=skv))

    for c in cfgs:
        if c.attn_type == "mla":
            add(c.qk_nope_head_dim + c.qk_rope_head_dim, c.v_head_dim, 1,
                True, SHAPE_ROWS, False)
            continue
        if c.is_attention_free:
            continue
        d, g = c.head_dim, c.num_heads // c.num_kv_heads
        add(d, d, g, True, SHAPE_ROWS, d % 8 == 0)
        if c.cross_attn_period or c.encoder_layers:
            add(d, d, g, False, SHAPE_CROSS_ROWS, False)
        if c.encoder_layers:
            add(d, d, g, False, SHAPE_ROWS, False)
    return [out[k] for k in sorted(out)]


def launch_records(shape: Dict[str, Any], dtype: torch.dtype, *,
                   q_block: int = 64, kv_block: int = 64,
                   sm_count: int = H100_SM_COUNT) -> List[LaunchRecord]:
    """The launches of one prefill at ``shape`` and, where the shape is
    decoded by the split decode, of one decode step over ``skv`` rows."""
    b, hkv = shape["batch"], shape["kv_heads"]
    out = [prefill_record(dtype, b, shape["sq"], hkv * shape["g"],
                          shape["d"], shape["dv"], q_block, kv_block)]
    if shape["decode"]:
        out.append(decode_record(dtype, False, b, hkv, shape["g"], shape["d"],
                                 shape["skv"], _block("kv_block", kv_block),
                                 sm_count))
    return out


def prefill_work(dtype: torch.dtype, batch: int, sq: int, skv: int,
                 heads: int, kv_heads: int, d: int, dv: int, causal: bool,
                 q_block: int, kv_block: int) -> LaunchWork:
    """The prefill's work: a causal row ``i`` reads keys up to ``i``; each
    block walks the K/V tiles of its q tile, in the order
    :func:`prefill_record` launches the q tiles."""
    qb, kb = _block("q_block", q_block), _block("kv_block", kv_block)
    tiles = -(-sq // qb)
    ends = np.minimum(np.arange(1, tiles + 1) * qb, sq)
    if causal:
        keys = np.minimum(skv, ends)
        per_head = int(np.minimum(skv, np.arange(1, sq + 1)).sum())
    else:
        keys = np.full(tiles, skv)
        per_head = sq * skv
    visited = -(-keys // kb)
    pairs = batch * heads * per_head
    tensor = dtype != torch.float32
    # the tensor-core grid (Hq, B, q tiles) takes its q tiles backwards;
    # the SIMT grid (q tiles, Hq, B) forwards
    steps = (np.repeat(visited[::-1], heads * batch) if tensor
             else np.tile(visited, heads * batch))
    hbm = (batch * sq * heads + batch * skv * kv_heads) * (d + dv) \
        * dtype.itemsize
    return LaunchWork(2 * (d + dv) * pairs, pairs, hbm, tensor=tensor,
                      steps=steps, tile=(d, dv, qb, kb))


def decode_work(dtype: torch.dtype, batch: int, kv_heads: int, g: int,
                d: int, capacity: int, kv_block: int,
                lens: Optional[Sequence[int]] = None, page_size: int = 0,
                sm_count: int = H100_SM_COUNT) -> LaunchWork:
    """The split decode's work over slots of ``lens`` rows (default: full
    caches of ``capacity``), read through pages of ``page_size`` rows where
    it is paged: each block walks its split's K/V tiles, and the split
    axis is combined in order.  A decode block (128 threads, like a 64-row
    prefill block) prices its tile as that prefill tile."""
    n_split, split_rows = plan_decode_splits(capacity, kv_block, batch,
                                             kv_heads, sm_count)
    lens = np.minimum(np.asarray([capacity] * batch if lens is None
                                 else lens), capacity)
    valid, hq, es = int(lens.sum()), kv_heads * g, dtype.itemsize
    # grid (Hkv, B, n_split): the rows of each block's split
    rows = np.clip(lens[None, :] - split_rows * np.arange(n_split)[:, None],
                   0, split_rows)
    steps = np.repeat((-(-rows // kv_block)).ravel(), kv_heads)
    hbm = 2 * batch * hq * d * es + 2 * valid * kv_heads * d * es + 4 * batch
    if page_size:
        hbm += 4 * int((-(-lens // page_size)).sum())
    return LaunchWork(4 * d * hq * valid, hq * valid, hbm, steps=steps,
                      tile=(d, d, 64, kv_block), links=int(n_split > 1))


def launch_work(shape: Dict[str, Any], dtype: torch.dtype, *,
                q_block: int = 64, kv_block: int = 64,
                sm_count: int = H100_SM_COUNT) -> List[LaunchWork]:
    """The work of each launch :func:`launch_records` gives at ``shape``
    (the decode's slots filled to the shape's ``lens``, where given)."""
    b, hkv, g = shape["batch"], shape["kv_heads"], shape["g"]
    out = [prefill_work(dtype, b, shape["sq"], shape["skv"], hkv * g, hkv,
                        shape["d"], shape["dv"], shape["causal"], q_block,
                        kv_block)]
    if shape["decode"]:
        out.append(decode_work(dtype, b, hkv, g, shape["d"], shape["skv"],
                               _block("kv_block", kv_block),
                               shape.get("lens"), sm_count=sm_count))
    return out


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
