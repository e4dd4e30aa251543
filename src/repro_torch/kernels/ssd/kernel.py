"""CUDA Mamba-2 SSD wrapper (kernel: ``repro_torch/csrc/ssd.cu``).

Replaces the TPU kernel ``repro/kernels/ssd/kernel.py::ssd_pallas``
(``_ssd_kernel``).  Bound by bytes at zamba2-2.7b's training shape.  Two
routes, picked by :func:`ssd_route` from dtypes, shapes and alignment:

- ``"mma"`` (bf16 x, B and C): the chunks in parallel, one CUDA block of
  eight warps per two consecutive chunks of a (batch, head) pair, each
  chunk's products on the tensor cores (``mma.sync``), the (N, P) state
  handed from block to block inside the one launch through a per-device
  scratch (two fp32 state slots per (batch, head), one flag per block, a
  ticket counter) with an acquire/release flag per link.
  :func:`ref.ssd_tensor_core_ref` rounds where this route rounds.
- ``"simt"`` (fp32, and bf16 shapes the first does not cover): one block
  per (head, batch) walks the chunks in order with the state in shared
  memory, with fp32 FMAs, the decayed score tile only on and below the
  diagonal.

x, B and C are read in their own storage (widened to fp32 together only
when they disagree); dt in its own dtype, so a bf16 model's fp32 dt (from
its fp32 ``dt_bias``) keeps the tensor-core route.  Ragged L is masked,
not padded.  ``ssd.chunk`` snaps down into the family's domain (at most
64): the config's 256 becomes 64, which changes only the rounding.

Serving's prefill takes the final state (``return_state``), and a call may
start from a given state (``init_state``), both (B, H, N, P) fp32 as
:func:`ref.ssd_ref` has them.  Both routes take them in the same launch:
the tensor-core chain's first block reads its entering state from
``init_state`` and its last block, which publishes nothing, writes the
state it forms; the SIMT route seeds its shared-memory state and stores it
at the end.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import torch

from repro_torch.kernels import cuda_lib, dispatch
from repro_torch.kernels.cuda_lib import LaunchRecord, LaunchWork, Tile
from repro_torch.kernels.ssd.ref import ssd_ref

#: head widths P the tensor-core route is instantiated for
MMA_HEAD_DIMS = (16, 32, 64, 80, 128)
#: the tensor-core route's largest state size N (one 16-row slab per warp)
MMA_MAX_STATE = 64
#: threads of a block: the SIMT route's (``kSsdThreads``), and the
#: tensor-core route's eight warps, four for each of its two chunks
#: (``kSsdMmaThreads``, ``kChunksPerBlock``); the latter's static shared
#: bytes (``ticket_s``, an int, padded to the 16-byte alignment of the
#: dynamic region: ptxas reports 16)
SIMT_THREADS = 256
MMA_THREADS = 256
MMA_CHUNKS_PER_BLOCK = 2
MMA_STATIC_SMEM = 16


def smem_bytes(n: int, p: int, q: int) -> int:
    """Shared memory of one block of the SIMT route (``ssd_smem``)."""
    return (n * p + q * p + 2 * q * (n + 1) + q * q + 3 * q) * 4


def mma_smem_bytes(n: int, p: int, q: int) -> int:
    """Shared memory of one block of the tensor-core route
    (``ssd_mma_smem``): each of its two chunks' padded bf16 tiles — x [Q][P
    + 8], B and C [Q][N + 8], the entering state's high and low parts [N][P
    + 8] — and 64 floats each of cum and dt, then the first chunk's own
    state, N x P fp32."""
    chunk = (q * (p + 8) + 2 * q * (n + 8) + 2 * n * (p + 8)) * 2 + 2 * 64 * 4
    return MMA_CHUNKS_PER_BLOCK * chunk + n * p * 4


def ssd_route(x: torch.Tensor, Bmat: torch.Tensor, Cmat: torch.Tensor,
              q: int) -> str:
    """``"mma"`` where the tensor-core kernel takes these tensors (bf16 x,
    B and C, 16-byte-aligned, N a multiple of 16 up to 64, P one of
    :data:`MMA_HEAD_DIMS`, chunk a multiple of 16), else ``"simt"``."""
    n, p = Bmat.shape[-1], x.shape[-1]
    ok = (all(t.dtype == torch.bfloat16 for t in (x, Bmat, Cmat))
          and all(t.data_ptr() % 16 == 0 for t in (x, Bmat, Cmat))
          and n % 16 == 0 and 0 < n <= MMA_MAX_STATE
          and p in MMA_HEAD_DIMS and q % 16 == 0)
    return "mma" if ok else "simt"


#: batch and sequence of the shapes :func:`launch_shapes` gives (ragged
#: against every chunk)
SHAPE_BATCH, SHAPE_LEN = 2, 80


def launch_shapes(cfgs: Iterable[Any]) -> List[Dict[str, Any]]:
    """The Mamba-2 SSDs of the model configs ``cfgs``: their heads, head
    width P, groups (one) and state size N, with the initial and final
    states (serving's prefill), at :data:`SHAPE_BATCH` x
    :data:`SHAPE_LEN`."""
    dims = sorted({(c.ssm_num_heads, c.ssm_expand * c.d_model
                    // c.ssm_num_heads, c.ssm_state) for c in cfgs
                   if c.family in ("ssm", "hybrid") and c.ssm_num_heads})
    return [dict(batch=SHAPE_BATCH, len=SHAPE_LEN, heads=h, p=p, groups=1,
                 n=n, states=True) for h, p, n in dims]


def launch_records(shape: Dict[str, Any], dtype: torch.dtype, *,
                   chunk: int = 64) -> List[LaunchRecord]:
    """The launch of one call at ``shape`` with x, B and C stored as
    ``dtype`` and dt in fp32 (a model's dt comes from its fp32
    ``dt_bias``), on the route :func:`ssd_route` picks.  SIMT: grid (H, B),
    block (h, b) walks its pair's chunks.  Tensor cores: one block per
    two chunks of a pair; the block that draws ticket t takes the pair's
    block t / (B H) of pair t % (B H) and hands its state on through the
    pair's slot (block % 2) and flag, in order."""
    b, l, h, p, n = (shape["batch"], shape["len"], shape["heads"],
                     shape["p"], shape["n"])
    q = dispatch.snap_down(chunk,
                           dispatch.get_family("ssd").option("chunk").values)
    meta = [torch.empty(s, dtype=dtype, device="meta")
            for s in ((b, l, h, p), (b, l, shape["groups"], n))]
    states = shape["states"]
    name = cuda_lib.CTYPE_NAMES[dtype]
    if ssd_route(meta[0], meta[1], meta[1], q) == "simt":
        def simt_writes(idx):
            hh, bb = idx[0], idx[1]
            tiles = (Tile("y", ((bb, bb + 1), (0, l), (hh, hh + 1), (0, p))),)
            if states:
                tiles += (Tile("state_out", ((bb, bb + 1), (hh, hh + 1))),)
            return tiles

        return [LaunchRecord(
            f"repro::ssd_kernel<{name}, float, {name}>", (h, b, 1),
            (SIMT_THREADS, 1, 1), smem_bytes(n, p, q), writes=simt_writes)]
    bh = b * h
    n_chunks = -(-l // q)
    n_blocks = -(-n_chunks // MMA_CHUNKS_PER_BLOCK)

    def mma_writes(idx):
        kb, pair = divmod(idx[0], bh)
        bb, hh = divmod(pair, h)
        t0 = kb * MMA_CHUNKS_PER_BLOCK * q
        tiles = (Tile("flags", ((pair, pair + 1), (kb, kb + 1))),)
        if t0 < l:
            tiles += (Tile("y", ((bb, bb + 1),
                                 (t0, min(t0 + MMA_CHUNKS_PER_BLOCK * q, l)),
                                 (hh, hh + 1), (0, p))),)
        if kb + 1 < n_blocks:
            tiles += (Tile("states", ((pair, pair + 1),
                                      (kb % 2, kb % 2 + 1))),)
        elif states:
            tiles += (Tile("state_out", ((bb, bb + 1), (hh, hh + 1))),)
        return tiles

    return [LaunchRecord(
        f"repro::ssd_mma_kernel<{p}, float>", (n_blocks * bh, 1, 1),
        (MMA_THREADS, 1, 1), mma_smem_bytes(n, p, q), MMA_STATIC_SMEM,
        in_order=(0,), writes=mma_writes)]


def launch_work(shape: Dict[str, Any], dtype: torch.dtype, *,
                chunk: int = 64,
                dt_dtype: torch.dtype = torch.float32) -> List[LaunchWork]:
    """The work of :func:`launch_records`' call, dt in ``dt_dtype``: the
    chunked form's products per (b, h, chunk of Q steps) — C B^T (Q Q N),
    M x (Q Q P), the chunk state (N Q P) and C S_in (Q N P) — on the
    tensor cores where the route is the tensor-core chain, whose links
    run in order."""
    b, l, h, p, n = (shape["batch"], shape["len"], shape["heads"],
                     shape["p"], shape["n"])
    g, es = shape["groups"], dtype.itemsize
    q = dispatch.snap_down(chunk,
                           dispatch.get_family("ssd").option("chunk").values)
    (record,) = launch_records(shape, dtype, chunk=chunk)
    chained = bool(record.in_order)
    hbm = ((2 * b * l * h * p + 2 * b * l * g * n) * es
           + b * l * h * dt_dtype.itemsize + 8 * h
           + shape["states"] * 4 * b * h * n * p)
    return [LaunchWork(2 * b * h * l * (q * n + q * p + 2 * n * p),
                       b * h * l * (q + 1) // 2, hbm, tensor=chained,
                       links=record.grid[0] // (b * h) if chained else 0)]


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bmat: torch.Tensor, Cmat: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 64, init_state: Optional[torch.Tensor] = None,
             return_state: bool = False):
    """x (B, L, H, P); dt (B, L, H); A, D (H,); Bmat, Cmat (B, L, G, N);
    init_state (B, H, N, P) or None -> y (B, L, H, P) in x's dtype, and with
    ``return_state`` the final state (B, H, N, P) fp32.  A CPU tensor takes
    the plain version."""
    if x.device.type == "cpu":
        return ssd_ref(x, dt, A, Bmat, Cmat, D, chunk=chunk,
                       init_state=init_state, return_state=return_state)
    b, l, h, p = x.shape
    g, n = Bmat.shape[2], Bmat.shape[3]
    if dt.shape != (b, l, h) or A.shape != (h,) or D.shape != (h,) \
            or Bmat.shape != (b, l, g, n) or Cmat.shape != Bmat.shape \
            or h % g or (init_state is not None
                         and init_state.shape != (b, h, n, p)):
        raise ValueError(
            f"ssd: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, B {tuple(Bmat.shape)}, C {tuple(Cmat.shape)}, "
            f"D {tuple(D.shape)}, init_state "
            f"{None if init_state is None else tuple(init_state.shape)}")
    q = dispatch.snap_down(chunk,
                           dispatch.get_family("ssd").option("chunk").values)
    out_code = cuda_lib.dtype_code(x)
    xs, bs, cs = cuda_lib.one_storage(x, Bmat, Cmat)
    dts = (dt if dt.dtype in cuda_lib.DTYPE_CODES else dt.float()).contiguous()
    a32 = A.to(torch.float32).contiguous()
    d32 = D.to(torch.float32).contiguous()
    s0 = None
    if init_state is not None:  # read as float2 pairs: 8-byte aligned
        s0 = init_state.to(torch.float32).contiguous()
        s0 = s0 if s0.data_ptr() % 16 == 0 else s0.clone()
    cuda_lib.require("ssd", xs, dts, bs, cs, a32, d32,
                     *(() if s0 is None else (s0,)))
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    state_shape = (b, h, n, p)
    if y.numel() == 0:  # no step: the state is the one given
        if not return_state:
            return y
        return y, (s0.clone() if s0 is not None else torch.zeros(
            state_shape, dtype=torch.float32, device=x.device))
    s_out = (torch.empty(state_shape, dtype=torch.float32, device=x.device)
             if return_state else None)
    route = ssd_route(xs, bs, cs, q)
    if route == "mma":
        n_chunks = -(-l // q)
        states, flags, ticket = cuda_lib.ssd_scratch(
            x.device, b * h * 2 * n * p, b * h * n_chunks)
        chain = (states.data_ptr(), flags.data_ptr(), ticket.data_ptr(),
                 cuda_lib.next_epoch(x.device))
    else:
        smem = smem_bytes(n, p, q)
        if smem > cuda_lib.SMEM_LIMIT:
            raise ValueError(f"ssd: {smem} bytes of shared memory (chunk "
                             f"{q}, N {n}, P {p})")
        chain = (None, None, None, 0)
    err = cuda_lib.library().repro_ssd(
        xs.data_ptr(), dts.data_ptr(), a32.data_ptr(), bs.data_ptr(),
        cs.data_ptr(), d32.data_ptr(), y.data_ptr(), b, l, h, p, g, n, q,
        cuda_lib.dtype_code(xs), cuda_lib.dtype_code(dts), out_code,
        int(route == "mma"), None if s0 is None else s0.data_ptr(),
        None if s_out is None else s_out.data_ptr(), *chain,
        cuda_lib.stream_of(x))
    cuda_lib.check(err, "ssd")
    cuda_lib.LAUNCHES["ssd"] += 1
    return (y, s_out) if return_state else y
