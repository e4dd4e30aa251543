"""Public kernel entry points — the port of :mod:`repro.kernels.ops`
(``rmsnorm``, ``flash_attention``, ``decode_attention``,
``paged_decode_attention``, ``selective_scan``, ``selective_scan_step``,
``ssd``, ``ssd_step``).

Each op resolves its family through :mod:`repro_torch.kernels.dispatch` for
the device its input lies on: a CPU tensor runs the plain PyTorch version, a
CUDA tensor the hand-written sm_90a kernel.  Launch parameters left as
``None`` resolve through the registry (an active tuned configuration wins,
then explicit call-site values, then the defaults).

Gradients.  The JAX package has no backward kernel for any family; its
``_recompute_vjp`` (``repro/kernels/ops.py:54-77``) saves an op's inputs,
and its backward recomputes the plain forward and differentiates that.
:class:`_Recompute` is the counterpart: when any input requires grad,
``rmsnorm``, ``flash_attention``, ``selective_scan`` and ``ssd`` run their
forward (the kernel on the card) inside it, and its backward runs the plain
version under ``torch.enable_grad()`` and differentiates it.  That backward
is the one place where the plain version runs on CUDA tensors on the main
path — exactly as in the reference — and :data:`RECOMPUTES` counts it.
Without the wrapper a kernel's output would carry no autograd history and
everything upstream of it would get gradient only through the residual
stream.

The continuation variants (``selective_scan(..., return_state=True)``,
``ssd(..., init_state=..., return_state=...)``) run the plain version on
any device, as in the reference (``repro/kernels/ops.py:160-165``,
``:191-196``), which routes them to its oracle even on a TPU; the decode
steps are plain too, as there.  Training, the path these kernels serve
here, uses neither.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import ref as _attn_ref
from repro_torch.kernels.mamba_scan import ref as _scan_ref
from repro_torch.kernels.paged_attention import ref as _paged_ref
from repro_torch.kernels.rmsnorm import ref as _rms_ref
from repro_torch.kernels.ssd import ref as _ssd_ref

#: recompute backwards run since the last :func:`reset_recomputes`
RECOMPUTES: Dict[str, int] = {
    "rmsnorm": 0,
    "flash_attention": 0,
    "selective_scan": 0,
    "ssd": 0,
}


def reset_recomputes() -> None:
    for name in RECOMPUTES:
        RECOMPUTES[name] = 0


class _Recompute(torch.autograd.Function):
    """``forward(*inputs)`` now, ``plain(*inputs)`` recomputed and
    differentiated in the backward; only the inputs are saved."""

    @staticmethod
    def forward(ctx, name: str, forward: Callable, plain: Callable, *inputs):
        ctx.name, ctx.plain = name, plain
        ctx.save_for_backward(*inputs)
        return forward(*inputs)

    @staticmethod
    def backward(ctx, dy):
        needs = ctx.needs_input_grad[3:]
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, needs)]
        # the profiler range lets a trace attribute the recompute's device
        # time (a no-op when no profiler runs)
        with torch.profiler.record_function(f"recompute_bwd.{ctx.name}"):
            with torch.enable_grad():
                y = ctx.plain(*inputs)
            wanted = [t for t, need in zip(inputs, needs) if need]
            grads = iter(torch.autograd.grad(y, wanted, dy,
                                             allow_unused=True))
        RECOMPUTES[ctx.name] += 1
        return (None, None, None) + tuple(next(grads) if need else None
                                          for need in needs)


def recompute(name: str, forward: Callable, plain: Callable, *inputs):
    """``forward(*inputs)``, differentiable through ``plain`` when grad is
    on and any input requires it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _Recompute.apply(name, forward, plain, *inputs)
    return forward(*inputs)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal=True, sliding_window=0,
                    logit_softcap=0.0, scale=None, q_offset=0, q_block=None,
                    kv_block=None):
    res = dispatch.resolve("flash_attention", device=q.device,
                           q_block=q_block, kv_block=kv_block)
    kw = dict(causal=causal, sliding_window=sliding_window,
              logit_softcap=logit_softcap, scale=scale, q_offset=q_offset)

    def plain(q, k, v):
        return _attn_ref.attention_blockwise_ref(
            q, k, v, kv_block=res.launch["kv_block"], **kw)

    def kernel(q, k, v):
        return res.impl(q, k, v, q_block=res.launch["q_block"],
                        kv_block=res.launch["kv_block"], **kw)

    fwd = plain if res.mode == dispatch.REF else kernel
    return recompute("flash_attention", fwd, plain, q, k, v)


def decode_attention(q, k_cache, v_cache, cache_len, *, sliding_window=0,
                     logit_softcap=0.0, scale=None, kv_block=None):
    res = dispatch.resolve("flash_attention", device=q.device,
                           kv_block=kv_block)
    if res.mode == dispatch.REF:
        return _attn_ref.decode_attention_ref(
            q, k_cache, v_cache, cache_len, sliding_window=sliding_window,
            logit_softcap=logit_softcap, scale=scale)
    fn = dispatch.kernel_fn("flash_attention", variant="decode")
    return fn(q, k_cache, v_cache, cache_len, sliding_window=sliding_window,
              logit_softcap=logit_softcap, scale=scale,
              kv_block=res.launch["kv_block"])


def paged_decode_attention(q, k_pages, v_pages, page_table, cache_len, *,
                           logit_softcap=0.0, scale=None):
    """Single-token decode over a block-paged KV pool.  The family's launch
    options shape the pool the caller built, not this call; resolving the
    family still records the decision for the dispatch audit."""
    res = dispatch.resolve("paged_attention", device=q.device)
    if res.mode == dispatch.REF:
        return _paged_ref.paged_decode_attention_ref(
            q, k_pages, v_pages, page_table, cache_len,
            logit_softcap=logit_softcap, scale=scale)
    fn = dispatch.kernel_fn("paged_attention")
    return fn(q, k_pages, v_pages, page_table, cache_len,
              logit_softcap=logit_softcap, scale=scale)


# --------------------------------------------------------------------------
# mamba-1 selective scan
# --------------------------------------------------------------------------

def selective_scan(x, dt, A, Bmat, Cmat, D, *, chunk=None, c_block=None,
                   return_state=False):
    res = dispatch.resolve("mamba_scan", device=x.device, chunk=chunk,
                           c_block=c_block)
    chunk = res.launch["chunk"]
    if return_state:  # the prefill variant: plain on every device
        return _scan_ref.selective_scan_chunked_ref(
            x, dt, A, Bmat, Cmat, D, chunk=chunk, return_state=True)

    def plain(*a):
        return _scan_ref.selective_scan_chunked_ref(*a, chunk=chunk)

    def kernel(*a):
        return res.impl(*a, chunk=chunk, c_block=res.launch["c_block"])

    fwd = plain if res.mode == dispatch.REF else kernel
    return recompute("selective_scan", fwd, plain, x, dt, A, Bmat, Cmat, D)


def selective_scan_step(h, x_t, dt_t, A, B_t, C_t, D):
    return _scan_ref.selective_scan_step_ref(h, x_t, dt_t, A, B_t, C_t, D)


# --------------------------------------------------------------------------
# mamba-2 SSD
# --------------------------------------------------------------------------

def ssd(x, dt, A, Bmat, Cmat, D, *, chunk=None, init_state=None,
        return_state=False):
    res = dispatch.resolve("ssd", device=x.device, chunk=chunk)
    chunk = res.launch["chunk"]
    if init_state is not None or return_state:  # continuation: plain
        return _ssd_ref.ssd_ref(x, dt, A, Bmat, Cmat, D, chunk=chunk,
                                init_state=init_state,
                                return_state=return_state)

    def plain(*a):
        return _ssd_ref.ssd_ref(*a, chunk=chunk)

    def kernel(*a):
        return res.impl(*a, chunk=chunk)

    fwd = plain if res.mode == dispatch.REF else kernel
    return recompute("ssd", fwd, plain, x, dt, A, Bmat, Cmat, D)


def ssd_step(state, x_t, dt_t, A, B_t, C_t, D):
    return _ssd_ref.ssd_step_ref(state, x_t, dt_t, A, B_t, C_t, D)


# --------------------------------------------------------------------------
# rmsnorm
# --------------------------------------------------------------------------

def rmsnorm(x, weight, *, eps=1e-5, residual=None, row_block=None):
    res = dispatch.resolve("rmsnorm", device=x.device, row_block=row_block)

    def plain(x, w, *r):
        return _rms_ref.rmsnorm_ref(x, w, eps=eps,
                                    residual=r[0] if r else None)

    def kernel(x, w, *r):
        return res.impl(x, w, eps=eps, residual=r[0] if r else None,
                        row_block=res.launch["row_block"])

    fwd = plain if res.mode == dispatch.REF else kernel
    inputs = (x, weight) + ((residual,) if residual is not None else ())
    return recompute("rmsnorm", fwd, plain, *inputs)
