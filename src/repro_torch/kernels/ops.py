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
stream.  The SSD's backward differentiates the scalar <y, dy>
(``ssd_ref(..., cotangent=dy)``) instead of ``y``: its two output
products are linear, and contracting them with dy first leaves the
backward no product whose value it does not read (the reference's XLA
prunes them from its compiled backward).

The continuation variants (``selective_scan(..., return_state=True)``,
``ssd(..., init_state=..., return_state=...)``), which serving's prefill
calls, resolve like the plain calls: a CUDA tensor launches the kernel,
which also writes the final state (and the SSD reads the initial one), a
CPU tensor runs the plain version.  The reference sends them to its oracle
on every device (``repro/kernels/ops.py:160-165``, ``:191-196``); the
function is the same.  They take no gradient (serving runs under
``torch.no_grad()``): an input that requires one raises.  The decode steps
(``selective_scan_step``, ``ssd_step``) are plain PyTorch on every
device, as in the reference, which has no Pallas kernel for them either.

Mixed dtypes.  The reference's ``flash_attention`` and ``rmsnorm`` take
operands of different float dtypes (the stub frontends' fp32 inputs meet
a bf16 model): its Pallas kernels read every operand as fp32 and write
``q.dtype`` / ``x.dtype``, and so do its plain versions.  Each kernel here
is instantiated for one dtype, so :func:`flash_attention` and
:func:`rmsnorm` cast the operands to the widest of their dtypes before
dispatch (fp32 operands launch the fp32 instance) and return ``q``'s /
``x``'s dtype.

Kernel scopes.  Each public entry point runs its body inside a named
kernel scope (:func:`_scoped`), and the recompute backward runs in
``<name>_bwd`` — the counterpart of the reference's ``KERNEL_SCOPE``
named scope (``repro/kernels/ops.py:42-51``).  The cost analysis of
:mod:`repro_torch.launch.hlo_analysis` listens to the scopes while it
traces a step: the ops inside one count as one kernel, their FLOPs in
full and only the scope's boundary bytes.  With no listener a scope is
one attribute read on the host: no device op, no host read, so the
captured decode step is unchanged.  The per-step decode variants
(``selective_scan_step``, ``ssd_step``) take no scope, as in the
reference, which has no kernel for them either.
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, Dict, Optional

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


class _ScopeListener(threading.local):
    #: the listening cost counter on this thread, or None
    counter = None


#: the cost counter that listens to the kernel scopes on this thread
#: (:class:`repro_torch.launch.hlo_analysis.OpCounter` while it traces a
#: step); ``KERNEL_SCOPE.counter`` is None when nothing listens
KERNEL_SCOPE = _ScopeListener()


def _scoped(name: str, body: Callable, *args, **kwargs):
    """``body(*args, **kwargs)`` inside the kernel scope ``name``: handed to
    the listening counter, if there is one (it sees the scope's tensor
    arguments and results as its boundary), else called as it is."""
    counter = KERNEL_SCOPE.counter
    if counter is None:
        return body(*args, **kwargs)
    return counter.scoped(name, body, args, kwargs)


class _Recompute(torch.autograd.Function):
    """``forward(*inputs)`` now, ``plain(*inputs)`` recomputed and
    differentiated in the backward; only the inputs are saved.  With
    ``dot`` (``dot(dy, *inputs)``: the scalar <plain(*inputs), dy>) the
    backward differentiates that instead, and forms no output whose value
    the gradient does not read."""

    @staticmethod
    def forward(ctx, name: str, forward: Callable, plain: Callable,
                dot: Optional[Callable], *inputs):
        ctx.name, ctx.plain, ctx.dot = name, plain, dot
        ctx.save_for_backward(*inputs)
        return forward(*inputs)

    @staticmethod
    def backward(ctx, dy):
        needs = ctx.needs_input_grad[4:]
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, needs)]
        wanted = [t for t, need in zip(inputs, needs) if need]

        def plain_grads(dy, *xs):  # xs: ``inputs``, the scope's boundary
            with torch.enable_grad():
                if ctx.dot is not None:
                    return torch.autograd.grad(ctx.dot(dy, *xs), wanted,
                                               allow_unused=True)
                y = ctx.plain(*xs)
            return torch.autograd.grad(y, wanted, dy, allow_unused=True)

        # the profiler range lets a trace attribute the recompute's device
        # time (a no-op when no profiler runs)
        with torch.profiler.record_function(f"recompute_bwd.{ctx.name}"):
            grads = iter(_scoped(f"{ctx.name}_bwd", plain_grads, dy,
                                 *inputs))
        RECOMPUTES[ctx.name] += 1
        return (None, None, None, None) + tuple(
            next(grads) if need else None for need in needs)


def _no_grad_asked(name: str, *inputs) -> None:
    """The continuation variants have no backward: refuse a call that could
    ask for one."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{name} with a carried state takes no gradient (serving runs it "
            f"under torch.no_grad()); an input requires grad")


def recompute(name: str, forward: Callable, plain: Callable, *inputs,
              dot: Optional[Callable] = None):
    """``forward(*inputs)`` in the kernel scope ``name``, differentiable
    through ``plain`` (or ``dot``, :class:`_Recompute`'s) when grad is on
    and any input requires it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _scoped(name, _Recompute.apply, name, forward, plain, dot,
                       *inputs)
    return _scoped(name, forward, *inputs)


def _widest(*tensors: torch.Tensor) -> torch.dtype:
    return functools.reduce(torch.promote_types, (t.dtype for t in tensors))


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
    wide = _widest(q, k, v)
    return recompute("flash_attention", fwd, plain, q.to(wide), k.to(wide),
                     v.to(wide)).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, sliding_window=0,
                     logit_softcap=0.0, scale=None, kv_block=None):
    res = dispatch.resolve("flash_attention", device=q.device,
                           kv_block=kv_block)
    kw = dict(sliding_window=sliding_window, logit_softcap=logit_softcap,
              scale=scale)
    if res.mode == dispatch.REF:
        return _scoped("decode_attention", _attn_ref.decode_attention_ref,
                       q, k_cache, v_cache, cache_len, **kw)
    fn = dispatch.kernel_fn("flash_attention", variant="decode")
    return _scoped("decode_attention", fn, q, k_cache, v_cache, cache_len,
                   kv_block=res.launch["kv_block"], **kw)


def paged_decode_attention(q, k_pages, v_pages, page_table, cache_len, *,
                           logit_softcap=0.0, scale=None):
    """Single-token decode over a block-paged KV pool.  The family's launch
    options shape the pool the caller built, not this call; resolving the
    family still records the decision for the dispatch audit."""
    res = dispatch.resolve("paged_attention", device=q.device)
    fn = (_paged_ref.paged_decode_attention_ref if res.mode == dispatch.REF
          else dispatch.kernel_fn("paged_attention"))
    return _scoped("paged_decode_attention", fn, q, k_pages, v_pages,
                   page_table, cache_len, logit_softcap=logit_softcap,
                   scale=scale)


# --------------------------------------------------------------------------
# mamba-1 selective scan
# --------------------------------------------------------------------------

def selective_scan(x, dt, A, Bmat, Cmat, D, *, chunk=None, c_block=None,
                   return_state=False):
    res = dispatch.resolve("mamba_scan", device=x.device, chunk=chunk,
                           c_block=c_block)
    chunk = res.launch["chunk"]

    def plain(*a, **kw):
        return _scan_ref.selective_scan_chunked_ref(*a, chunk=chunk, **kw)

    def kernel(*a, **kw):
        return res.impl(*a, chunk=chunk, c_block=res.launch["c_block"], **kw)

    fwd = plain if res.mode == dispatch.REF else kernel
    inputs = (x, dt, A, Bmat, Cmat, D)
    if return_state:  # serving's prefill: y and the final state
        _no_grad_asked("selective_scan", *inputs)
        return _scoped("selective_scan", fwd, *inputs, return_state=True)
    return recompute("selective_scan", fwd, plain, *inputs)


def selective_scan_step(h, x_t, dt_t, A, B_t, C_t, D):
    return _scan_ref.selective_scan_step_ref(h, x_t, dt_t, A, B_t, C_t, D)


# --------------------------------------------------------------------------
# mamba-2 SSD
# --------------------------------------------------------------------------

def ssd(x, dt, A, Bmat, Cmat, D, *, chunk=None, init_state=None,
        return_state=False):
    res = dispatch.resolve("ssd", device=x.device, chunk=chunk)
    chunk = res.launch["chunk"]

    def plain(*a, **kw):
        return _ssd_ref.ssd_ref(*a, chunk=chunk, **kw)

    def kernel(*a, **kw):
        return res.impl(*a, chunk=chunk, **kw)

    fwd = plain if res.mode == dispatch.REF else kernel
    inputs = (x, dt, A, Bmat, Cmat, D)
    if init_state is not None or return_state:  # a carried state
        _no_grad_asked("ssd", *inputs, init_state)
        return _scoped("ssd", fwd, *inputs, init_state=init_state,
                       return_state=return_state)

    def dot(dy, *a):
        return _ssd_ref.ssd_ref(*a, chunk=chunk, cotangent=dy)

    return recompute("ssd", fwd, plain, *inputs, dot=dot)


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
    wide = _widest(*inputs)
    return recompute("rmsnorm", fwd, plain,
                     *(t.to(wide) for t in inputs)).to(x.dtype)
