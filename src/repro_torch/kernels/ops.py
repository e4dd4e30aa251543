"""Public kernel entry points — the port of the main-path ops of
:mod:`repro.kernels.ops` (``rmsnorm``, ``flash_attention``,
``decode_attention``, ``paged_decode_attention``; the SSM ops come with
their kernels in a later slice).

Each op resolves its family through :mod:`repro_torch.kernels.dispatch` for
the device its input lies on: a CPU tensor runs the plain PyTorch version, a
CUDA tensor the hand-written sm_90a kernel.  Launch parameters left as
``None`` resolve through the registry (an active tuned configuration wins,
then explicit call-site values, then the defaults).
"""

from __future__ import annotations

from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import ref as _attn_ref
from repro_torch.kernels.paged_attention import ref as _paged_ref
from repro_torch.kernels.rmsnorm import ref as _rms_ref


def flash_attention(q, k, v, *, causal=True, sliding_window=0,
                    logit_softcap=0.0, scale=None, q_offset=0, q_block=None,
                    kv_block=None):
    res = dispatch.resolve("flash_attention", device=q.device,
                           q_block=q_block, kv_block=kv_block)
    if res.mode == dispatch.REF:
        return _attn_ref.attention_blockwise_ref(
            q, k, v, causal=causal, sliding_window=sliding_window,
            logit_softcap=logit_softcap, scale=scale, q_offset=q_offset,
            kv_block=res.launch["kv_block"])
    return res.impl(
        q, k, v, causal=causal, sliding_window=sliding_window,
        logit_softcap=logit_softcap, scale=scale, q_offset=q_offset,
        q_block=res.launch["q_block"], kv_block=res.launch["kv_block"])


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


def rmsnorm(x, weight, *, eps=1e-5, residual=None, row_block=None):
    res = dispatch.resolve("rmsnorm", device=x.device, row_block=row_block)
    if res.mode == dispatch.REF:
        return _rms_ref.rmsnorm_ref(x, weight, eps=eps, residual=residual)
    return res.impl(x, weight, eps=eps, residual=residual,
                    row_block=res.launch["row_block"])
