"""The port's kernels on the CPU: each plain PyTorch version against the JAX
reference's oracle AND against the Pallas kernel run in ``interpret=True``
mode, on the shapes of ``tests/test_kernels.py`` and the permuted-pool cases
of ``tests/test_paged.py``: RMSNorm and prefill attention here, decode
and paged decode in ``test_torch_decode_kernels.py``, dispatch routing in
``test_torch_dispatch.py``.  The CUDA kernels themselves are held against
these plain versions on the card by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.

Tolerances: fp32 paths agree to atol 2e-5 / rtol 1e-4, as the reference's
own kernel tests hold the Pallas kernels to their oracle; bf16 to 2e-2;
the paged oracle equals the dense one bit for bit, as in the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as jfk
from repro.kernels.flash_attention import ref as jfr
from repro.kernels.rmsnorm import kernel as jrk
from repro.kernels.rmsnorm import ref as jrr
from repro_torch.kernels.flash_attention import ref as tfr
from repro_torch.kernels.rmsnorm import ref as trr

# tiny shapes: one intra-op thread per test process, so parallel test
# workers do not oversubscribe the CPU under wall-clock-timed tests
torch.set_num_threads(1)

FP32 = dict(atol=2e-5, rtol=1e-4)


def arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(a)


# --------------------------------------------------------------------------
# rmsnorm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 64), (3, 17, 64), (2, 5, 7, 32)])
@pytest.mark.parametrize("residual", [False, True])
def test_rmsnorm_plain_matches_reference_and_pallas(shape, residual):
    x, w, r = arrays(0, shape, shape[-1:], shape)
    r = r if residual else None
    out = trr.rmsnorm_ref(T(x), T(w), eps=1e-5,
                          residual=T(r) if residual else None).numpy()
    ref = jrr.rmsnorm_ref(J(x), J(w), eps=1e-5,
                          residual=J(r) if residual else None)
    pal = jrk.rmsnorm_pallas(J(x), J(w), eps=1e-5,
                             residual=J(r) if residual else None,
                             row_block=8, interpret=True)
    np.testing.assert_allclose(out, np.array(ref), **FP32)
    np.testing.assert_allclose(out, np.array(pal), **FP32)


def test_rmsnorm_bf16_matches_reference():
    x, w = arrays(1, (6, 2048), (2048,))
    out = trr.rmsnorm_ref(T(x).bfloat16(), T(w).bfloat16())
    ref = jrr.rmsnorm_ref(J(x).astype(jnp.bfloat16), J(w).astype(jnp.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.array(ref.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


# --------------------------------------------------------------------------
# prefill attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b,sq,skv,hq,hkv,d", [
    (1, 16, 16, 2, 2, 8),       # MHA, tiny
    (2, 96, 96, 8, 2, 32),      # GQA g=4, unaligned seq
    (1, 33, 65, 4, 1, 16),      # MQA, ragged (padding path)
])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_plain_matches_reference_and_pallas(b, sq, skv, hq, hkv, d,
                                                      causal):
    q, k, v = arrays(2, (b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))
    ref = np.array(jfr.attention_ref(J(q), J(k), J(v), causal=causal))
    pal = np.array(jfk.flash_attention_pallas(
        J(q), J(k), J(v), causal=causal, q_block=16, kv_block=16,
        interpret=True))
    plain = tfr.attention_ref(T(q), T(k), T(v), causal=causal).numpy()
    blockwise = tfr.attention_blockwise_ref(T(q), T(k), T(v), causal=causal,
                                            kv_block=16).numpy()
    for out in (plain, blockwise):
        np.testing.assert_allclose(out, ref, **FP32)
        np.testing.assert_allclose(out, pal, **FP32)


@pytest.mark.parametrize("sw,cap", [(0, 0.0), (7, 0.0), (0, 20.0), (9, 30.0)])
def test_attention_window_softcap(sw, cap):
    q, k, v = arrays(3, (2, 48, 4, 16), (2, 48, 2, 16), (2, 48, 2, 16))
    kw = dict(causal=True, sliding_window=sw, logit_softcap=cap)
    ref = np.array(jfr.attention_ref(J(q), J(k), J(v), **kw))
    pal = np.array(jfk.flash_attention_pallas(
        J(q), J(k), J(v), q_block=16, kv_block=16, interpret=True, **kw))
    out = tfr.attention_blockwise_ref(T(q), T(k), T(v), kv_block=16,
                                      **kw).numpy()
    np.testing.assert_allclose(out, ref, **FP32)
    np.testing.assert_allclose(out, pal, **FP32)


def test_attention_q_offset_matches_reference():
    q, k, v = arrays(4, (1, 16, 4, 16), (1, 48, 2, 16), (1, 48, 2, 16))
    ref = np.array(jfr.attention_ref(J(q), J(k), J(v), q_offset=32))
    out = tfr.attention_blockwise_ref(T(q), T(k), T(v), q_offset=32,
                                      kv_block=16).numpy()
    np.testing.assert_allclose(out, ref, **FP32)


def test_fully_masked_rows_kernel_semantics_vs_oracle():
    # rows 0-3 see no key (q_offset=-4, causal).  The kernels — the Pallas
    # kernel and the port's CUDA kernel — give 0 there; the blockwise plain
    # version does the same; the one-shot oracle gives a uniform softmax, as
    # the JAX oracle does.  Decode never hits this (cache_len >= 1).
    q, k, v = arrays(5, (1, 8, 2, 8), (1, 8, 2, 8), (1, 8, 2, 8))
    pal = np.array(jfk.flash_attention_pallas(
        J(q), J(k), J(v), q_offset=-4, q_block=8, kv_block=8, interpret=True))
    block = tfr.attention_blockwise_ref(T(q), T(k), T(v), q_offset=-4,
                                        kv_block=8).numpy()
    oracle = tfr.attention_ref(T(q), T(k), T(v), q_offset=-4).numpy()
    np.testing.assert_array_equal(block[:, :4], 0.0)
    np.testing.assert_allclose(block, pal, **FP32)
    np.testing.assert_allclose(oracle, np.array(jfr.attention_ref(
        J(q), J(k), J(v), q_offset=-4)), **FP32)
    np.testing.assert_allclose(oracle[:, :4], np.broadcast_to(
        v.mean(axis=1, keepdims=True), (1, 4, 2, 8)), **FP32)


def test_attention_bf16_matches_reference():
    q, k, v = arrays(6, (1, 32, 4, 16), (1, 32, 2, 16), (1, 32, 2, 16))
    ref = jfr.attention_ref(*(J(a).astype(jnp.bfloat16) for a in (q, k, v)))
    out = tfr.attention_blockwise_ref(*(T(a).bfloat16() for a in (q, k, v)),
                                      kv_block=16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.array(ref.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)
