"""The port's decode and paged decode attention on the CPU: each plain
PyTorch version against the JAX reference's oracle AND against the Pallas
kernel in ``interpret=True`` mode, on the shapes of ``tests/test_kernels.py``
and the permuted-pool cases of ``tests/test_paged.py``.

Tolerances: fp32 atol 2e-5 / rtol 1e-4, as the reference's own kernel tests
hold the Pallas kernels to their oracle; the paged oracle equals the dense
one bit for bit, as in the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as jfk
from repro.kernels.flash_attention import ref as jfr
from repro.kernels.paged_attention import kernel as jpk
from repro.kernels.paged_attention import ref as jpr
from repro_torch.kernels.flash_attention import ref as tfr
from repro_torch.kernels.paged_attention import ref as tpr

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
# decode attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sw", [0, 9])
@pytest.mark.parametrize("cap", [0.0, 20.0])
def test_decode_plain_matches_reference_and_pallas(sw, cap):
    q, kc, vc = arrays(7, (2, 1, 8, 32), (2, 80, 2, 32), (2, 80, 2, 32))
    clen = np.asarray([13, 77], np.int32)
    kw = dict(sliding_window=sw, logit_softcap=cap)
    ref = np.array(jfr.decode_attention_ref(J(q), J(kc), J(vc), J(clen), **kw))
    pal = np.array(jfk.decode_attention_pallas(
        J(q), J(kc), J(vc), J(clen), kv_block=32, interpret=True, **kw))
    out = tfr.decode_attention_ref(T(q), T(kc), T(vc), T(clen), **kw).numpy()
    np.testing.assert_allclose(out, ref, **FP32)
    np.testing.assert_allclose(out, pal, **FP32)


def test_decode_length_past_cache_matches_reference():
    # an empty batcher slot's length runs past the cache: every row is valid
    q, kc, vc = arrays(8, (2, 1, 4, 16), (2, 24, 2, 16), (2, 24, 2, 16))
    clen = np.asarray([30, 7], np.int32)
    ref = np.array(jfr.decode_attention_ref(J(q), J(kc), J(vc), J(clen)))
    out = tfr.decode_attention_ref(T(q), T(kc), T(vc), T(clen)).numpy()
    np.testing.assert_allclose(out, ref, **FP32)


# --------------------------------------------------------------------------
# paged decode attention
# --------------------------------------------------------------------------

def _paged_layout(k_cache, v_cache, page_size, perm=None):
    """Scatter a dense (B, L, Hkv, D) cache into a paged pool (the
    reference test's layout helper, in numpy)."""
    b, l, hkv, d = k_cache.shape
    n_pages = l // page_size
    order = np.arange(b * n_pages) if perm is None else np.asarray(perm)
    k_pages = np.zeros((b * n_pages, page_size, hkv, d), np.float32)
    v_pages = np.zeros_like(k_pages)
    table = np.zeros((b, n_pages), np.int32)
    for bi in range(b):
        for p in range(n_pages):
            pid = int(order[bi * n_pages + p])
            k_pages[pid] = k_cache[bi, p * page_size:(p + 1) * page_size]
            v_pages[pid] = v_cache[bi, p * page_size:(p + 1) * page_size]
            table[bi, p] = pid
    return k_pages, v_pages, table


@pytest.mark.parametrize("b,l,ps,lens,perm_seed", [
    (3, 16, 16, [5, 16, 1], None),      # one full page, identity table
    (2, 32, 8, [19, 32], 3),            # permuted multi-page pool
])
def test_paged_plain_is_dense_bit_for_bit(b, l, ps, lens, perm_seed):
    q, kc, vc = arrays(9, (b, 1, 4, 8), (b, l, 2, 8), (b, l, 2, 8))
    perm = (None if perm_seed is None else
            np.random.default_rng(perm_seed).permutation(b * (l // ps)))
    kp, vp, table = _paged_layout(kc, vc, ps, perm)
    lens = np.asarray(lens, np.int32)
    np.testing.assert_array_equal(
        tpr.gather_pages(T(kp), T(table)).numpy(), kc)
    out = tpr.paged_decode_attention_ref(T(q), T(kp), T(vp), T(table),
                                         T(lens)).numpy()
    dense = tfr.decode_attention_ref(T(q), T(kc), T(vc), T(lens)).numpy()
    np.testing.assert_array_equal(out, dense)
    ref = np.array(jpr.paged_decode_attention_ref(J(q), J(kp), J(vp),
                                                  J(table), J(lens)))
    np.testing.assert_allclose(out, ref, **FP32)


@pytest.mark.parametrize("cap", [0.0, 5.0])
def test_paged_plain_matches_pallas(cap):
    q, kc, vc = arrays(10, (2, 1, 4, 16), (2, 32, 2, 16), (2, 32, 2, 16))
    kp, vp, table = _paged_layout(
        kc, vc, 8, np.random.default_rng(5).permutation(8))
    lens = np.asarray([13, 27], np.int32)
    pal = np.array(jpk.paged_decode_attention_pallas(
        J(q), J(kp), J(vp), J(table), J(lens), logit_softcap=cap,
        interpret=True))
    ref = np.array(jpr.paged_decode_attention_ref(
        J(q), J(kp), J(vp), J(table), J(lens), logit_softcap=cap))
    out = tpr.paged_decode_attention_ref(T(q), T(kp), T(vp), T(table),
                                         T(lens), logit_softcap=cap).numpy()
    np.testing.assert_allclose(out, pal, **FP32)
    np.testing.assert_allclose(out, ref, **FP32)
