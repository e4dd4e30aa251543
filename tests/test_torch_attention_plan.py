"""The split decode's host-side logic on the CPU: the split planner, the
wrappers' use of it (on ``meta`` tensors, which hold no data, so a host
read of the lengths would raise), and the plain split oracle
``decode_attention_split_ref`` against the port's and the JAX reference's
decode oracles and the Pallas decode kernel in ``interpret=True`` mode.

Tolerances: fp32 atol 1e-6 / rtol 1e-6 — the split oracle sums the same
terms as the one-pass softmax in another grouping (per split, then across
splits), a few ulps apart.  Paged against dense through the split oracle:
bit for bit.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as jfk
from repro.kernels.flash_attention import ref as jfr
from repro.kernels.paged_attention import ref as jpr
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.flash_attention import kernel as tfk
from repro_torch.kernels.flash_attention import ref as tfr
from repro_torch.kernels.paged_attention import kernel as tpk
from repro_torch.kernels.paged_attention import ref as tpr

torch.set_num_threads(1)

TIGHT = dict(atol=1e-6, rtol=1e-6)


def arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(a)


# --------------------------------------------------------------------------
# the planner
# --------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [1, 40, 64, 96, 512, 2048, 4096, 5000])
@pytest.mark.parametrize("kv_block", [32, 64])
@pytest.mark.parametrize("batch,kv_heads", [(1, 1), (4, 8), (16, 8), (32, 8)])
def test_plan_covers_the_capacity_in_whole_tiles(capacity, kv_block, batch,
                                                 kv_heads):
    n_split, rows = tfk.plan_decode_splits(capacity, kv_block, batch,
                                           kv_heads, 132)
    assert n_split >= 1 and rows >= kv_block and rows % kv_block == 0
    ranges = [(s * rows, min((s + 1) * rows, capacity))
              for s in range(n_split)]
    covered = [r for lo, hi in ranges for r in range(lo, hi)]
    assert covered == list(range(capacity))  # no gap, no overlap, in order
    assert all(hi > lo for lo, hi in ranges)  # no empty split
    n_tiles = -(-capacity // kv_block)
    assert n_split <= n_tiles
    # about DECODE_BLOCKS_PER_SM blocks per SM: more splits only while under it
    if n_split > 1:
        assert batch * kv_heads * (n_split - 1) < tfk.DECODE_BLOCKS_PER_SM * 132


def test_plan_takes_shapes_only():
    params = inspect.signature(tfk.plan_decode_splits).parameters
    assert list(params) == ["capacity", "kv_block", "batch", "kv_heads",
                            "sm_count"]
    # a small card and a large batch: one split; a large card: many
    assert tfk.plan_decode_splits(512, 64, 512, 8, 16) == (1, 512)
    assert tfk.plan_decode_splits(512, 64, 1, 1, 132) == (8, 64)


class _FakeLib:
    """Records each C entry point's arguments instead of launching."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def entry(*args):
            self.calls[name] = args
            return 0
        return entry


@pytest.fixture
def fake_card(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(cuda_lib, "LAUNCHES", dict(cuda_lib.LAUNCHES))
    monkeypatch.setattr(cuda_lib, "library", lambda: lib)
    monkeypatch.setattr(cuda_lib, "require", lambda *a, **k: None)
    monkeypatch.setattr(cuda_lib, "require_aligned", lambda *a, **k: None)
    monkeypatch.setattr(cuda_lib, "stream_of", lambda t: 0)
    monkeypatch.setattr(cuda_lib, "sm_count", lambda dev: 132)
    monkeypatch.setattr(cuda_lib, "decode_scratch",
                        lambda dev, n, c: (torch.empty(n, device="meta"),
                                           torch.empty(c, device="meta")))
    return lib


@pytest.mark.parametrize("b,ps,n_pages", [(4, 64, 8), (16, 64, 64),
                                          (3, 16, 5)])
def test_dense_and_paged_wrappers_split_alike_without_reading_lengths(
        fake_card, b, ps, n_pages):
    meta = dict(device="meta", dtype=torch.bfloat16)
    hq, hkv, d = 32, 8, 64
    cap = n_pages * ps
    q = torch.empty((b, 1, hq, d), **meta)
    # meta lengths hold no values: a host read would raise
    lens = torch.empty((b,), device="meta", dtype=torch.int32)
    kc = torch.empty((b, cap, hkv, d), **meta)
    tfk.decode_attention_cuda(q, kc, kc, lens, kv_block=tpk.KV_TILE)
    kp = torch.empty((b * n_pages + 1, ps, hkv, d), **meta)
    table = torch.empty((b, n_pages), device="meta", dtype=torch.int32)
    tpk.paged_decode_attention_cuda(q, kp, kp, table, lens)
    dense = fake_card.calls["repro_decode_attention"]
    paged = fake_card.calls["repro_paged_decode_attention"]
    # kv_block, n_split, split_rows sit just before the scratch pointers
    plan = tfk.plan_decode_splits(cap, tpk.KV_TILE, b, hkv, 132)
    assert dense[13:16] == (tpk.KV_TILE, *plan)
    assert paged[14:17] == (tpk.KV_TILE, *plan)
    assert cuda_lib.LAUNCHES["decode_attention"] == 1
    assert cuda_lib.LAUNCHES["paged_decode_attention"] == 1


# --------------------------------------------------------------------------
# the split oracle
# --------------------------------------------------------------------------

def _split_rows(cap, kv_block=16, batch=3, kv_heads=2, sm=2):
    n_split, rows = tfk.plan_decode_splits(cap, kv_block, batch, kv_heads, sm)
    assert n_split > 1  # the cases below split the KV axis
    return rows


@pytest.mark.parametrize("sw", [0, 9])
@pytest.mark.parametrize("cap", [0.0, 20.0])
def test_split_oracle_matches_the_decode_oracles(sw, cap):
    # lengths: one row, mid-cache, exactly the capacity, past it
    q, kc, vc = arrays(11, (4, 1, 8, 32), (4, 80, 2, 32), (4, 80, 2, 32))
    clen = np.asarray([1, 37, 80, 85], np.int32)
    kw = dict(sliding_window=sw, logit_softcap=cap)
    rows = _split_rows(80, batch=4)
    out = tfr.decode_attention_split_ref(T(q), T(kc), T(vc), T(clen),
                                         split_rows=rows, **kw).numpy()
    port = tfr.decode_attention_ref(T(q), T(kc), T(vc), T(clen), **kw).numpy()
    ref = np.array(jfr.decode_attention_ref(J(q), J(kc), J(vc), J(clen), **kw))
    np.testing.assert_allclose(out, port, **TIGHT)
    np.testing.assert_allclose(out, ref, **TIGHT)


def test_split_oracle_gives_zero_for_an_empty_slot_as_the_pallas_kernel():
    q, kc, vc = arrays(12, (3, 1, 4, 16), (3, 64, 2, 16), (3, 64, 2, 16))
    clen = np.asarray([0, 17, 64], np.int32)
    rows = _split_rows(64)
    out = tfr.decode_attention_split_ref(T(q), T(kc), T(vc), T(clen),
                                         split_rows=rows).numpy()
    pal = np.array(jfk.decode_attention_pallas(
        J(q), J(kc), J(vc), J(clen), kv_block=16, interpret=True))
    np.testing.assert_array_equal(out[0], 0.0)
    np.testing.assert_allclose(out, pal, atol=2e-5, rtol=1e-4)
    ref = np.array(jfr.decode_attention_ref(J(q), J(kc), J(vc), J(clen)))
    np.testing.assert_allclose(out[1:], ref[1:], **TIGHT)


@pytest.mark.parametrize("cap", [0.0, 5.0])
def test_split_oracle_over_paged_tables_is_dense_bit_for_bit(cap):
    b, ps, n_pages, hkv, d = 3, 16, 4, 2, 16
    q, kc, vc = arrays(13, (b, 1, 4, d), (b, ps * n_pages, hkv, d),
                       (b, ps * n_pages, hkv, d))
    perm = np.random.default_rng(4).permutation(b * n_pages)
    kp = np.zeros((b * n_pages, ps, hkv, d), np.float32)
    vp = np.zeros_like(kp)
    table = perm.reshape(b, n_pages).astype(np.int32)
    for bi in range(b):
        for p in range(n_pages):
            kp[table[bi, p]] = kc[bi, p * ps:(p + 1) * ps]
            vp[table[bi, p]] = vc[bi, p * ps:(p + 1) * ps]
    clen = np.asarray([5, 33, 70], np.int32)  # the last past the capacity
    rows = _split_rows(ps * n_pages)
    paged = tfr.decode_attention_split_ref(
        T(q), tpr.gather_pages(T(kp), T(table)),
        tpr.gather_pages(T(vp), T(table)), T(clen), split_rows=rows,
        logit_softcap=cap).numpy()
    dense = tfr.decode_attention_split_ref(
        T(q), T(kc), T(vc), T(clen), split_rows=rows,
        logit_softcap=cap).numpy()
    np.testing.assert_array_equal(paged, dense)
    ref = np.array(jpr.paged_decode_attention_ref(
        J(q), J(kp), J(vp), J(table), J(clen), logit_softcap=cap))
    np.testing.assert_allclose(paged, ref, **TIGHT)
