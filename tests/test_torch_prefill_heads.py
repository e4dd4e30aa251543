"""The prefill wrapper's shape checks on the CPU, on ``meta`` tensors (no
data, no card): the (Q/K, V) head-dim pairs the CUDA kernel is built for —
equal dims and MLA's (192, 128) and (16, 8) — reach the C entry point with
both dims and an output Dv wide; other pairs and mismatched K/V are
refused.  The plain version on the CPU against the reference's oracle at
the MLA pairs, fp32 1e-5."""

import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ref as jfr
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.flash_attention import kernel as tfk

torch.set_num_threads(1)


class _FakeLib:
    """Records the prefill entry point's arguments instead of launching."""

    def __init__(self):
        self.calls = []

    def repro_flash_attention(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(cuda_lib, "LAUNCHES", dict(cuda_lib.LAUNCHES))
    monkeypatch.setattr(cuda_lib, "library", lambda: lib)
    monkeypatch.setattr(cuda_lib, "require", lambda *a, **k: None)
    monkeypatch.setattr(cuda_lib, "require_aligned", lambda *a, **k: None)
    monkeypatch.setattr(cuda_lib, "stream_of", lambda t: 0)
    return lib


def _meta(*shape):
    return torch.empty(shape, device="meta", dtype=torch.bfloat16)


@pytest.mark.parametrize("d,dv", tfk.PREFILL_HEAD_DIMS)
def test_every_instantiated_pair_reaches_the_kernel_dv_wide(fake_card, d,
                                                            dv):
    q, k, v = _meta(2, 40, 8, d), _meta(2, 56, 4, d), _meta(2, 56, 4, dv)
    out = tfk.flash_attention_cuda(q, k, v, q_block=64, kv_block=64)
    assert out.shape == (2, 40, 8, dv) and out.dtype == torch.bfloat16
    (args,) = fake_card.calls
    # q, k, v, o, B, Sq, Skv, Hq, Hkv, D, Dv, ...
    assert args[4:11] == (2, 40, 56, 8, 4, d, dv)
    # the default scale is Q/K's, as the reference's
    assert args[14] == pytest.approx(d ** -0.5)
    assert cuda_lib.LAUNCHES["flash_attention"] == 1


def test_mla_pairs_are_instantiated():
    assert {(192, 128), (16, 8)} <= set(tfk.PREFILL_HEAD_DIMS)


@pytest.mark.parametrize("kshape,vshape", [
    ((2, 56, 4, 192), (2, 56, 4, 64)),    # a pair not instantiated
    ((2, 56, 4, 192), (2, 50, 4, 128)),   # K and V rows differ
    ((2, 56, 2, 192), (2, 56, 4, 128)),   # K and V heads differ
    ((2, 56, 4, 128), (2, 56, 4, 128)),   # K's head dim is not Q's
])
def test_mismatched_shapes_are_refused(fake_card, kshape, vshape):
    with pytest.raises(ValueError, match="flash_attention"):
        tfk.flash_attention_cuda(_meta(2, 40, 8, 192), _meta(*kshape),
                                 _meta(*vshape))
    assert not fake_card.calls


@pytest.mark.parametrize("d,dv", [(192, 128), (16, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_matches_the_reference_at_mla_pairs(d, dv, causal):
    rng = np.random.default_rng(d)
    q = rng.normal(size=(1, 24, 4, d)).astype(np.float32)
    k = rng.normal(size=(1, 30, 4, d)).astype(np.float32)
    v = rng.normal(size=(1, 30, 4, dv)).astype(np.float32)
    ref = np.array(jfr.attention_blockwise_ref(q, k, v, causal=causal,
                                               kv_block=8))
    out = tfk.flash_attention_cuda(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal,
                                   kv_block=8)
    assert out.shape == (1, 24, 4, dv)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
