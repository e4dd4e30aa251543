"""On an sm_90 card only: each CUDA kernel of the port against its plain
PyTorch version, and the recompute wrapper's gradients on the card (marked
``gpu``; skips without the card).  Imports no jax,
so it runs on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: fp32 atol 2e-5 / rtol 1e-4; bf16 2e-2 (both sides round their
fp32 results to bf16, at different points).
"""

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import kernel as tfk
from repro_torch.kernels.flash_attention import ref as tfr
from repro_torch.kernels.paged_attention import kernel as tpk
from repro_torch.kernels.paged_attention import ref as tpr
from repro_torch.kernels.rmsnorm import kernel as trk
from repro_torch.kernels.mamba_scan import kernel as tsk
from repro_torch.kernels.mamba_scan import ref as tsr
from repro_torch.kernels.rmsnorm import ref as trr
from repro_torch.kernels.ssd import kernel as tdk
from repro_torch.kernels.ssd import ref as tdr

FP32 = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture
def sm90():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the CUDA kernels are built for sm_90a")
    return torch.device("cuda")


def _cmp(out, ref, dtype):
    tol = FP32 if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain_versions(sm90, dtype):
    g = torch.Generator(device=sm90).manual_seed(0)

    def rnd(*s):
        return torch.randn(s, generator=g, device=sm90).to(dtype)

    x, w, r = rnd(3, 17, 64), rnd(64), rnd(3, 17, 64)
    _cmp(trk.rmsnorm_cuda(x, w, residual=r),
         trr.rmsnorm_ref(x, w, residual=r), dtype)
    q, k, v = rnd(2, 96, 8, 32), rnd(2, 96, 2, 32), rnd(2, 96, 2, 32)
    _cmp(tfk.flash_attention_cuda(q, k, v, sliding_window=9,
                                  logit_softcap=30.0),
         tfr.attention_blockwise_ref(q, k, v, sliding_window=9,
                                     logit_softcap=30.0), dtype)
    lens = torch.tensor([13, 140], dtype=torch.int32, device=sm90)
    qd, kc, vc = rnd(2, 1, 8, 32), rnd(2, 96, 2, 32), rnd(2, 96, 2, 32)
    _cmp(tfk.decode_attention_cuda(qd, kc, vc, lens),
         tfr.decode_attention_ref(qd, kc, vc, lens), dtype)
    kp, vp = rnd(9, 16, 2, 32), rnd(9, 16, 2, 32)
    table = torch.randperm(8, generator=g, device=sm90).to(
        torch.int32).reshape(2, 4)
    lens = torch.tensor([13, 64], dtype=torch.int32, device=sm90)
    _cmp(tpk.paged_decode_attention_cuda(qd, kp, vp, table, lens),
         tpr.paged_decode_attention_ref(qd, kp, vp, table, lens), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_kernels_and_head_dim_80_match_plain_versions(sm90, dtype):
    g = torch.Generator(device=sm90).manual_seed(1)

    def rnd(*s):
        return torch.randn(s, generator=g, device=sm90).to(dtype)

    def pos(*s):
        return (torch.rand(s, generator=g, device=sm90) * 0.1).to(dtype)

    q, k, v = rnd(1, 77, 8, 80), rnd(1, 77, 2, 80), rnd(1, 77, 2, 80)
    _cmp(tfk.flash_attention_cuda(q, k, v), tfr.attention_blockwise_ref(
        q, k, v), dtype)
    A = -torch.rand((100, 16), generator=g, device=sm90) * 4
    scan = (rnd(2, 50, 100), pos(2, 50, 100), A, rnd(2, 50, 16),
            rnd(2, 50, 16), rnd(100).float())
    _cmp(tsk.selective_scan_cuda(*scan, chunk=16, c_block=32),
         tsr.selective_scan_chunked_ref(*scan, chunk=16), dtype)
    A = -torch.rand((8,), generator=g, device=sm90) * 4
    ssd = (rnd(2, 70, 8, 32), pos(2, 70, 8), A, rnd(2, 70, 2, 16),
           rnd(2, 70, 2, 16), rnd(8).float())
    _cmp(tdk.ssd_cuda(*ssd, chunk=32), tdr.ssd_ref(*ssd, chunk=32), dtype)


@pytest.mark.gpu
def test_recompute_wrapper_gradients_on_the_card(sm90):
    g = torch.Generator(device=sm90).manual_seed(2)
    scan = [torch.randn((1, 40, 64), generator=g, device=sm90),
            torch.rand((1, 40, 64), generator=g, device=sm90) * 0.1,
            -torch.rand((64, 16), generator=g, device=sm90) * 4,
            torch.randn((1, 40, 16), generator=g, device=sm90),
            torch.randn((1, 40, 16), generator=g, device=sm90),
            torch.randn((64,), generator=g, device=sm90)]
    grads = []
    for fn in (lambda *a: ops.selective_scan(*a, chunk=16),
               lambda *a: tsr.selective_scan_chunked_ref(*a, chunk=16)):
        xs = [t.clone().requires_grad_() for t in scan]
        (fn(*xs) ** 2).sum().backward()
        grads.append([t.grad for t in xs])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 80, 128])
def test_tensor_core_prefill_matches_plain_version(sm90, d):
    g = torch.Generator(device=sm90).manual_seed(3)

    def rnd(*s):
        return torch.randn(s, generator=g, device=sm90).to(torch.bfloat16)

    for (sq, skv, kw) in ((77, 77, {}), (77, 200, {"causal": False}),
                          (50, 50, {"q_offset": -20}),
                          (120, 120, {"sliding_window": 13,
                                      "logit_softcap": 20.0})):
        q, k, v = rnd(2, sq, 8, d), rnd(2, skv, 2, d), rnd(2, skv, 2, d)
        ref = tfr.attention_blockwise_ref(q, k, v, **kw)
        for qb, kb in ((32, 32), (64, 64)):
            out = tfk.flash_attention_cuda(q, k, v, q_block=qb, kv_block=kb,
                                           **kw)
            _cmp(out, ref, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_decode_matches_split_oracle_and_paged_equals_dense(sm90,
                                                                  dtype):
    g = torch.Generator(device=sm90).manual_seed(4)

    def rnd(*s):
        return torch.randn(s, generator=g, device=sm90).to(dtype)

    b, ps, n_pages = 8, 64, 16
    cap = ps * n_pages
    n_split, rows = tfk.plan_decode_splits(
        cap, tpk.KV_TILE, b, 2, torch.cuda.get_device_properties(
            sm90).multi_processor_count)
    assert n_split > 1
    lens = torch.tensor([0, 1, rows, rows + 1, cap, cap + 50, 300, 777],
                        dtype=torch.int32, device=sm90)
    q, kc, vc = rnd(b, 1, 8, 64), rnd(b, cap, 2, 64), rnd(b, cap, 2, 64)
    out = tfk.decode_attention_cuda(q, kc, vc, lens, kv_block=tpk.KV_TILE)
    _cmp(out, tfr.decode_attention_split_ref(q, kc, vc, lens,
                                             split_rows=rows), dtype)
    kp = torch.cat([kc.reshape(b * n_pages, ps, 2, 64),
                    torch.zeros((1, ps, 2, 64), dtype=dtype, device=sm90)])
    vp = torch.cat([vc.reshape(b * n_pages, ps, 2, 64),
                    torch.zeros((1, ps, 2, 64), dtype=dtype, device=sm90)])
    table = torch.arange(b * n_pages, dtype=torch.int32,
                         device=sm90).reshape(b, n_pages)
    paged = tpk.paged_decode_attention_cuda(q, kp, vp, table, lens)
    assert torch.equal(paged, out)
