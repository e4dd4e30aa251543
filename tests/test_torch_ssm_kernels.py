"""The port's SSM kernels on the CPU: the plain Mamba-1 selective scan and
Mamba-2 SSD (sequence, chunked, final / initial state and single-step
forms) against the JAX reference's oracles AND against the Pallas kernels
run in ``interpret=True`` mode, on the shapes of ``tests/test_kernels.py``;
the recompute ``autograd.Function`` of :mod:`repro_torch.kernels.ops`
against ``jax.grad`` of the reference's ops; and the scan's launch plan
at the training width.  The CUDA kernels themselves are held against these
plain versions on the card by ``chip_smoke.py`` and
``tests/test_torch_gpu.py``.

Tolerances: fp32 atol 1e-4 / rtol 1e-3, as the reference's own tests hold
its Pallas scan and SSD kernels to their oracles (both sides sum in fp32,
in different orders: a log-step scan here, ``associative_scan`` there);
gradients atol 2e-4 / rtol 1e-3, as the reference's grad test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.mamba_scan import ref as jsr
from repro.kernels.mamba_scan.kernel import selective_scan_pallas
from repro.kernels.ssd import ref as jdr
from repro.kernels.ssd.kernel import ssd_pallas
from repro_torch.kernels import cuda_lib, dispatch, ops
from repro_torch.kernels.mamba_scan import kernel as tsk
from repro_torch.kernels.mamba_scan import ref as tsr
from repro_torch.kernels.ssd import kernel as tdk
from repro_torch.kernels.ssd import ref as tdr

torch.set_num_threads(1)

FP32 = dict(atol=1e-4, rtol=1e-3)
GRAD = dict(atol=2e-4, rtol=1e-3)


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(a)


def scan_inputs(seed, b, l, c, n, dt_scale=0.1):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return (f(b, l, c), np.abs(f(b, l, c)) * dt_scale, -np.abs(f(c, n)),
            f(b, l, n), f(b, l, n), f(c))


def ssd_inputs(seed, b, l, h, p, g, n):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return (f(b, l, h, p), np.abs(f(b, l, h)) * 0.1, -np.abs(f(h)),
            f(b, l, g, n), f(b, l, g, n), f(h))


# --------------------------------------------------------------------------
# mamba-1 selective scan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b,l,c,n,chunk,cblk", [
    (1, 16, 8, 4, 8, 8),
    (2, 72, 48, 8, 16, 16),
    (1, 50, 24, 16, 32, 8),   # pad path
])
def test_selective_scan_plain_matches_reference_and_pallas(b, l, c, n, chunk,
                                                           cblk):
    a = scan_inputs(0, b, l, c, n)
    ref = np.array(jsr.selective_scan_ref(*map(J, a)))
    pal = np.array(selective_scan_pallas(*map(J, a), chunk=chunk,
                                         c_block=cblk, interpret=True))
    for out in (tsr.selective_scan_ref(*map(T, a)),
                tsr.selective_scan_chunked_ref(*map(T, a), chunk=chunk),
                tsk.selective_scan_cuda(*map(T, a), chunk=chunk,
                                        c_block=cblk)):
        np.testing.assert_allclose(out.numpy(), ref, **FP32)
        np.testing.assert_allclose(out.numpy(), pal, **FP32)


def test_selective_scan_chunked_equals_unchunked():
    a = scan_inputs(1, 2, 40, 12, 4)
    ref = tsr.selective_scan_ref(*map(T, a)).numpy()
    for chunk in (5, 8, 40):
        out = tsr.selective_scan_chunked_ref(*map(T, a), chunk=chunk)
        np.testing.assert_allclose(out.numpy(), ref, **FP32)


def test_selective_scan_final_state_and_steps_match_reference():
    b, l, c, n = 1, 12, 6, 4
    a = scan_inputs(2, b, l, c, n)
    y, h_final = tsr.selective_scan_chunked_ref(*map(T, a), chunk=4,
                                                return_state=True)
    jy, jh = jsr.selective_scan_chunked_ref(*map(J, a), chunk=4,
                                            return_state=True)
    np.testing.assert_allclose(y.numpy(), np.array(jy), **FP32)
    np.testing.assert_allclose(h_final.numpy(), np.array(jh), **FP32)
    x, dt, A, Bm, Cm, D = a
    h, jh = torch.zeros((b, c, n)), jnp.zeros((b, c, n))
    for t in range(l):
        h, yt = tsr.selective_scan_step_ref(
            h, T(x[:, t]), T(dt[:, t]), T(A), T(Bm[:, t]), T(Cm[:, t]), T(D))
        jh, jyt = jsr.selective_scan_step_ref(
            jh, J(x[:, t]), J(dt[:, t]), J(A), J(Bm[:, t]), J(Cm[:, t]), J(D))
        np.testing.assert_allclose(yt.numpy(), np.array(jyt), **FP32)
    np.testing.assert_allclose(h.numpy(), np.array(jh), **FP32)
    np.testing.assert_allclose(h.numpy(), h_final.numpy(), **FP32)
    # the op's prefill variant is the plain version on every device
    y2, h2 = ops.selective_scan(*map(T, a), chunk=4, return_state=True)
    np.testing.assert_allclose(h2.numpy(), h_final.numpy(), **FP32)


def test_selective_scan_large_decay_and_bf16():
    # dt * A down to about -60: the decays underflow to 0 in fp32
    a = scan_inputs(3, 2, 33, 16, 16, dt_scale=20.0)
    ref = np.array(jsr.selective_scan_ref(*map(J, a)))
    out = tsr.selective_scan_chunked_ref(*map(T, a), chunk=16).numpy()
    np.testing.assert_allclose(out, ref, **FP32)
    bf = [T(t).bfloat16() for t in a[:2]] + [T(a[2])] + \
        [T(t).bfloat16() for t in a[3:5]] + [T(a[5])]
    jbf = [J(t).astype(jnp.bfloat16) for t in a[:2]] + [J(a[2])] + \
        [J(t).astype(jnp.bfloat16) for t in a[3:5]] + [J(a[5])]
    out = tsr.selective_scan_chunked_ref(*bf, chunk=16)
    ref = jsr.selective_scan_chunked_ref(*jbf, chunk=16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.array(ref.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


def test_selective_scan_recompute_grads_match_jax_grad():
    a = scan_inputs(4, 2, 32, 8, 4)
    f_op = lambda *x: (jops.selective_scan(*x, chunk=8) ** 2).sum()  # noqa: E731
    jg = jax.grad(f_op, argnums=tuple(range(6)))(*map(J, a))
    plain = lambda *x: tsr.selective_scan_chunked_ref(*x, chunk=8)  # noqa: E731
    for via_op in (False, True):
        xs = [T(t).requires_grad_() for t in a]
        ops.reset_recomputes()
        y = (ops.selective_scan(*xs, chunk=8) if via_op
             else ops.recompute("selective_scan", plain, plain, *xs))
        (y ** 2).sum().backward()
        assert ops.RECOMPUTES["selective_scan"] == 1
        for t, g in zip(xs, jg):
            np.testing.assert_allclose(t.grad.numpy(), np.array(g), **GRAD)


# --------------------------------------------------------------------------
# mamba-2 SSD
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b,l,h,p,g,n,chunk", [
    (1, 16, 2, 8, 1, 4, 8),
    (2, 48, 4, 16, 2, 8, 16),
    (1, 30, 4, 8, 4, 4, 16),   # pad path
])
def test_ssd_plain_matches_reference_and_pallas(b, l, h, p, g, n, chunk):
    a = ssd_inputs(5, b, l, h, p, g, n)
    ref = np.array(jdr.ssd_ref(*map(J, a), chunk=chunk))
    pal = np.array(ssd_pallas(*map(J, a), chunk=chunk, interpret=True))
    for out in (tdr.ssd_ref(*map(T, a), chunk=chunk),
                tdk.ssd_cuda(*map(T, a), chunk=chunk)):
        np.testing.assert_allclose(out.numpy(), ref, **FP32)
        np.testing.assert_allclose(out.numpy(), pal, **FP32)


def test_ssd_segsum_matches_reference():
    la = -np.abs(np.random.default_rng(6).normal(size=(3, 7))).astype(
        np.float32)
    out = tdr._segsum(T(la)).numpy()
    ref = np.array(jdr._segsum(J(la)))
    assert np.array_equal(np.isinf(out), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(out[fin], ref[fin], atol=1e-6, rtol=1e-6)


def test_ssd_state_forms_match_reference():
    b, l, h, p, g, n = 2, 20, 4, 4, 2, 3
    a = ssd_inputs(7, b, l, h, p, g, n)
    init = np.random.default_rng(8).normal(size=(b, h, n, p)).astype(
        np.float32)
    y, s = tdr.ssd_ref(*map(T, a), chunk=8, init_state=T(init),
                       return_state=True)
    jy, js = jdr.ssd_ref(*map(J, a), chunk=8, init_state=J(init),
                         return_state=True)
    np.testing.assert_allclose(y.numpy(), np.array(jy), **FP32)
    np.testing.assert_allclose(s.numpy(), np.array(js), **FP32)
    # the step form, from the same initial state, lands on the same state
    x, dt, A, Bm, Cm, D = a
    st, jst = T(init), J(init)
    for t in range(l):
        st, yt = tdr.ssd_step_ref(st, T(x[:, t]), T(dt[:, t]), T(A),
                                  T(Bm[:, t]), T(Cm[:, t]), T(D))
        jst, jyt = jdr.ssd_step_ref(jst, J(x[:, t]), J(dt[:, t]), J(A),
                                    J(Bm[:, t]), J(Cm[:, t]), J(D))
        np.testing.assert_allclose(yt.numpy(), np.array(jyt), **FP32)
        np.testing.assert_allclose(yt.numpy(), y[:, t].numpy(), **FP32)
    np.testing.assert_allclose(st.numpy(), np.array(jst), **FP32)
    np.testing.assert_allclose(st.numpy(), s.numpy(), **FP32)
    y2, s2 = ops.ssd(*map(T, a), chunk=8, init_state=T(init),
                     return_state=True)
    np.testing.assert_allclose(s2.numpy(), s.numpy(), **FP32)


def test_ssd_recompute_grads_match_jax_grad():
    a = ssd_inputs(9, 2, 24, 4, 8, 2, 4)
    f_op = lambda *x: (jops.ssd(*x, chunk=8) ** 2).sum()  # noqa: E731
    jg = jax.grad(f_op, argnums=tuple(range(6)))(*map(J, a))
    plain = lambda *x: tdr.ssd_ref(*x, chunk=8)  # noqa: E731
    for via_op in (False, True):
        xs = [T(t).requires_grad_() for t in a]
        ops.reset_recomputes()
        y = (ops.ssd(*xs, chunk=8) if via_op
             else ops.recompute("ssd", plain, plain, *xs))
        (y ** 2).sum().backward()
        assert ops.RECOMPUTES["ssd"] == 1
        for t, g in zip(xs, jg):
            np.testing.assert_allclose(t.grad.numpy(), np.array(g), **GRAD)


# --------------------------------------------------------------------------
# the recompute wrapper, launch geometry, dispatch
# --------------------------------------------------------------------------

def test_recompute_gives_a_history_free_forward_its_gradient():
    """A kernel's output (allocated by the wrapper) has no autograd
    history; through ``ops.recompute`` it gets the plain version's
    gradient, so gradients reach what lies upstream — here the embedding,
    through an RMSNorm."""
    rng = np.random.default_rng(10)
    emb = T(rng.normal(size=(16, 32)).astype(np.float32)).requires_grad_()
    w = T(rng.normal(size=(32,)).astype(np.float32)).requires_grad_()
    tok = torch.tensor([[1, 5, 7], [2, 2, 9]])

    def plain(x, w):
        from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
        return rmsnorm_ref(x, w)

    def kernel_like(x, w):  # what a CUDA kernel hands back
        with torch.no_grad():
            return plain(x, w).detach()

    x = torch.nn.functional.embedding(tok, emb)
    assert kernel_like(x, w).grad_fn is None  # the fault without the wrapper
    (ops.recompute("rmsnorm", kernel_like, plain, x, w) ** 3).sum().backward()
    g_emb, g_w = emb.grad.clone(), w.grad.clone()
    emb.grad = w.grad = None
    (plain(torch.nn.functional.embedding(tok, emb), w) ** 3).sum().backward()
    assert float(g_emb.abs().sum()) > 0
    np.testing.assert_allclose(g_emb.numpy(), emb.grad.numpy(), **GRAD)
    np.testing.assert_allclose(g_w.numpy(), w.grad.numpy(), **GRAD)


@pytest.mark.parametrize("n,chunk,cblk,expect", [
    (16, 256, 512, (4, 64, 64)),   # falcon-mamba: the config's TPU sizes
    (16, 64, 64, (4, 64, 64)),
    (64, 256, 128, (16, 16, 32)),  # 256 threads at most
    (4, 16, 16, (1, 32, 16)),      # at least one warp
    (8, 32, 16, (2, 16, 32)),
    (128, 64, 64, (32, 8, 32)),
])
def test_selective_scan_launch_geometry(n, chunk, cblk, expect):
    """The planner's (lanes, channels, chunk) at falcon-mamba-7b's training
    width (2 x 1024 tokens, 8192 channels)."""
    plan = tsk.plan_scan(2, 1024, 8192, n, 2, chunk, cblk)
    assert (plan.lanes, plan.channels, plan.chunk) == expect
    assert plan.threads % 32 == 0 and plan.threads <= tsk.MAX_THREADS
    assert plan.lanes * tsk.STATES >= n
    assert plan.smem <= cuda_lib.SMEM_LIMIT
    with pytest.raises(ValueError):
        tsk.plan_scan(2, 1024, 8192, 129, 2, chunk, cblk)


def test_ssd_chunk_snaps_to_a_tile_that_fits():
    dom = dispatch.get_family("ssd").option("chunk").values
    assert dispatch.snap_down(256, dom) == 64  # zamba2-2.7b's ssm_chunk
    assert tdk.smem_bytes(64, 64, 64) <= cuda_lib.SMEM_LIMIT
    assert tdk.smem_bytes(64, 64, 64) == 83200


def test_ssm_ops_take_plain_versions_on_cpu_and_launch_nothing():
    cuda_lib.reset_launches()
    a = scan_inputs(11, 1, 10, 4, 4)
    s = ssd_inputs(12, 1, 10, 2, 4, 1, 4)
    with dispatch.record_resolutions() as rec:
        ops.selective_scan(*map(T, a), chunk=4)
        ops.ssd(*map(T, s), chunk=4)
    assert [(r.family, r.mode) for r in rec] == [("mamba_scan", "ref"),
                                                 ("ssd", "ref")]
    assert rec[0].launch == {"chunk": 4, "c_block": 64}
    assert all(n == 0 for n in cuda_lib.LAUNCHES.values())
