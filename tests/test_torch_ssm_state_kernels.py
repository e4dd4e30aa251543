"""The final-state variants of the Mamba-1 scan and the Mamba-2 SSD (what
serving's prefill calls) on the CPU:

- ``ops.selective_scan(..., return_state=True)`` and ``ops.ssd(...,
  init_state=, return_state=True)`` resolve through ``dispatch`` like the
  plain calls, and on a CPU tensor match the reference's oracles at ragged
  L (fp32, atol 2e-5 / rtol 1e-4); an input that requires grad is refused;
- the CUDA wrappers on ``meta`` tensors (no data, no card): the argument
  checks, the output shapes and dtypes, and the state pointers handed to
  the C entry points on both SSD routes;
- the rounding-faithful tensor-core SSD with an initial and a final state
  against the reference (bf16 tolerance, 2e-2 + 2e-2|x|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan import ref as jsr
from repro.kernels.ssd import ref as jdr
from repro_torch.kernels import cuda_lib, dispatch, ops
from repro_torch.kernels.mamba_scan import kernel as tsk
from repro_torch.kernels.ssd import kernel as tdk
from repro_torch.kernels.ssd import ref as tdr

torch.set_num_threads(1)

FP32 = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
# the prefill lengths of the kernels' edges: one step, inside one chunk,
# one short of a chunk, a chunk, one past it, several chunks
LENGTHS = (1, 17, 63, 64, 65, 200)


def scan_inputs(seed, b, l, c, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, l, c)).astype(np.float32),
            (rng.uniform(size=(b, l, c)) * 0.1).astype(np.float32),
            -rng.uniform(0.5, 4.0, size=(c, n)).astype(np.float32),
            rng.normal(size=(b, l, n)).astype(np.float32),
            rng.normal(size=(b, l, n)).astype(np.float32),
            rng.normal(size=(c,)).astype(np.float32))


def ssd_inputs(seed, b, l, h, p, g, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, l, h, p)).astype(np.float32),
            (rng.uniform(size=(b, l, h)) * 0.1).astype(np.float32),
            -np.arange(1, h + 1, dtype=np.float32),
            rng.normal(size=(b, l, g, n)).astype(np.float32),
            rng.normal(size=(b, l, g, n)).astype(np.float32),
            rng.normal(size=(h,)).astype(np.float32))


# --------------------------------------------------------------------------
# ops on the CPU: through dispatch, against the reference's oracles
# --------------------------------------------------------------------------

@pytest.mark.parametrize("l", LENGTHS)
def test_scan_final_state_resolves_and_matches_reference(l):
    a = scan_inputs(l, 2, l, 24, 16)
    with dispatch.record_resolutions() as seen:
        y, h = ops.selective_scan(*(torch.from_numpy(t) for t in a),
                                  return_state=True)
    assert [(r.family, r.mode) for r in seen] == [("mamba_scan", "ref")]
    chunk = seen[0].launch["chunk"]
    jy, jh = jsr.selective_scan_chunked_ref(
        *(jnp.asarray(t) for t in a), chunk=chunk, return_state=True)
    assert h.shape == (2, 24, 16) and h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.array(jy), **FP32)
    np.testing.assert_allclose(h.numpy(), np.array(jh), **FP32)


@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_carried_state_resolves_and_matches_reference(l, with_init):
    b, h, p, g, n = 2, 4, 16, 2, 8
    a = ssd_inputs(l, b, l, h, p, g, n)
    s0 = (np.random.default_rng(99).normal(size=(b, h, n, p))
          .astype(np.float32) if with_init else None)
    with dispatch.record_resolutions() as seen:
        y, s = ops.ssd(*(torch.from_numpy(t) for t in a),
                       init_state=None if s0 is None else torch.from_numpy(s0),
                       return_state=True)
    assert [(r.family, r.mode) for r in seen] == [("ssd", "ref")]
    chunk = seen[0].launch["chunk"]
    jy, js = jdr.ssd_ref(*(jnp.asarray(t) for t in a), chunk=chunk,
                         init_state=None if s0 is None else jnp.asarray(s0),
                         return_state=True)
    assert s.shape == (b, h, n, p) and s.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.array(jy), **FP32)
    np.testing.assert_allclose(s.numpy(), np.array(js), **FP32)


def test_ssd_init_state_alone_returns_y_only():
    a = [torch.from_numpy(t) for t in ssd_inputs(3, 1, 30, 2, 16, 1, 8)]
    s0 = torch.ones((1, 2, 8, 16))
    y = ops.ssd(*a, init_state=s0)
    assert isinstance(y, torch.Tensor)
    y_zero, _ = ops.ssd(*a, return_state=True)
    assert not torch.allclose(y, y_zero)


@pytest.mark.parametrize("op", ["selective_scan", "ssd"])
def test_carried_state_variants_refuse_a_gradient(op):
    if op == "selective_scan":
        a = [torch.from_numpy(t) for t in scan_inputs(0, 1, 9, 8, 4)]
        call = lambda *t: ops.selective_scan(*t, return_state=True)  # noqa
    else:
        a = [torch.from_numpy(t) for t in ssd_inputs(0, 1, 9, 2, 16, 1, 8)]
        call = lambda *t: ops.ssd(*t, return_state=True)  # noqa
    a[0].requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        call(*a)
    with torch.no_grad():
        call(*a)  # serving's case: no graph is built, nothing to refuse


# --------------------------------------------------------------------------
# the CUDA wrappers on meta tensors
# --------------------------------------------------------------------------

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
    monkeypatch.setattr(cuda_lib, "stream_of", lambda t: 0)
    return lib


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, device="meta", dtype=dtype)


@pytest.mark.parametrize("b,l,c,n,dtype", [
    (1, 64, 8192, 16, torch.bfloat16),   # falcon-mamba-7b, one request
    (4, 64, 8192, 16, torch.bfloat16),   # its fixed batch
    (1, 1, 8192, 16, torch.bfloat16),
    (2, 65, 100, 64, torch.float32),
])
@pytest.mark.parametrize("return_state", [False, True])
def test_scan_wrapper_hands_the_state_pointer(fake_card, b, l, c, n, dtype,
                                              return_state):
    x = _meta(b, l, c, dtype=dtype)
    bc = _meta(b, l, n, dtype=dtype)
    A, D = _meta(c, n, dtype=torch.float32), _meta(c, dtype=torch.float32)
    out = tsk.selective_scan_cuda(x, x, A, bc, bc, D,
                                  return_state=return_state)
    y, h = out if return_state else (out, None)
    assert y.shape == x.shape and y.dtype == dtype
    args = fake_card.calls["repro_selective_scan"]
    # ..., in_dtype, out_dtype, h_out, stream
    assert args[7:11] == (b, l, c, n)
    if return_state:
        assert h.shape == (b, c, n) and h.dtype == torch.float32
        assert args[16] == h.data_ptr()
    else:
        assert args[16] is None
    assert cuda_lib.LAUNCHES["selective_scan"] == 1


@pytest.mark.parametrize("p,n,dtype,route", [
    (64, 64, torch.bfloat16, 1),   # zamba2-2.7b: the tensor-core route
    (64, 64, torch.float32, 0),    # fp32: the SIMT route
    (24, 8, torch.bfloat16, 0),    # a head width the first does not take
])
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_wrapper_hands_the_state_pointers(fake_card, p, n, dtype, route,
                                              with_init):
    b, l, h, g = 1, 65, 80, 1
    args = (_meta(b, l, h, p, dtype=dtype), _meta(b, l, h, dtype=dtype),
            _meta(h, dtype=torch.float32), _meta(b, l, g, n, dtype=dtype),
            _meta(b, l, g, n, dtype=dtype), _meta(h, dtype=torch.float32))
    s0 = _meta(b, h, n, p, dtype=torch.float32) if with_init else None
    y, s = tdk.ssd_cuda(*args, chunk=256, init_state=s0, return_state=True)
    assert y.shape == (b, l, h, p) and y.dtype == dtype
    assert s.shape == (b, h, n, p) and s.dtype == torch.float32
    call = fake_card.calls["repro_ssd"]
    # ..., route, init_state, state_out, states, flags, ticket, epoch, stream
    assert call[17] == route
    assert (call[18] is None) == (not with_init)
    assert call[19] == s.data_ptr()
    assert cuda_lib.LAUNCHES["ssd"] == 1


def test_ssd_wrapper_refuses_a_state_of_another_shape(fake_card):
    b, l, h, p, n = 1, 16, 4, 32, 64
    args = (_meta(b, l, h, p), _meta(b, l, h), _meta(h, dtype=torch.float32),
            _meta(b, l, 1, n), _meta(b, l, 1, n),
            _meta(h, dtype=torch.float32))
    with pytest.raises(ValueError, match="init_state"):
        tdk.ssd_cuda(*args, init_state=_meta(b, h, p, n,
                                             dtype=torch.float32))
    assert cuda_lib.LAUNCHES["ssd"] == 0


# --------------------------------------------------------------------------
# the rounding-faithful tensor-core SSD with carried states
# --------------------------------------------------------------------------

@pytest.mark.parametrize("l", (17, 64, 65, 200))
def test_tensor_core_ssd_plain_version_carries_states(l):
    b, h, p, g, n = 1, 4, 64, 1, 64
    rng = np.random.default_rng(l)
    a = ssd_inputs(l, b, l, h, p, g, n)
    a = tuple(torch.from_numpy(t).bfloat16().float().numpy()
              if i in (0, 1, 3, 4) else t for i, t in enumerate(a))
    s0 = rng.normal(size=(b, h, n, p)).astype(np.float32)
    bf = torch.bfloat16
    x, dt, A, Bm, Cm, D = (torch.from_numpy(t) for t in a)
    y, s = tdr.ssd_tensor_core_ref(x.to(bf), dt.to(bf), A, Bm.to(bf),
                                   Cm.to(bf), D, chunk=64,
                                   init_state=torch.from_numpy(s0),
                                   return_state=True)
    jy, js = jdr.ssd_ref(*(jnp.asarray(t) for t in a), chunk=64,
                         init_state=jnp.asarray(s0), return_state=True)
    assert y.dtype == bf and s.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), np.array(jy), **BF16)
    np.testing.assert_allclose(s.numpy(), np.array(js), **BF16)
