"""Host-side logic of the redesigned RMSNorm and SSD kernels on the CPU.

- The RMSNorm planner (``plan_rmsnorm``, shapes only): every (rows, width)
  the slices run gets a plan the kernel takes, and a width no
  instantiation covers raises; the wrapper hands the plan to the C entry
  point (on ``meta`` tensors, with the library replaced by a recorder).
- The SSD's route choice and its wrapper: bf16 x, B and C keep their
  storage whatever dt's dtype (an fp32 dt no longer widens them to fp32),
  and the tensor-core route gets its chain scratch and a fresh epoch.
- The rounding-faithful plain version of the tensor-core SSD
  (``ssd_tensor_core_ref``) against the JAX reference's ``ssd_ref`` and
  ``ssd_pallas`` in ``interpret=True`` mode, on ``chip_smoke.py``'s SSD
  cases cut to CPU size (dt scale 5.0, G in {1, 2, 4}): the kernel's
  precision budget holds before the card sees the kernel.

Tolerance of the SSD comparisons: bf16's atol 2e-2 / rtol 2e-2, the
port's bf16 tolerance on the card; both sides take the same bf16 inputs,
the reference computes in fp32 and the faithful version rounds where the
kernel feeds the tensor cores.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ref as jdr
from repro.kernels.ssd.kernel import ssd_pallas
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.rmsnorm import kernel as trk
from repro_torch.kernels.ssd import kernel as tdk
from repro_torch.kernels.ssd import ref as tdr

torch.set_num_threads(1)

BF16 = dict(atol=2e-2, rtol=2e-2)

# --------------------------------------------------------------------------
# RMSNorm planner
# --------------------------------------------------------------------------

# (rows, width) the slices call the kernel with: llama3.2-1b serving (decode
# 4 rows, prefill 4 x 64, a batcher prompt of 200, a 64-token prefill
# chunk), zamba2-2.7b and falcon-mamba-7b training (2 x 1024 rows), and the
# phase-3 widths of chip_smoke.py
SLICE_ROWS = (
    (4, 2048), (256, 2048), (200, 2048), (64, 2048), (1, 2048),
    (2048, 2560), (4, 2560), (2048, 4096), (4, 4096),
    (4, 8192), (16, 8192), (51, 64), (5, 100), (7, 2049),
)


def _covers(plan, dim, itemsize):
    per_slot = 16 // itemsize if plan.vectorized else 1
    return plan.slots * 32 * plan.warps_per_row * per_slot >= dim


@pytest.mark.parametrize("rows,dim", SLICE_ROWS)
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("row_block", [1, 4, 8])
def test_rmsnorm_plan_covers_every_slice_shape(rows, dim, itemsize,
                                               row_block):
    vectorized = dim % (16 // itemsize) == 0
    for vec in {vectorized, False}:  # aligned rows, and unaligned tensors
        if not vec and dim > trk.max_width(itemsize, False):
            with pytest.raises(ValueError):
                trk.plan_rmsnorm(rows, dim, itemsize, vec, row_block)
            continue
        plan = trk.plan_rmsnorm(rows, dim, itemsize, vec, row_block)
        assert plan.vectorized == vec
        assert plan.warps_per_row in trk.WARPS_PER_ROW
        assert plan.slots in trk.SLOTS
        assert _covers(plan, dim, itemsize)
        # the fewest slots that cover the row at this many warps
        smaller = [s for s in trk.SLOTS if s < plan.slots]
        if smaller:
            assert not _covers(plan._replace(slots=smaller[-1]), dim,
                               itemsize)
        # row_block is rows per block only when a row has one warp
        assert plan.rows_per_block == (row_block if plan.warps_per_row == 1
                                       else 1)
        assert plan.rows_per_block * plan.warps_per_row <= 8


def test_rmsnorm_plan_spreads_few_rows_and_keeps_many_rows_narrow():
    # decode: 4 rows of 2048 bf16 take eight warps a row, one vector a lane
    assert trk.plan_rmsnorm(4, 2048, 2, True) == trk.RmsPlan(8, 1, 1, True)
    # training rows: as few warps as keep a lane at 8 vectors
    assert trk.plan_rmsnorm(2048, 2048, 2, True) == trk.RmsPlan(1, 4, 8,
                                                                 True)
    assert trk.plan_rmsnorm(2048, 4096, 2, True) == trk.RmsPlan(2, 1, 8,
                                                                 True)
    # a width of 8 vectors never gives a lane nothing to load
    assert trk.plan_rmsnorm(4, 64, 2, True).warps_per_row == 1
    # every warps-per-row value is reached by some slice shape
    reached = {trk.plan_rmsnorm(r, d, 2, d % 8 == 0).warps_per_row
               for r, d in SLICE_ROWS}
    assert reached == set(trk.WARPS_PER_ROW)


@pytest.mark.parametrize("itemsize,vectorized", [(2, True), (4, True),
                                                 (2, False), (4, False)])
def test_rmsnorm_plan_refuses_what_no_instantiation_covers(itemsize,
                                                           vectorized):
    per_slot = 16 // itemsize if vectorized else 1
    widest = trk.max_width(itemsize, vectorized)
    plan = trk.plan_rmsnorm(4, widest, itemsize, vectorized)
    assert _covers(plan, widest, itemsize)
    with pytest.raises(ValueError):
        trk.plan_rmsnorm(4, widest + per_slot, itemsize, vectorized)
    if vectorized:  # not a whole number of vectors
        with pytest.raises(ValueError):
            trk.plan_rmsnorm(4, 2048 + 1, itemsize, True)


def test_rmsnorm_plan_reads_shapes_only():
    params = inspect.signature(trk.plan_rmsnorm).parameters
    assert list(params) == ["rows", "dim", "itemsize", "vectorized",
                            "row_block"]


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
    monkeypatch.setattr(cuda_lib, "_ssd_scratch", {})
    monkeypatch.setattr(cuda_lib, "_epochs", {})
    return lib


@pytest.mark.parametrize("shape,dtype,row_block", [
    ((4, 1, 2048), torch.bfloat16, 4),
    ((4, 64, 2048), torch.bfloat16, 8),
    ((2, 1024, 4096), torch.bfloat16, 4),
    ((3, 17, 64), torch.float32, 1),
    ((5, 100), torch.float32, 4),
])
def test_rmsnorm_wrapper_launches_the_plan(fake_card, shape, dtype,
                                           row_block):
    x = torch.empty(shape, device="meta", dtype=dtype)
    w = torch.empty(shape[-1:], device="meta", dtype=dtype)
    trk.rmsnorm_cuda(x, w, residual=x, row_block=row_block)
    args = fake_card.calls["repro_rmsnorm"]
    rows, dim = x.numel() // shape[-1], shape[-1]
    plan = trk.plan_rmsnorm(rows, dim, x.element_size(),
                            dim % (16 // x.element_size()) == 0, row_block)
    # rows, dim, eps, dtype, then the plan
    assert args[4:6] == (rows, dim)
    assert args[8:12] == (plan.rows_per_block, plan.warps_per_row,
                          plan.slots, int(plan.vectorized))
    assert cuda_lib.LAUNCHES["rmsnorm"] == 1


# --------------------------------------------------------------------------
# SSD route and wrapper
# --------------------------------------------------------------------------

def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, device="meta", dtype=dtype)


@pytest.mark.parametrize("p,n,dtypes,q,route", [
    (64, 64, (torch.bfloat16,) * 3, 64, "mma"),    # zamba2-2.7b
    (80, 16, (torch.bfloat16,) * 3, 16, "mma"),
    (16, 16, (torch.bfloat16,) * 3, 32, "mma"),
    (128, 64, (torch.bfloat16,) * 3, 64, "mma"),
    (64, 128, (torch.bfloat16,) * 3, 64, "simt"),  # N past one slab a warp
    (24, 8, (torch.bfloat16,) * 3, 16, "simt"),    # N, P not instantiated
    (64, 64, (torch.float32,) * 3, 64, "simt"),    # fp32 keeps fp32
    (64, 64, (torch.bfloat16, torch.float32, torch.bfloat16), 64, "simt"),
])
def test_ssd_route(p, n, dtypes, q, route):
    x = _meta(1, 8, 2, p, dtype=dtypes[0])
    bm = _meta(1, 8, 1, n, dtype=dtypes[1])
    cm = _meta(1, 8, 1, n, dtype=dtypes[2])
    assert tdk.ssd_route(x, bm, cm, q) == route


@pytest.mark.parametrize("dt_dtype", [torch.float32, torch.bfloat16])
def test_ssd_wrapper_keeps_bf16_storage_whatever_dt(fake_card, dt_dtype):
    b, l, h, p, g, n = 2, 1024, 80, 64, 1, 64
    args = (_meta(b, l, h, p), _meta(b, l, h, dtype=dt_dtype),
            _meta(h, dtype=torch.float32), _meta(b, l, g, n),
            _meta(b, l, g, n), _meta(h, dtype=torch.float32))
    for epoch in (1, 2):
        y = tdk.ssd_cuda(*args, chunk=256)
        call = fake_card.calls["repro_ssd"]
        # B, L, H, P, G, N, chunk, in_dtype, dt_dtype, out_dtype, route
        assert call[7:18] == (b, l, h, p, g, n, 64, 1,
                              cuda_lib.DTYPE_CODES[dt_dtype], 1, 1)
        assert call[-2] == epoch  # a fresh epoch per launch
    assert y.dtype == torch.bfloat16 and y.shape == (b, l, h, p)
    states, flags, ticket = cuda_lib._ssd_scratch[torch.device("meta")]
    assert states.numel() >= b * h * 2 * n * p
    assert flags.numel() >= b * h * (l // 64)
    assert ticket.numel() == 1
    assert cuda_lib.LAUNCHES["ssd"] == 2


def test_ssd_wrapper_widens_only_when_x_b_c_disagree(fake_card):
    b, l, h, p, n = 1, 40, 4, 64, 64
    tdk.ssd_cuda(_meta(b, l, h, p), _meta(b, l, h),
                 _meta(h, dtype=torch.float32),
                 _meta(b, l, 1, n, dtype=torch.float32), _meta(b, l, 1, n),
                 _meta(h, dtype=torch.float32), chunk=64)
    call = fake_card.calls["repro_ssd"]
    # x, B, C widened to fp32 together; dt stays bf16; y stays bf16
    assert call[14:18] == (0, 1, 1, 0)


def test_epochs_count_up_per_device_and_skip_zero(monkeypatch):
    monkeypatch.setattr(cuda_lib, "_epochs", {})
    dev = torch.device("meta")
    assert [cuda_lib.next_epoch(dev) for _ in range(3)] == [1, 2, 3]
    cuda_lib._epochs[dev] = 2 ** 31 - 1
    assert cuda_lib.next_epoch(dev) == 1


# --------------------------------------------------------------------------
# the rounding-faithful tensor-core SSD against the JAX reference
# --------------------------------------------------------------------------

# chip_smoke.py's SSD_CASES cut to CPU size: (b, l, h, p, g, n, chunk,
# dt_scale); zamba2-2.7b's widths (P 64, N 64, G 1) on 4 heads; ragged L;
# G in {1, 2, 4}; N in {16, 64}; dt * A down to -20 per step, within one
# chunk and across chunks
SSD_CPU_CASES = (
    (1, 192, 4, 64, 1, 64, 64, 0.1),
    (1, 100, 8, 64, 2, 64, 64, 0.1),
    (2, 70, 8, 32, 4, 16, 32, 0.1),
    (1, 45, 4, 80, 1, 16, 16, 0.1),
    (1, 64, 4, 64, 1, 64, 64, 5.0),
    (1, 160, 4, 64, 1, 64, 32, 5.0),
    (2, 129, 6, 16, 2, 16, 32, 0.1),
)


def ssd_bf16_inputs(seed, b, l, h, p, g, n, dt_scale):
    """bf16-valued inputs as numpy fp32 (x, dt, B, C), the decays as
    chip_smoke.py draws them (A = -1..-h, dt uniform in [0, dt_scale))."""
    rng = np.random.default_rng(seed)

    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16().float(
        ).numpy()

    return (bf(rng.normal(size=(b, l, h, p))),
            bf(rng.uniform(size=(b, l, h)) * dt_scale),
            -np.arange(1, h + 1, dtype=np.float32),
            bf(rng.normal(size=(b, l, g, n))),
            bf(rng.normal(size=(b, l, g, n))),
            rng.normal(size=(h,)).astype(np.float32))


@pytest.mark.parametrize("b,l,h,p,g,n,chunk,dt_scale", SSD_CPU_CASES)
def test_tensor_core_ssd_plain_version_holds_bf16_tolerance(
        b, l, h, p, g, n, chunk, dt_scale):
    a = ssd_bf16_inputs(7, b, l, h, p, g, n, dt_scale)
    x, dt, A, Bm, Cm, D = (torch.from_numpy(t) for t in a)
    bf = torch.bfloat16
    out = tdr.ssd_tensor_core_ref(x.to(bf), dt.to(bf), A, Bm.to(bf),
                                  Cm.to(bf), D, chunk=chunk)
    assert out.dtype == bf
    out = out.float().numpy()
    ja = [jnp.asarray(t) for t in a]
    ref = np.array(jdr.ssd_ref(*ja, chunk=chunk))
    pal = np.array(ssd_pallas(*ja, chunk=chunk, interpret=True))
    np.testing.assert_allclose(out, ref, **BF16)
    np.testing.assert_allclose(out, pal, **BF16)


def test_tensor_core_ssd_plain_version_takes_fp32_dt():
    """A bf16 model's fp32 dt (its fp32 ``dt_bias``) with bf16 x, B, C."""
    a = ssd_bf16_inputs(8, 1, 96, 4, 64, 1, 64, 0.1)
    x, dt, A, Bm, Cm, D = (torch.from_numpy(t) for t in a)
    dt = dt + 1e-3  # not a bf16 value
    bf = torch.bfloat16
    out = tdr.ssd_tensor_core_ref(x.to(bf), dt, A, Bm.to(bf), Cm.to(bf), D,
                                  chunk=64).float().numpy()
    ref = np.array(jdr.ssd_ref(*(jnp.asarray(t.numpy()) for t in (
        x, dt, A, Bm, Cm, D)), chunk=64))
    np.testing.assert_allclose(out, ref, **BF16)
