"""Host-side logic of the redesigned Mamba-1 selective-scan kernel on the
CPU.

- The planner (``plan_scan``, shapes only): every shape of
  ``chip_smoke.py``'s ``SCAN_CASES`` and the training shape get a plan the
  kernel takes (whole warps, at most 256 threads, shared memory within the
  card's limit, ``lanes * 4 >= N``, the chunk a whole number of unrolled
  groups); the training shape fills the card with blocks; N past 128
  raises, and so does an explicit plan (``make_plan``) the kernel does not
  take; the wrapper hands the plan to the C entry point (on ``meta``
  tensors, with the library replaced by a recorder).
- The butterfly reduce-scatter's index mapping (``reduce_scatter`` in
  ``selective_scan.cu``): after it, lane g holds the sums over the lanes of
  steps [g Q, g Q + Q), the steps whose x and dt it loaded.  The kernel
  itself is held against the plain version on the card by
  ``chip_smoke.py`` and ``tests/test_torch_gpu.py``.
"""

import importlib.util
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.mamba_scan import kernel as tsk

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SCAN_CASES = _chip_smoke().SCAN_CASES
TRAIN_SHAPE = (2, 1024, 8192, 16)  # falcon-mamba-7b, batch 2 x 1024 tokens
#: the lanes-per-channel values ``selective_scan.cu`` instantiates
LANES = (1, 2, 4, 8, 16, 32)


def _check_plan(plan, b, c, n, itemsize):
    assert plan.lanes in LANES
    assert plan.lanes * tsk.STATES >= n
    assert plan.threads == plan.channels * plan.lanes
    assert plan.threads % 32 == 0 and plan.threads <= tsk.MAX_THREADS
    assert plan.channels * itemsize % 16 == 0  # whole 16-byte tile rows
    assert plan.chunk % 16 == 0
    assert plan.chunk % tsk.group_steps(plan.lanes) == 0
    assert plan.blocks == b * -(-c // plan.channels)
    assert plan.smem == tsk.scan_smem_bytes(
        n, tsk.STATES * plan.lanes, plan.channels, plan.chunk, itemsize)
    assert plan.smem <= cuda_lib.SMEM_LIMIT


@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: str(c[:6]))
@pytest.mark.parametrize("itemsize", [2, 4])
def test_scan_plan_takes_every_phase3_case(case, itemsize):
    b, l, c, n, chunk, c_block = case[:6]
    plan = tsk.plan_scan(b, l, c, n, itemsize, chunk, c_block)
    _check_plan(plan, b, c, n, itemsize)


def test_scan_plan_fills_the_card_at_the_training_shape():
    # the train step's options: the config's chunk 256, the family's c_block
    for chunk, c_block in ((256, 64), (256, 512), (64, 32)):
        plan = tsk.plan_scan(*TRAIN_SHAPE, 2, chunk, c_block)
        _check_plan(plan, 2, 8192, 16, 2)
        assert plan.lanes == 4
        assert plan.blocks >= 132  # at least one block per SM of an H100
        assert plan.blocks >= tsk.MIN_BLOCKS
        assert plan.chunk == 64


def test_scan_plan_reaches_every_lanes_choice():
    reached = {tsk.plan_scan(b, l, c, n, 2, ch, cb).lanes
               for b, l, c, n, ch, cb, *_ in SCAN_CASES}
    assert reached == set(LANES)
    # N = 128 takes a whole warp a channel
    assert tsk.plan_scan(1, 40, 70, 128, 2, 16, 32).lanes == 32
    # L = 1 stages one chunk of 16 steps; a short grid takes 8 channels
    plan = tsk.plan_scan(3, 1, 72, 16, 2, 64, 64)
    assert (plan.chunk, plan.channels) == (16, 8)


@pytest.mark.parametrize("n", [0, 129, 256])
def test_scan_plan_refuses_state_sizes_the_kernel_does_not_take(n):
    with pytest.raises(ValueError):
        tsk.plan_scan(*TRAIN_SHAPE[:3], n, 2)


@pytest.mark.parametrize("n,channels,chunk", [
    (16, 4, 64),     # 16 threads: not a whole warp
    (16, 128, 64),   # 512 threads
    (16, 64, 24),    # a chunk of part of a 16-step group
    (128, 8, 16),    # a chunk shorter than the 32-step reduce-scatter
    (128, 8, 256),   # past the card's shared memory
    (129, 8, 64),    # N past 128
])
def test_make_plan_refuses_plans_the_kernel_does_not_take(n, channels,
                                                          chunk):
    with pytest.raises(ValueError):
        tsk.make_plan(2, 8192, n, 2, channels, chunk)


def test_scan_plan_reads_shapes_only():
    params = inspect.signature(tsk.plan_scan).parameters
    assert list(params) == ["b", "l", "c", "n", "itemsize", "chunk",
                            "c_block"]


# --------------------------------------------------------------------------
# the wrapper launches the plan
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


@pytest.mark.parametrize("shape,dtypes,chunk,c_block,codes", [
    ((2, 1024, 8192, 16), (torch.bfloat16,) * 2, 256, 64, (1, 1)),
    ((1, 50, 24, 16), (torch.float32,) * 2, 32, 8, (0, 0)),
    ((2, 100, 200, 64), (torch.bfloat16,) * 2, 32, 64, (1, 1)),
    ((1, 40, 70, 128), (torch.float32,) * 2, 16, 32, (0, 0)),
    # bf16 x with fp32 dt: fp32 storage, y in x's bf16
    ((2, 200, 1024, 16), (torch.bfloat16, torch.float32), 64, 64, (0, 1)),
])
def test_scan_wrapper_launches_the_plan(fake_card, shape, dtypes, chunk,
                                        c_block, codes):
    b, l, c, n = shape
    x = torch.empty((b, l, c), device="meta", dtype=dtypes[0])
    dt = torch.empty((b, l, c), device="meta", dtype=dtypes[1])
    bc = torch.empty((b, l, n), device="meta", dtype=dtypes[0])
    A = torch.empty((c, n), device="meta")
    D = torch.empty((c,), device="meta")
    y = tsk.selective_scan_cuda(x, dt, A, bc, bc, D, chunk=chunk,
                                c_block=c_block)
    assert y.dtype == x.dtype and y.shape == x.shape
    args = fake_card.calls["repro_selective_scan"]
    itemsize = 4 if codes[0] == 0 else 2
    plan = tsk.plan_scan(b, l, c, n, itemsize, chunk, c_block)
    # B, L, C, N, then the plan, then the storage and output types
    assert args[7:11] == (b, l, c, n)
    assert args[11:14] == (plan.lanes, plan.channels, plan.chunk)
    assert args[14:16] == codes
    assert cuda_lib.LAUNCHES["selective_scan"] == 1


def test_scan_launches_an_explicit_plan(fake_card):
    """A sweep's plan (``make_plan``) goes to the entry point as it is."""
    b, l, c, n = 2, 64, 256, 16
    x = torch.empty((b, l, c), device="meta", dtype=torch.bfloat16)
    bc = torch.empty((b, l, n), device="meta", dtype=torch.bfloat16)
    A = torch.empty((c, n), device="meta")
    D = torch.empty((c,), device="meta")
    plan = tsk.make_plan(b, c, n, 2, 16, 32)
    tsk.launch_scan(plan, x, x, A, bc, bc, D)
    assert fake_card.calls["repro_selective_scan"][11:14] == (4, 16, 32)
    assert cuda_lib.LAUNCHES["selective_scan"] == 1
    with pytest.raises(ValueError):  # shapes that disagree
        tsk.launch_scan(plan, x, x, A[:, :8], bc, bc, D)


# --------------------------------------------------------------------------
# the reduce-scatter's index mapping
# --------------------------------------------------------------------------

def reduce_scatter(acc, lanes):
    """``reduce_scatter<LPC = lanes, G>`` of ``selective_scan.cu`` over
    ``acc`` of (lanes, G): round r halves what each lane keeps and adds the
    other half of its partner's (lane g ^ m)."""
    lane = torch.arange(lanes)
    m = lanes // 2
    while m >= 1:
        half = acc.shape[1] // 2
        up = ((lane & m) != 0)[:, None]
        lo, hi = acc[:, :half], acc[:, half:]
        send = torch.where(up, lo, hi)
        keep = torch.where(up, hi, lo)
        acc = keep + send[lane ^ m]
        m //= 2
    return acc


@pytest.mark.parametrize("lanes", LANES)
def test_reduce_scatter_leaves_each_lane_its_own_steps(lanes):
    g_steps = tsk.group_steps(lanes)
    q = g_steps // lanes
    acc = torch.from_numpy(np.random.default_rng(lanes).normal(
        size=(lanes, g_steps))).double()
    out = reduce_scatter(acc, lanes)
    assert out.shape == (lanes, q)
    # lane g ends with steps g Q .. g Q + Q - 1: those it loaded x and dt of
    steps = torch.arange(lanes)[:, None] * q + torch.arange(q)
    torch.testing.assert_close(out, acc.sum(0)[steps], rtol=1e-12,
                               atol=1e-12)
