"""The port's launch geometry (``repro_torch.envs.measure.LaunchGeometry``)
against the Hopper kernels' own launch records, on the CPU.

- At phase 4d's three cells (``launch_workload_for``: serve llama3.2-1b
  4 x 96, train falcon-mamba-7b and zamba2-2.7b 2 x 1024) and one tiny
  cell, for every point of each family's launch space: the geometry's
  grid and shared bytes are the sum and the maximum over the family's
  ``launch_records`` for the tensors ``WallClockBackend`` draws (on
  ``meta``), read off those tensors' shapes and dtypes here; the paged
  decode's over a pool of the launch's geometry.
- Configurations whose launches are equal price equal: equal records
  (the inert ``rmsnorm.row_block``, the scan's snapped points) and, for
  the paged decode, the same pool geometry (``prefill_chunk`` changes only
  admission).
- ``paged_attention.page_size=256`` is admitted at the default budget (by
  ``AnalyticBackend``, ``WallClockBackend``'s gate and
  ``ReplayServingEnv.infeasible_reason``) and refused under a budget below
  its block's shared bytes.
- Blocks within one wave add no overhead; a launch's overhead is charged
  once, a second wave costs a wave.
- Each ``SHIFT_KINDS`` kind moves the price as its docstring says.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_model_config
from repro_torch.envs import measure
from repro_torch.envs.measure import (AnalyticBackend, KernelWorkload,
                                      LaunchGeometry, ShiftedAnalyticBackend,
                                      WallClockBackend, family_params)
from repro_torch.envs.replay_env import ReplayServingEnv
from repro_torch.kernels import cuda_lib, dispatch
from repro_torch.kernels.cuda_lib import LaunchWork
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.mamba_scan import kernel as scan_kernel
from repro_torch.kernels.paged_attention import kernel as paged_kernel
from repro_torch.kernels.rmsnorm import kernel as rms_kernel
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.launch.tune import launch_workload_for

DRAWN = ("flash_attention", "mamba_scan", "rmsnorm", "ssd")
FAMILIES = DRAWN + ("paged_attention",)
TINY = KernelWorkload(name="tiny", batch=1, seq_len=64, heads=2, kv_heads=1,
                      head_dim=16, d_model=32, channels=64, scan_state=4,
                      ssm_heads=2, ssm_head_dim=16, ssm_state=8)
#: phase 4d's cells (chip_smoke.TUNE_LAUNCH_CELLS)
CHIP_CELLS = (("serve", "llama3.2-1b", 4, 96), ("train", "falcon-mamba-7b", 2,
                                                 1024),
              ("train", "zamba2-2.7b", 2, 1024))
CELLS = {"tiny": lambda: TINY, **{
    arch: (lambda kind=kind, arch=arch, b=b, t=t: launch_workload_for(
        get_model_config(arch), b, t, kind=kind))
    for kind, arch, b, t in CHIP_CELLS}}


def _records(family, inputs, params):
    """The family's launch records for ``inputs`` (the tensors a call
    takes), their shape and dtype read off the tensors."""
    if family == "flash_attention":
        q, k, _ = inputs
        b, s, hq, d = q.shape
        shape = dict(d=d, dv=d, g=hq // k.shape[2], causal=True,
                     decode=False, batch=b, kv_heads=k.shape[2], sq=s,
                     skv=k.shape[1])
        return flash_kernel.launch_records(shape, q.dtype, **params)
    if family == "mamba_scan":
        x, dt, A, Bm, Cm, _ = inputs
        b, l, c = x.shape
        store = (torch.float32 if scan_kernel.storage_size(x, dt, Bm, Cm) == 4
                 else x.dtype)
        shape = dict(batch=b, len=l, channels=c, n=A.shape[1],
                     return_state=False)
        records = scan_kernel.launch_records(shape, x.dtype,
                                             dt_dtype=dt.dtype, **params)
        # the kernel runs on the storage the wrapper picks, y in x's dtype
        names = cuda_lib.CTYPE_NAMES
        assert all(r.kernel.startswith(
            f"repro::scan::selective_scan_kernel<{names[store]}, "
            f"{names[x.dtype]},") for r in records)
        return records
    if family == "ssd":
        x, _, _, Bm, _, _ = inputs
        b, l, h, p = x.shape
        shape = dict(batch=b, len=l, heads=h, p=p, groups=Bm.shape[2],
                     n=Bm.shape[3], states=False)
        return ssd_kernel.launch_records(shape, x.dtype, **params)
    if family == "rmsnorm":
        x, _ = inputs
        shape = dict(rows=x.numel() // x.shape[-1], dim=x.shape[-1])
        return rms_kernel.launch_records(shape, x.dtype, **params)
    if family == "paged_attention":
        q, pool, table = inputs
        shape = dict(batch=q.shape[0], kv_heads=pool.shape[2],
                     g=q.shape[2] // pool.shape[2], d=q.shape[3])
        assert table.shape[1] * pool.shape[1] == (
            params["page_size"] * params["pages_per_slot_max"])
        return paged_kernel.launch_records(shape, q.dtype, **params)
    raise KeyError(family)


def _paged_inputs(w, params):
    """One decode step's q, K pool and page table for ``w``'s slots over
    tables of the launch's geometry (``meta``)."""
    pages, ps = params["pages_per_slot_max"], params["page_size"]
    meta = dict(device="meta", dtype=torch.bfloat16)
    return (torch.empty(w.batch, 1, w.heads, w.head_dim, **meta),
            torch.empty(w.batch * pages, ps, w.kv_heads, w.head_dim, **meta),
            torch.empty(w.batch, pages, device="meta", dtype=torch.int32))


@pytest.fixture(scope="module")
def backends():
    """``WallClockBackend`` of each cell on ``meta`` (its inputs drawn as
    on the card, their storage never allocated)."""
    return {name: WallClockBackend(make(), DRAWN, seed=2, device="meta")
            for name, make in CELLS.items()}


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_grid_and_smem_are_the_records_of_what_wallclock_launches(
        backends, cell, family):
    backend = backends[cell]
    geometry = backend.geometry
    points = dispatch.launch_space([family]).grid()
    for point in points:
        params = family_params(family, point)
        inputs = (_paged_inputs(backend.workload, params)
                  if family == "paged_attention" else backend.inputs(family))
        records = _records(family, inputs, params)
        _, grid, vmem, _, _ = geometry.family_cost(family, params)
        assert grid == sum(math.prod(r.grid) for r in records)
        assert vmem == max(r.smem for r in records)
        assert (geometry.record(family, params),) == tuple(records)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_equal_records_price_equal(backends, cell):
    geometry = backends[cell].geometry
    groups = {}
    for family in FAMILIES:
        for point in dispatch.launch_space([family]).grid():
            params = family_params(family, point)
            r = geometry.record(family, params)
            key = (family, r.kernel, r.grid, r.block, r.smem)
            if family == "paged_attention":
                # the pool's geometry is an argument of the launch, not
                # in its record: the rows a split walks, the table read
                key += (params["page_size"], params["pages_per_slot_max"])
            groups.setdefault(key, set()).add(
                geometry.family_cost(family, params))
    assert all(len(prices) == 1 for prices in groups.values())
    # knobs that change no launch: prefill_chunk, and row_block where a
    # row takes more than one warp (phase 4d's cells, not the tiny one)
    inert = [("paged_attention", "prefill_chunk")]
    if cell != "tiny":
        inert.append(("rmsnorm", "row_block"))
    for family, knob in inert:
        domain = dispatch.get_family(family).option(knob).values
        prices = {geometry.family_cost(family, family_params(
            family, {f"{family}.{knob}": v})) for v in domain}
        assert len(prices) == 1, (family, knob, prices)


def test_scan_snapped_points_price_equal_at_the_falcon_cell(backends):
    geometry = backends["falcon-mamba-7b"].geometry
    points = dispatch.launch_space(["mamba_scan"]).grid()
    prices = {geometry.family_cost("mamba_scan",
                                   family_params("mamba_scan", p))
              for p in points}
    # 12 points of the space, 8 distinct launches (phase 4d's count)
    assert len(points) == 12 and len(prices) == 8


PAGE_256 = {"paged_attention.page_size": 256,
            "paged_attention.pages_per_slot_max": 8,
            "paged_attention.prefill_chunk": 0}


def test_page_256_is_admitted_and_refused_below_its_block():
    cell = KernelWorkload()
    counters, y = AnalyticBackend(cell, ["paged_attention"]).measure(PAGE_256)
    assert np.isfinite(y) and counters["vmem_peak_bytes"] == 72768
    assert counters["vmem_peak_bytes"] <= cell.vmem_limit
    tight = dataclasses.replace(cell, vmem_limit=72767)
    assert AnalyticBackend(tight, ["paged_attention"]).measure(
        PAGE_256)[1] == float("inf")
    # WallClockBackend's gate admits it: the call reaches the inputs (the
    # paged family is measured through ReplayServingEnv); below the block
    # it returns inf without drawing anything
    wall = WallClockBackend(cell, ["paged_attention"], device="cpu")
    with pytest.raises(KeyError, match="ReplayServingEnv"):
        wall.measure(PAGE_256)
    wall = WallClockBackend(tight, ["paged_attention"], device="cpu")
    assert wall.measure(PAGE_256)[1] == float("inf") and not wall._inputs


def test_page_256_is_deployable_in_the_replay_env():
    spec = "poisson:rate=2000,horizon=0.005,mean_prompt=5,mean_output=3," \
           "max_len=12"
    fams = ("flash_attention", "paged_attention", "rmsnorm")
    env = ReplayServingEnv(spec, families=fams, cell=KernelWorkload(),
                           device="cpu")
    config = dict(env.space.default_config(), **PAGE_256,
                  **{"pages.paging": "on"})
    assert env.infeasible_reason(config) == ""
    tight = ReplayServingEnv(spec, families=fams, device="cpu",
                             cell=KernelWorkload(vmem_limit=72767))
    assert tight.infeasible_reason(config) == "vmem"


def test_blocks_within_one_wave_add_no_overhead():
    w = KernelWorkload(batch=1, seq_len=1, d_model=8)
    one = LaunchGeometry(w)
    rec = one.record("rmsnorm", {"row_block": 4})
    slots = measure.H100_SM_COUNT * measure.resident_blocks(rec)
    # rows of one warp a block, four rows a block: a full wave
    full = LaunchGeometry(dataclasses.replace(w, seq_len=4 * slots))
    t1 = one.family_cost("rmsnorm", {"row_block": 4})[0]
    tw = full.family_cost("rmsnorm", {"row_block": 4})
    assert tw[1] == slots
    work = full.work("rmsnorm", {"row_block": 4})
    bytes_us = work.hbm / full.hardware.hbm_bytes_per_us
    compute_us = work.flops / full.hardware.vpu_flops_per_us
    # one overhead, then the wave's bytes or compute: nothing a block
    assert tw[0] == pytest.approx(w.launch_overhead_us
                                  + max(bytes_us, compute_us))
    assert t1 == pytest.approx(w.launch_overhead_us, abs=1e-3)
    assert tw[0] - t1 < 0.1 * w.launch_overhead_us
    # the reference's model charged each grid point: slots x 1.5 us
    assert tw[0] < slots * 1.5 / 100


def test_a_wave_of_work_costs_its_work_once_per_wave():
    geometry = LaunchGeometry(KernelWorkload())
    rec = geometry.record("rmsnorm", {"row_block": 4})
    work = LaunchWork(flops=0.0, exps=0.0, hbm=3.35e6)  # 1 us of bytes
    slots = measure.H100_SM_COUNT * measure.resident_blocks(rec)
    one = dataclasses.replace(rec, grid=(slots, 1, 1))
    two = dataclasses.replace(rec, grid=(2 * slots, 1, 1))
    overhead = geometry.workload.launch_overhead_us
    assert geometry.launch_us(one, work) == pytest.approx(overhead + 1.0)
    assert geometry.launch_us(two, work) == pytest.approx(overhead + 1.0)
    steps = work._replace(steps=np.full(2 * slots, 100))
    # a recurrence is paid by each wave's longest block
    step = measure.SCAN_STEP_US
    assert geometry.launch_us(one, steps) == pytest.approx(
        overhead + 100 * step)
    assert geometry.launch_us(two, steps) == pytest.approx(
        overhead + 200 * step)
    chained = work._replace(links=3)
    assert geometry.launch_us(one, chained) == pytest.approx(
        overhead + 1.0 + 3 * measure.CHAIN_LINK_US)


def test_blocks_that_share_an_sm_take_its_time_a_tile():
    sms = measure.H100_SM_COUNT
    serial = LaunchGeometry.serial_us
    # alone on its SM a block walks its tiles at its latency
    assert serial(np.full(sms, 10), 1.0, 0.5) == pytest.approx(10.0)
    # three blocks an SM: the SM's time a tile holds each back
    assert serial(np.full(3 * sms, 10), 1.0, 0.5) == pytest.approx(15.0)
    # dealt in launch order: SM 0 takes a block of 10 tiles and one of 4;
    # two walk 4 tiles at max(1.0, 2 x 0.6), the longer 6 more alone
    steps = np.zeros(2 * sms)
    steps[0], steps[sms] = 10, 4
    assert serial(steps, 1.0, 0.6) == pytest.approx(4 * 1.2 + 6 * 1.0)
    # a prefill's tiles price from the table at the snapped blocks
    work = LaunchGeometry(CELLS["zamba2-2.7b"]()).work(
        "flash_attention", {"q_block": 48, "kv_block": 100})
    assert work.tile == (80, 80, 32, 64)
    assert LaunchGeometry.step_us(work) == measure.TILE_US[(80, 32, 64)]
    # a head dim off the table takes the next measured one up
    tiny = LaunchGeometry(dataclasses.replace(TINY, head_dim=8)).work(
        "flash_attention", {"q_block": 64, "kv_block": 64})
    assert tiny.tile[0] == 8 and LaunchGeometry.step_us(tiny) == \
        measure.TILE_US[(16, 64, 64)]


SHIFTED_FAMILIES = ("flash_attention", "mamba_scan", "paged_attention",
                    "rmsnorm", "ssd")
CHUNK_32 = {"ssd.chunk": 32}
CHUNK_64 = {"ssd.chunk": 64}


def _price(backend, config):
    return backend.geometry.totals(backend.families, config)


@pytest.mark.parametrize("kind", sorted(measure.SHIFT_KINDS))
def test_each_shift_kind_moves_the_price_as_documented(kind):
    base = AnalyticBackend(KernelWorkload(), SHIFTED_FAMILIES)
    shifted = ShiftedAnalyticBackend(KernelWorkload(), SHIFTED_FAMILIES,
                                     shifts=kind)
    _, t0, ok0 = _price(base, CHUNK_32)
    _, t1, ok1 = _price(shifted, CHUNK_32)
    assert ok0 and ok1
    # the default budget admits the SIMT SSD's 132,352-byte chunk-64 block
    assert _price(base, CHUNK_64)[2]
    halved = shifted.workload.vmem_limit < base.workload.vmem_limit
    assert _price(shifted, CHUNK_64)[2] is not halved
    w0, w1 = base.workload, shifted.workload
    if kind == "noise":  # the price stands; the noise grows with it
        assert t1 == t0
        assert shifted._sigma(t0) > base._sigma(t0)
        return
    if kind == "workload":  # twice the sequence, half the batch
        assert (w1.seq_len, w1.batch) == (2 * w0.seq_len, w0.batch // 2)
    if kind == "resize":  # the survivors' larger batch
        assert w1.batch == int(w0.batch * 1.5)
    if kind in ("hardware", "straggler", "severe"):  # a slower card
        assert shifted.hardware.hbm_bytes_per_us < \
            base.hardware.hbm_bytes_per_us
        assert w1.launch_overhead_us > w0.launch_overhead_us
    if kind == "feasibility":  # only the budget: the same price
        assert halved and t1 == t0
        return
    assert t1 > t0
