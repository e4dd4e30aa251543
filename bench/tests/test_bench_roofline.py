"""The frozen counts of the yardstick, each held against a count by hand
at one shape, and the peaks' least time."""

import json

import pytest

import bench_smoke_setup as S
from benchkit import peaks, spec


def _mod(name):
    return spec.load_module(S.BENCH / "roofline" / f"{name}.py")


def _sizes(config):
    return json.loads((S.BENCH / "configs" / f"{config}.json")
                      .read_text())["port"]


def test_selective_scan_counts_at_falcon_mamba_width():
    # one 4096-token prompt: L 4096, C 8192, N 16; 6 LCN + 3 LC
    # operations; x, dt, y (LC) and B, C (LN) at 2 bytes, A (CN), the
    # final state (CN) and D (C) at 4
    flops, nbytes = _mod("selective_scan").work(4096, 8192, 16)
    assert flops == 3_221_225_472 + 100_663_296
    assert nbytes == 201_588_736 + 1_081_344


def test_paged_decode_counts_by_hand():
    # one row over 1000 cached rows, 32 / 32 heads of 160, pages of 64:
    # 4 * 1000 * 32 * 160 operations; K and V rows, q and o at 2 bytes,
    # 16 table entries and the length at 4
    flops, nbytes = _mod("paged_decode_attention").work(1000, 32, 32, 160,
                                                        64)
    assert flops == 20_480_000
    assert nbytes == 20_500_480 + 68


def test_falcon_mamba_model_flops():
    # a layer's products: 2 * (2*4096*8192 + 8192*288 + 256*8192 +
    # 8192*4096) = 210_239_488; conv 65_536; scan 99 * 8192 = 811_008
    s = _sizes("falcon-mamba-7b")
    m = _mod("model_mamba1")
    layer = 210_239_488 + 65_536 + 811_008
    head = 2 * 4096 * 65024
    assert m.decode_flops(s, 1234) == 64 * layer + head
    assert m.prefill_flops(s, 100) == 100 * 64 * layer + head
    # twice the parameters a token, within the norms' and the scan's share
    params = 64 * (2 * 4096 * 8192 + 8192 * 288 + 256 * 8192
                   + 8192 * 4096) + 4096 * 65024
    assert m.decode_flops(s, 1) == pytest.approx(2 * params, rel=0.01)


def test_least_time_takes_the_larger_bound():
    # 1 GB at 3.35 TB/s against 1 TFLOP at 989 TFLOP/s
    assert peaks.least_seconds(1e12, 1e9, "bf16") == pytest.approx(1 / 989)
    assert peaks.least_seconds(1e9, 1e12, "bf16") == pytest.approx(1 / 3.35)
