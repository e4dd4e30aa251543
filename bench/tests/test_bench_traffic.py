"""The traffic generator: deterministic from the seed, the same work for
every seed, and mixes found by name as new files."""

import json

import numpy as np
import pytest

import bench_smoke_setup as S  # noqa: F401  (puts bench/ and src/ on the path)
from benchkit import spec, traffic

BATCH = json.loads((S.BENCH / "mixes" / "batch-decode.json").read_text())
LONG = json.loads((S.BENCH / "mixes" / "long-prompt.json").read_text())


def _closed(seed):
    return [[(r.uid, r.prompt.tolist(), r.max_new_tokens) for r in q]
            for q in traffic.closed_loop(BATCH, seed, 65024)]


def test_closed_loop_is_deterministic_from_the_seed():
    big = 2 ** 31 + 977
    assert _closed(big) == _closed(big)
    assert _closed(big) != _closed(big + 1)


def test_closed_loop_rounds_hold_the_same_lengths_for_every_seed():
    def rounds(seed):
        qs = traffic.closed_loop(BATCH, seed, 65024)
        return [sorted((len(q[r].prompt), q[r].max_new_tokens) for q in qs)
                for r in range(1, BATCH["rounds"] + 1)]
    a, b = rounds(3), rounds(2 ** 32 + 5)
    assert a == b
    assert all(x == a[0] for x in a)
    lens = [p for p, _ in a[0]]
    assert min(lens) >= 64 and max(lens) <= 512
    outs = [o for _, o in a[0]]
    assert min(outs) >= 512 and max(outs) <= 2048


def test_closed_loop_starts_each_client_part_of_the_way_through():
    def first(seed):
        return sorted((len(q[0].prompt), q[0].max_new_tokens)
                      for q in traffic.closed_loop(BATCH, seed, 65024))
    a = first(3)
    assert a == first(2 ** 32 + 5)
    left = np.array([o for _, o in a])
    lo, hi = BATCH["output_len"]["lo"], BATCH["output_len"]["hi"]
    assert left.min() >= 1 and left.max() <= hi
    # the residual life of a uniform length: mean E[L^2] / (2 E[L])
    mean_l = (lo + hi) / 2
    want = (mean_l ** 2 + (hi - lo) ** 2 / 12) / (2 * mean_l)
    assert left.mean() == pytest.approx(want, rel=0.02)
    assert sorted(p for p, _ in a) == sorted(
        len(q[1].prompt) for q in traffic.closed_loop(BATCH, 3, 65024))


def test_open_loop_is_deterministic_and_keeps_its_schedule():
    def plan(seed, mix=LONG):
        return traffic.open_loop(mix, seed, 65024, 50.0)
    a, b, c = plan(7), plan(7), plan(2 ** 31 + 8)
    assert [(r.due_s, r.prompt.tolist()) for r in a] == \
        [(r.due_s, r.prompt.tolist()) for r in b]
    # the seed draws the tokens; the schedule is the mix's
    assert [(r.due_s, len(r.prompt), r.max_new_tokens) for r in a] == \
        [(r.due_s, len(r.prompt), r.max_new_tokens) for r in c]
    assert [r.prompt.tolist() for r in a] != [r.prompt.tolist() for r in c]
    span = 50.0 + LONG["warm_s"]
    assert len(a) == round(LONG["rate_per_s"] * span)
    # arrivals start warm_s before the window
    assert -LONG["warm_s"] <= min(r.due_s for r in a) < 0.0
    other = plan(7, dict(LONG, schedule_seed=1))
    assert [r.due_s for r in other] != [r.due_s for r in a]
    gaps = lambda p: sorted(np.round(np.diff([-LONG["warm_s"]]
                                             + [r.due_s for r in p]),
                                     9))
    assert gaps(a) == gaps(other)
    assert max(r.due_s for r in a) <= (span * LONG["arrive_by"]
                                       - LONG["warm_s"] + 1e-9)
    lens = [len(r.prompt) for r in a]
    assert min(lens) >= 2048 and max(lens) <= 8192


def test_a_mix_added_as_a_new_file_is_found_by_name(tmp_path):
    root = S.smoke_checkout(tmp_path)
    mix = dict(S.SMOKE_MIXES["batch-decode-smoke"], clients=2, num_slots=2)
    (root / "bench" / "mixes" / "pairs.json").write_text(json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "falcon-mamba-7b-smoke.pairs",
                               "config": "falcon-mamba-7b-smoke",
                               "traffic": "pairs", "chips": 1,
                               "why": "added by a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("falcon-mamba-7b-smoke.pairs", root,
                          root / "bench")
    assert cell.mix == mix
    assert cell.config["name"] == "falcon-mamba-7b-smoke"
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]
