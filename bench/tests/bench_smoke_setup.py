"""A benchmark at the smoke sizes, written into a temporary checkout, for
the CPU tests: the same harness and files as ``bench/``, with smoke
configurations, short mixes and cells that name them, all added as new
files the way a later change would add them."""

from __future__ import annotations

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SMOKE_PORT = {
    "falcon-mamba-7b": {"num_layers": 2, "d_model": 64, "vocab_size": 128,
                        "ssm_state": 4, "dtype": "float32"},
}

SMOKE_MIXES = {
    "batch-decode-smoke": {
        "loop": "closed", "clients": 4, "num_slots": 4, "rounds": 4,
        "prompt_len": {"dist": "uniform", "lo": 8, "hi": 24},
        "output_len": {"dist": "uniform", "lo": 6, "hi": 20},
        "check_requests": 3},
    "long-prompt-smoke": {
        "loop": "open", "rate_per_s": 20.0, "arrive_by": 0.9,
        "schedule_seed": 0, "warm_s": 0.5,
        "num_slots": 4,
        "prompt_len": {"dist": "log_uniform", "lo": 32, "hi": 96},
        "output_len": {"dist": "uniform", "lo": 2, "hi": 6},
        "check_requests": 3},
}

#: the cells of ``BENCHMARK.json``; each has a smoke counterpart
_FULL = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
FULL_CELLS = [w["name"] for w in _FULL]
SMOKE_CELLS = [f"{w['config']}-smoke.{w['traffic']}-smoke" for w in _FULL]

@pytest.fixture
def one_thread():
    """Torch on one CPU thread for the test: the smoke sizes gain nothing
    from more, and test workers that share the cores would oversubscribe
    them (a window then serves nothing)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


#: the limit of the smoke cells: a program in fp32 against the fp32
#: reference agrees to rounding
SMOKE_LIMIT = 1e-3


def smoke_checkout(tmp: Path) -> Path:
    """A copy of ``bench/`` under ``tmp`` with smoke cells added; returns
    the checkout root (``tmp``)."""
    bench = tmp / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    configs, cells = [], []
    for arch, port in SMOKE_PORT.items():
        cfg = json.loads((BENCH / "configs" / f"{arch}.json").read_text())
        cfg = copy.deepcopy(cfg)
        name = f"{arch}-smoke"
        cfg["name"] = name
        cfg["port"].update(port)
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        configs.append({"name": name, "source": cfg["source"],
                        "file": f"bench/configs/{name}.json",
                        "reduced": [], "why": "smoke"})
        for mix in SMOKE_MIXES:
            cell = f"{name}.{mix}"
            cells.append({"name": cell, "config": name, "traffic": mix,
                          "chips": 1, "why": "smoke"})
            (bench / "limits" / f"{cell}.json").write_text(json.dumps(
                {"served_gap": {"limit": SMOKE_LIMIT}}))
    for mix, body in SMOKE_MIXES.items():
        (bench / "mixes" / f"{mix}.json").write_text(json.dumps(body))
    spec["configs"] += configs
    spec["workloads"] += cells
    # each smoke cell reports what its full-size counterpart reports
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [
                c["name"] for c in cells
                if c["name"].replace("-smoke", "") in m["workloads"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp
