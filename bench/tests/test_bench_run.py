"""Whole runs of the harness on the CPU at the smoke sizes, past its look
for a chip: a sound run is correct, and the check sees each fault that a
served cell can have, planted in the timed path, and the fp8 control.
The look for a chip and the ban on JAX run in fresh processes.

The fault of a multi-chip cell (the exchange between chips left out) has
no place here: every cell runs on one chip.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

import bench_smoke_setup as S
from bench_smoke_setup import one_thread  # noqa: F401
from benchkit import cell_run, driver

pytestmark = pytest.mark.usefixtures("one_thread")
CPU = torch.device("cpu")
SEED = 2 ** 31 + 4242
CELLS = S.SMOKE_CELLS


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = S.smoke_checkout(tmp_path_factory.mktemp("smoke"))
    # a mix that checks every finished request, added as a new file
    mix = dict(S.SMOKE_MIXES["batch-decode-smoke"], check_requests=1000)
    (root / "bench" / "mixes" / "check-all.json").write_text(json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for arch in S.SMOKE_PORT:
        cell = f"{arch}-smoke.check-all"
        bench["workloads"].append({"name": cell, "config": f"{arch}-smoke",
                                   "traffic": "check-all", "chips": 1,
                                   "why": "faults"})
        (root / "bench" / "limits" / f"{cell}.json").write_text(json.dumps(
            {"served_gap": {"limit": S.SMOKE_LIMIT}}))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


#: long enough that requests finish on a CPU shared with other test workers
SECONDS = 3.0


def _run(root, cell, seconds=SECONDS, **kw):
    return cell_run.run_cell(cell, SEED, seconds, False, CPU, 0.0, root,
                             root / "bench", log=lambda m: None, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(root, cell):
    r = _run(root, cell)
    assert r["correct"], r
    assert r["attempted"] > 0 and r["failed"] == 0
    names = set(r["metrics"])
    assert "setup_s" in names and len(names) >= 2
    assert list(r)[-1] == "checks"
    assert r["checks"]["served_gap"]["value"] <= S.SMOKE_LIMIT


def _state_unchanged(b):
    """The decode step computes its logits, then leaves the state as it
    found it (lengths, recurrent states and cache rows)."""
    step = b._decode

    def frozen(params, state, tokens):
        saved = [t.clone() for t in _tensors(state)]
        out = step(params, state, tokens)
        for t, s in zip(_tensors(state), saved):
            t.copy_(s)
        return out
    b._decode = frozen


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, tuple):
        return [t for x in tree for t in _tensors(x)]
    return []


def _half_batch(b):
    """The decode step computes the first half of the rows; the other
    half's logits are copies of the first half's."""
    step = b._decode

    def half(params, state, tokens):
        state, logits = step(params, state, tokens)
        n = logits.shape[0] // 2
        logits = logits.clone()
        logits[n:2 * n] = logits[:n]
        return state, logits
    b._decode = half


def _altered_token(monkeypatch):
    """One decode tick's tokens are altered where they are sampled."""
    from repro_torch.serving import scheduler

    real, calls = scheduler.sample_token, [0]

    def altered(logits, gen, temperature=0.0):
        tok = real(logits, gen, temperature)
        calls[0] += 1
        if calls[0] == 6:
            tok = (tok + 1) % logits.shape[-1]
        return tok
    monkeypatch.setattr(scheduler, "sample_token", altered)


@pytest.mark.parametrize("arch", sorted(S.SMOKE_PORT))
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "altered_token"])
def test_each_fault_makes_the_run_incorrect(root, monkeypatch, arch, fault):
    cell = f"{arch}-smoke.check-all"
    assert _run(root, cell)["correct"]
    if fault == "altered_token":
        _altered_token(monkeypatch)
    else:
        plant = {"state_unchanged": _state_unchanged,
                 "half_batch": _half_batch}[fault]
        real = driver.deploy

        def deploy(*a, **kw):
            b = real(*a, **kw)
            plant(b)
            return b
        monkeypatch.setattr(driver, "deploy", deploy)
    r = _run(root, cell)
    assert not r["correct"]
    assert r["checks"]["served_gap"]["value"] > S.SMOKE_LIMIT


@pytest.mark.parametrize("arch", sorted(S.SMOKE_PORT))
def test_the_fp8_control_fails_the_limit(root, arch):
    r = _run(root, f"{arch}-smoke.check-all", control=True)
    # the control stands in the program's place, and the run is not correct
    assert not r["correct"]
    assert r["checks"]["served_gap"]["value"] == r["control"]["control_gap"]
    assert r["control"]["program_gap"] <= S.SMOKE_LIMIT
    assert r["control"]["control_gap"] > S.SMOKE_LIMIT


def _fresh(code, cwd):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_a_run_loads_neither_jax_nor_the_jax_package(root):
    code = (
        "import sys, torch\n"
        f"sys.path[:0] = [{str(S.BENCH)!r}, {str(S.ROOT / 'src')!r}]\n"
        "from benchkit import cell_run\n"
        f"from pathlib import Path; root = Path({str(root)!r})\n"
        "cell_run.run_cell('falcon-mamba-7b-smoke.batch-decode-smoke', "
        "5, 1.0, False, torch.device('cpu'), 0.0, root, root / 'bench', "
        "log=lambda m: None)\n"
        "print(cell_run.forbidden_modules())\n")
    out = _fresh(code, root)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_the_chips_the_cell_asks_for():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = _fresh("import runpy, sys; sys.argv = ['run.py', '--workload', "
                 "'falcon-mamba-7b.batch-decode', '--seed', '1', "
                 "'--seconds', '1', '--trace', '0']; "
                 "runpy.run_path('bench/run.py', run_name='__main__')",
                 S.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_run_fails_where_the_program_is_absent(tmp_path):
    import shutil
    shutil.copytree(S.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(S.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import sys; sys.path[:0] = ['bench']\n"
            "from benchkit import spec\n"
            "spec.port_model_config(spec.load_cell("
            "'falcon-mamba-7b.batch-decode').config)\n")
    out = _fresh(code, tmp_path)
    assert out.returncode != 0
    assert "repro_torch" in out.stderr
