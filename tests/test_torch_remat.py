"""The reference's ``remat`` policies in the port's train step
(``models/transformer.py::remat``), on the CPU.

- Every family (dense GQA, MLA + MoE + MTP, Mamba-1, Mamba-2 / hybrid,
  vlm, audio) steps in one process, smoke configs in fp32, under
  ``"dots"`` and ``"full"``: metrics, every leaf's step-1 gradient and the
  final parameters equal the ``"none"`` run's bit for bit (a recompute
  runs the same ops on the same inputs).
- The dry run's trace of phase 4k's llama3.2-1b ``train_4k`` rank (the
  ``128x1`` data mesh, where activations dominate) peaks strictly lower
  under ``"dots"`` than ``"none"``, and under ``"full"`` than ``"dots"``;
  the recompute adds FLOPs and kernel scopes, and ``"full"`` keeps no
  forward product among the largest groups live at the peak.
- llama3.2-1b ``train_smoke``: the traced ``matmul_flops`` under each
  policy against the reference's compiled dots under the same ``remat``,
  on one device and at tp=2 (a subprocess with 4 forced XLA host devices
  compiles the reference).  ``"none"`` agrees number for number.  Under
  ``"dots"`` and ``"full"`` both counts are held (``ROADMAP.md`` queue 3):
  the reference compiles with ``prevent_cse=False``, and XLA merges the
  recomputed attention's ``Q K^T`` product with the one its recompute
  backward (``repro/kernels/ops.py::_recompute_vjp``) forms again; the
  port launches the attention kernel in the recompute and its plain
  backward forms ``Q K^T`` again, one ``Q K^T`` a layer more.
- llama3.2-1b at tp=2 + fsdp=2 under ``"full"`` on four gloo ranks
  against one process under ``"none"`` (metrics 1e-6, gradients 1e-5, as
  ``torch_sharded_cases.hold``), its collective bytes equal to the dry
  run's trace of the same run, the recompute's FSDP regathers included.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

import torch_sharded_cases as sc
from repro_torch.configs.registry import get_model_config, make_run
from repro_torch.launch import dryrun
from repro_torch.launch.build import lower_step
from repro_torch.launch.mesh import MeshSpec
from repro_torch.utils.config import MeshConfig

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
POLICIES = ("none", "dots", "full")
#: (id, arch, global batch, seq): one a family
FAMILIES = (
    ("dense", "llama3.2-1b", 4, 32),
    ("mla-moe-mtp", "deepseek-v3-671b", 2, 512),
    ("mamba1", "falcon-mamba-7b", 4, 32),
    ("mamba2-hybrid", "zamba2-2.7b", 4, 32),
    ("vlm", "llama-3.2-vision-11b", 2, 32),
    ("audio", "whisper-large-v3", 2, 32),
)
#: (tp, remat) -> (port traced matmul FLOPs, reference compiled dots) at
#: llama3.2-1b ``train_smoke``: one ``Q K^T`` a layer apart
HELD = {(1, "dots"): (406847488, 390070272),
        (1, "full"): (473956352, 457179136),
        (2, "dots"): (203423744, 195035136),
        (2, "full"): (236978176, 228589568)}
EXACT = ((1, "none"), (2, "none"))


def _loop(arch, b, s, remat):
    return sc.loop(sc.make_run(arch, b, s, dict(remat=remat)))


@pytest.mark.parametrize("fam", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_policies_step_as_none_bit_for_bit(fam):
    _, arch, b, s = fam
    _, logged, grads, params, _ = _loop(arch, b, s, "none")
    for remat in ("dots", "full"):
        _, got_logged, got_grads, got_params, _ = _loop(arch, b, s, remat)
        assert got_logged == logged, remat
        assert set(got_grads) == set(grads)
        for k, g in grads.items():
            assert torch.equal(got_grads[k], g), (remat, k)
        for k, p in params.items():
            assert torch.equal(got_params[k], p), (remat, k)


def test_policies_order_the_traced_peak():
    recs = {r: dryrun.dryrun_cell("llama3.2-1b", "train_4k",
                                  par_kv=f"tp=1,fsdp=1,remat={r}",
                                  mesh_kv="128x1", save=False,
                                  peak_tensors=4)
            for r in POLICIES}
    peak = {r: rec["memory_analysis"]["peak_bytes"]
            for r, rec in recs.items()}
    assert peak["none"] > peak["dots"] > peak["full"], peak
    flops = {r: rec["matmul_flops"] for r, rec in recs.items()}
    assert flops["none"] < flops["dots"] < flops["full"], flops
    # the largest groups live at the peak: without remat (and under
    # "dots", which saves them) the two MLP products of every layer,
    # under "full" none of the forward's products
    cfg = get_model_config("llama3.2-1b")
    mlp = f"mm bfloat16 ({2 * 4096}, {cfg.d_ff}) fwd"
    for r, rec in recs.items():
        groups = {what: count for _, count, what in rec["peak_tensors"]}
        assert groups.get(mlp) == (None if r == "full"
                                   else 2 * cfg.num_layers), (r, groups)
        assert sum(n for n, _, _ in rec["peak_tensors"]) <= peak[r]
    scopes = {r: rec["kernel_scopes"] for r, rec in recs.items()}
    layers = cfg.num_layers
    # the recompute launches each layer's attention and its two norms again
    for r in ("dots", "full"):
        assert scopes[r]["flash_attention"] == \
            scopes["none"]["flash_attention"] + layers
        assert scopes[r]["rmsnorm"] == scopes["none"]["rmsnorm"] + 2 * layers
        assert {k: v for k, v in scopes[r].items() if k.endswith("_bwd")} \
            == {k: v for k, v in scopes["none"].items()
                if k.endswith("_bwd")}


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    cells = [f"llama3.2-1b:train_smoke:{tp}:{r}" for tp, r in
             EXACT + tuple(HELD)]
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "torch_dryrun_reference.py"),
         *cells], env=env, capture_output=True, text=True, timeout=600,
        check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    return {tuple((int(c.split(":")[2]), c.split(":")[3])): v
            for c, v in got.items()}


def traced_matmul_flops(tp, remat):
    run = make_run("llama3.2-1b", "train_smoke", smoke=True)
    if tp > 1:
        run = run.replace(mesh=MeshConfig(shape=(1, tp),
                                          axes=("data", "model")),
                          parallel=run.parallel.replace(tp=tp, fsdp=1))
    run = run.replace(parallel=run.parallel.replace(remat=remat))
    _, traced = lower_step(run, MeshSpec.of(run.mesh.shape, run.mesh.axes))
    return traced.cost_analysis().matmul_flops


@pytest.mark.parametrize("tp,remat", EXACT, ids=[f"tp{t}-{r}"
                                                  for t, r in EXACT])
def test_none_equals_the_reference(reference, tp, remat):
    assert traced_matmul_flops(tp, remat) == reference[tp, remat] > 0


@pytest.mark.parametrize("tp,remat", sorted(HELD),
                         ids=[f"tp{t}-{r}" for t, r in sorted(HELD)])
def test_policies_held_against_the_reference(reference, tp, remat):
    port, ref = HELD[tp, remat]
    assert traced_matmul_flops(tp, remat) == port
    assert reference[tp, remat] == ref
    # the difference is one Q K^T a layer: 2 B (H / tp) S^2 D
    cfg = make_run("llama3.2-1b", "train_smoke", smoke=True)
    m, shape = cfg.model, cfg.shape
    qk = 2 * shape.global_batch * (m.num_heads // tp) * shape.seq_len ** 2 \
        * m.head_dim
    assert port - ref == m.num_layers * qk
    # and the policies no longer give one trace
    assert port > traced_matmul_flops(tp, "none")


FULL = ("llama-tp2-fsdp2-full", "llama3.2-1b", 4, 32,
        dict(tp=2, fsdp=2, remat="full"), None, "adamw")


def test_full_on_four_ranks_steps_as_one_process(tmp_path):
    records = sc.spawn(str(tmp_path), 4, (FULL,))
    # one process without remat: the sharded recompute gives its step
    plain = FULL[:4] + (dict(tp=2, fsdp=2), None, "adamw")
    sc.hold(records, plain)
