"""The port's dry-run group on the CPU: the op counter
(``launch/hlo_analysis.py``), ``lower_step``'s trace of rank 0's sharded
program (``launch/build.py``), ``launch/dryrun.py``,
``launch/roofline.py`` and ``tuner/compiled_env.py``.

- Kernel scopes: entered once per op call, by family; inside a scope the
  ops' FLOPs count and only the scope's boundary bytes (the counterpart of
  ``test_hlo_analysis.py::test_kernel_scope_elides_interior_bytes_keeps_flops``).
- The traced rank on hand counts: FSDP's all-gathers and reduce-scatters,
  TP's activation all-reduces, EP's all-to-alls on small meshes (each a
  collective the trace recorded, by kind and the mesh axes of its
  group); argument bytes per chip; the heads a rank computes where the
  split cuts through heads; the stream's sequence block under ``sp``.
- Data parallelism: the all-reduce bytes of the traced train step over
  two data ranks equal what two gloo ranks hand to
  ``torch.distributed.all_reduce`` in the same step (llama3.2-1b, and
  deepseek-v3-671b with its MoE statistics and MTP loss).
- ``roofline_from_record`` on a fixed record; ``CompiledPerfEnv`` (inf for
  a rejected plan and past the card's memory, finite otherwise, cached;
  counters and space as the reference's; an ``sp=1`` point priced, its
  all-reduces reduce-scatters and all-gathers); ``dryrun.main`` writes one
  record a cell with the reference's keys and reports a failing cell.

Only smoke cells are traced, and one production cell, llama3.2-1b
``decode_32k`` (under a second on this host).
"""

import dataclasses
import json
import math
import os

import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs.registry import get_smoke_config, make_run
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.build import lower_step
from repro_torch.launch.hlo_analysis import OpCounter, trace
from repro_torch.launch.mesh import MeshSpec
from repro_torch.models import moe
from repro_torch.utils.config import MeshConfig, TrainConfig
from repro_torch.utils.hardware import H100_SXM

torch.set_num_threads(1)

F32 = 4


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _smoke(arch, shape, mesh=None, **par):
    run = make_run(arch, shape, smoke=True)
    if par:
        run = run.replace(parallel=run.parallel.replace(**par))
    if mesh is not None:
        run = run.replace(mesh=MeshConfig(shape=tuple(mesh.values()),
                                          axes=tuple(mesh)))
    return run


def _lower(run):
    return lower_step(run, MeshSpec.of(run.mesh.shape, run.mesh.axes))


def _by(traced, kind, axes, nbytes=None):
    """The traced collectives of ``kind`` over the mesh axes ``axes``
    (of ``nbytes`` each when given)."""
    return [c for c in traced.counter.collectives
            if c.kind == kind and c.what == axes
            and (nbytes is None or c.nbytes == nbytes)]


# --------------------------------------------------------------------------
# the counter and the kernel scopes
# --------------------------------------------------------------------------

def test_kernel_scope_elides_interior_bytes_keeps_flops():
    q = _meta(64, 32)

    def body(q):
        return torch.exp(q @ q.t())

    def step(q):
        e = ops._scoped("flash_attention", body, q)
        return e + e

    counter = OpCounter()
    trace(step, (q,), train=False, counter=counter)
    c = counter.costs()
    assert c.flops == 2 * 64 * 64 * 32 + 2 * 64 * 64
    assert c.matmul_flops == 2 * 64 * 64 * 32
    # the scope reads q once and writes e once; the add reads e twice and
    # writes its result; the s -> e interior round trip is elided
    assert c.bytes_accessed == 64 * 32 * F32 + 64 * 64 * F32 \
        + 3 * 64 * 64 * F32
    assert c.kernel_scopes == {"flash_attention": 1}


def test_no_listener_means_the_scope_calls_through():
    assert ops.KERNEL_SCOPE.counter is None
    calls = []
    out = ops._scoped("rmsnorm", lambda *a, **k: calls.append((a, k)) or 7,
                      1, x=2)
    assert out == 7 and calls == [((1,), {"x": 2})]
    counter = OpCounter()
    with counter:
        assert ops.KERNEL_SCOPE.counter is counter
    assert ops.KERNEL_SCOPE.counter is None


@pytest.mark.parametrize("arch,shape,want", [
    ("llama3.2-1b", "prefill_smoke", {"rmsnorm": 5, "flash_attention": 2}),
    ("llama3.2-1b", "decode_smoke", {"rmsnorm": 5, "decode_attention": 2}),
    ("falcon-mamba-7b", "train_smoke",
     {"rmsnorm": 3, "selective_scan": 2, "rmsnorm_bwd": 3,
      "selective_scan_bwd": 2}),
    ("zamba2-2.7b", "prefill_smoke",
     {"rmsnorm": 9, "ssd": 4, "flash_attention": 2}),
])
def test_kernel_scopes_by_family_equal_the_op_calls(arch, shape, want,
                                                     monkeypatch):
    calls = {}
    for name in ("rmsnorm", "flash_attention", "decode_attention",
                 "selective_scan", "ssd"):
        def counted(*a, _name=name, _fn=getattr(ops, name), **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    ops.reset_recomputes()
    _, traced = _lower(_smoke(arch, shape))
    scopes = traced.cost_analysis().kernel_scopes
    assert scopes == want
    assert {k: v for k, v in scopes.items() if "_bwd" not in k} == calls
    assert {f"{k}_bwd": v for k, v in ops.RECOMPUTES.items() if v} == \
        {k: v for k, v in scopes.items() if k.endswith("_bwd")}


def test_fsdp_and_tp_rules_hand_count():
    """llama3.2-1b smoke, train, data 2 x model 2, tp=2, fsdp=2: the
    traced rank's collectives on a hand count."""
    run = _smoke("llama3.2-1b", "train_smoke", {"data": 2, "model": 2},
                 tp=2, fsdp=2)
    bundle, traced = _lower(run)
    cfg, n = run.model, run.model.num_layers
    rows = run.shape.global_batch // 2 * run.shape.seq_len
    # TP: wo and w_down a layer forward, their inputs' gradients backward,
    # the vocab-split embedding's partial rows and the head input's
    # gradient: each (rows, D) in the compute dtype (bf16); the
    # vocab-parallel loss's row maxima and its (sum of exponentials, gold
    # logit) pairs: (rows,) and (2, rows) in fp32
    tp = _by(traced, "all-reduce", "model")
    assert len(tp) == 2 * n * 2 + 2 + 2
    assert sorted(c.nbytes for c in tp) == sorted(
        [rows * cfg.d_model * 2] * (2 * n * 2 + 2) + [rows * F32,
                                                      2 * rows * F32])
    # FSDP: the stacked weights split over data (and model) gather their
    # block a layer slice, twice a step (the forward and the backward's
    # regather); the gradient reduce-scatters once
    params = dict(_param_specs(bundle))
    gathers = _by(traced, "all-gather", "data")
    scatters = _by(traced, "reduce-scatter", "data")
    want_g, want_s, uses, slices_all = 0, 0, 0, 0
    for path, (leaf, data, model) in params.items():
        if data == 1:
            continue
        slices = leaf.shape[0] if "blocks/" in path else 1
        want_g += 2 * leaf.numel() // (data * model) * 2
        want_s += leaf.numel() // model * F32
        uses += 2 * slices
        slices_all += slices
    assert len(gathers) == uses and len(scatters) == slices_all
    assert sum(c.nbytes for c in gathers) == want_g
    assert sum(c.nbytes for c in scatters) == want_s
    # data parallelism: only the parameters the data axes replicate (the
    # norms) all-reduce their gradient (one bucket), beside the loss's
    # sums (ce_loss, count, z_loss, accuracy) and the loss metric
    dp = F32 * sum(leaf.numel() // model for leaf, data, model in
                   params.values() if data == 1)
    assert run.train.z_loss > 0
    assert sorted(c.nbytes for c in _by(traced, "all-reduce", "data")) == \
        sorted([dp, 4 * F32, F32])
    # the global norm: every split leaf is split over both axes
    assert [c.nbytes for c in _by(traced, "all-reduce", "data,model")] == \
        [F32]
    # every argument leaf's block, exact
    mem = traced.memory_analysis()
    assert mem.argument_size_in_bytes == _arg_bytes(bundle, run)


def test_sequence_split_traces_the_stream_at_a_rank_block():
    """llama3.2-1b smoke, train, data 2 x model 2, tp=2: under ``sp`` the
    traced stream is a rank's sequence block, so the RMSNorm scopes (all
    on the stream) count half the bytes they count without it, and the
    matmuls count the same (each sublayer reads its gathered input)."""
    off, on = (_lower(_smoke("llama3.2-1b", "train_smoke",
                             {"data": 2, "model": 2}, tp=2, sp=sp))[1]
               for sp in (False, True))
    norm = {sp: t.counter.by_op["scope:rmsnorm"] for sp, t in
            ((False, off), (True, on))}
    assert norm[True][0] == norm[False][0]  # as many calls
    # the rows halve; the scales (a few hundred bytes) do not
    assert abs(norm[True][2] / norm[False][2] - 0.5) < 0.01
    assert on.counter.matmul_flops == off.counter.matmul_flops
    assert on.memory_analysis().temp_size_in_bytes <= \
        off.memory_analysis().temp_size_in_bytes


def test_prefill_sequence_split_traces_the_stream_at_a_rank_block():
    """llama3.2-1b smoke, prefill, data 2 x model 2, tp=2: under ``sp``
    the traced rank's stream is its sequence block, so the RMSNorm
    scopes (all on the stream) count half the rows, the matmuls count the
    same (each sublayer reads its gathered input), and the row-parallel
    all-reduces become reduce-scatters beside the sequence gathers."""
    off, on = (_lower(_smoke("llama3.2-1b", "prefill_smoke",
                             {"data": 2, "model": 2}, tp=2, sp=sp))[1]
               for sp in (False, True))
    norm = {sp: t.counter.by_op["scope:rmsnorm"] for sp, t in
            ((False, off), (True, on))}
    assert norm[True][0] == norm[False][0]
    assert abs(norm[True][2] / norm[False][2] - 0.5) < 0.01
    assert on.counter.matmul_flops == off.counter.matmul_flops
    kinds = {sp: {(c.kind, c.what) for c in t.counter.collectives}
             for sp, t in ((False, off), (True, on))}
    assert ("reduce-scatter", "model") in kinds[True] - kinds[False]
    n = len(_by(off, "all-reduce", "model"))
    assert n and len(_by(on, "reduce-scatter", "model")) == n


def test_split_through_heads_traces_the_heads_a_rank_computes(monkeypatch):
    """llama4-maverick-400b-a17b's 40 query / 8 KV heads at tp=16 (its
    smoke config at published head counts): a rank's ``wo`` rows cross
    2.5 heads, and the traced rank 0 attends with the 3 it computes and
    the one KV head they read."""
    seen = []
    real = ops.flash_attention

    def recorded(q, k, v, *a, **kw):
        seen.append((q.shape[2], k.shape[2]))
        return real(q, k, v, *a, **kw)

    monkeypatch.setattr(ops, "flash_attention", recorded)
    run = _smoke("llama4-maverick-400b-a17b", "prefill_smoke",
                 {"data": 1, "model": 16}, tp=16)
    cfg = run.model.replace(num_heads=40, num_kv_heads=8, head_dim=16,
                            d_model=64, moe_num_experts=16)
    run = run.replace(model=cfg)
    _, traced = _lower(run)
    assert seen and set(seen) == {(3, 1)}
    # the query product's columns cut through heads: all-gathered
    assert _by(traced, "all-gather", "model")


def test_wider_stub_inputs_widen_the_audio_encoder_collectives():
    """whisper-large-v3 smoke, train in bf16, data 2 x model 2, tp=2,
    fsdp=2: with fp32 ``frames`` (the train CLI's) the encoder runs in
    fp32 (``mm`` promotes), so its model-axis collectives (the encoder
    layers' partial sums and input gradients, the encoder output's
    input-gradient all-reduce, ``frame_proj``'s gather) count 4 bytes an
    element where bf16 ones count 2, the decoder's stay at 2, and the
    weights that read the widened encoder (its layers, the decoder's
    cross K/V) are not gathered again in the backward (the products save
    widened copies)."""
    run = _smoke("whisper-large-v3", "train_smoke", {"data": 2, "model": 2},
                 tp=2, fsdp=2)
    assert run.train.compute_dtype == "bfloat16"
    cfg = run.model
    mesh = MeshSpec.of(run.mesh.shape, run.mesh.axes)
    bundle, narrow = lower_step(run, mesh, stub_dtype=torch.bfloat16)
    _, wide = lower_step(run, mesh, stub_dtype=torch.float32)
    b = run.shape.global_batch // 2
    enc = b * cfg.encoder_seq * cfg.d_model   # elements of the encoder's
    dec = b * run.shape.seq_len * cfg.d_model  # and the decoder's stream
    assert enc != dec

    def n(traced, kind, nbytes):
        return len(_by(traced, kind, "model", nbytes))

    # each encoder layer's attention and MLP (forward, backward), and
    # enc_out entering the cross K/V once
    layers = cfg.encoder_layers or cfg.num_layers
    assert n(narrow, "all-reduce", 2 * enc) == 4 * layers + 1
    assert n(wide, "all-reduce", 4 * enc) == 4 * layers + 1
    assert n(wide, "all-reduce", 2 * enc) == 0
    assert n(wide, "all-reduce", 2 * dec) == \
        n(narrow, "all-reduce", 2 * dec) > 0
    assert n(narrow, "all-gather", 2 * enc // 2) == 1  # frame_proj
    assert n(wide, "all-gather", 4 * enc // 2) == 1
    # the FSDP leaves that read the encoder's output in fp32
    widened = [path for path, (leaf, data, model) in _param_specs(bundle)
               if data > 1 and (path.startswith("enc_blocks/")
                                or path.endswith(("cross/wk", "cross/wv")))]
    assert widened
    assert len(_by(narrow, "all-gather", "data")) - \
        len(_by(wide, "all-gather", "data")) == len(widened)


def _leaves(arg, plc, path=""):
    """``(path, leaf, placements)`` of an argument tree beside its tree of
    placements."""
    if isinstance(arg, dict):
        for k in sorted(arg):
            yield from _leaves(arg[k], plc[k], f"{path}{k}/")
    elif isinstance(arg, (list, tuple)):
        names = arg._fields if hasattr(arg, "_fields") else range(len(arg))
        for name, a, p in zip(names, arg, plc):
            yield from _leaves(a, p, f"{path}{name}/")
    elif arg is not None:
        yield path[:-1], arg, plc


def _split(spec, mesh, axes):
    return math.prod(mesh.shape[a] for entry in spec if entry is not None
                     for a in ((entry,) if isinstance(entry, str) else entry)
                     if a in axes)


def _param_specs(bundle):
    from repro_torch.launch.build import _spec_of
    mesh = MeshSpec.of((2, 2), ("data", "model"))
    for path, leaf, pl in _leaves(bundle.abstract_args[0],
                                  bundle.in_shardings[0]):
        if isinstance(leaf, torch.Tensor) and path.startswith("params/"):
            spec = _spec_of(pl, mesh)
            yield (path.removeprefix("params/"),
                   (leaf, _split(spec, mesh, ("data",)),
                    _split(spec, mesh, ("model",))))


def _arg_bytes(bundle, run, args=None):
    """Each leaf's bytes over the mesh axes its placements shard (of the
    arguments ``args``, every one by default)."""
    from torch.distributed.tensor import Shard
    sizes = dict(zip(run.mesh.axes, run.mesh.shape))
    total = 0
    for i, (arg, plc) in enumerate(zip(bundle.abstract_args,
                                       bundle.in_shardings)):
        if args is not None and i not in args:
            continue
        for _, leaf, pl in _leaves(arg, plc):
            if isinstance(leaf, torch.Tensor):
                split = math.prod(sizes[a] for a, p in zip(run.mesh.axes, pl)
                                  if isinstance(p, Shard))
                total += leaf.numel() * leaf.element_size() // split
    return total


def test_tp_divides_the_step():
    """tp=2 over a model axis of 2 takes about half the FLOPs a chip of
    the unsplit step does: every matmul but the embedding's reads a split
    weight or a split activation."""
    whole = _lower(_smoke("llama3.2-1b", "prefill_smoke"))[1]
    split = _lower(_smoke("llama3.2-1b", "prefill_smoke",
                          {"data": 1, "model": 2}, tp=2))[1]
    ratio = split.cost_analysis().matmul_flops / \
        whole.cost_analysis().matmul_flops
    assert ratio == pytest.approx(0.5, abs=1e-9)
    assert not whole.counter.collectives and split.counter.collectives


def test_ep_all_to_all_hand_count():
    """deepseek-v3-671b smoke, experts over the data axes (2), routing
    groups of 128 (a rank's 2 x 64 tokens; the global batch's groups are
    the same): each MoE layer sends the (G, E, C, D) expert tensor to the
    experts' ranks and back, twice in a train step."""
    run = _smoke("deepseek-v3-671b", "train_smoke", {"data": 2, "model": 1},
                 moe_expert_axis="data", moe_group_size=128)
    cfg = run.model
    _, traced = _lower(run)
    t = run.shape.global_batch // 2 * run.shape.seq_len
    tg = moe._group_size(t, run.parallel.moe_group_size)
    cap = moe.capacity(cfg, tg, dropless=False)
    expert = (t // tg) * cfg.moe_num_experts * cap * cfg.d_model * 2
    a2a = _by(traced, "all-to-all", "data")
    routed = cfg.num_layers + cfg.mtp_depth  # every layer routes in smoke
    assert len(a2a) == routed * 2 * 2
    assert {c.nbytes for c in a2a} == {expert}
    # the router statistics: two all-reduces of E fp32 forward, one back
    # where the aux loss enters the loss (not the MTP head's)
    stats = _by(traced, "all-reduce", "data", cfg.moe_num_experts * F32)
    assert len(stats) == 3 * routed - cfg.mtp_depth


def test_production_decode_cell_arguments_and_scopes():
    """llama3.2-1b ``decode_32k`` on (16, 16) at its default plan: rank 0
    holds its parameter and token blocks under the placements, and its
    decode state as it executes it: its 8 slots, each KV cache at the KV
    heads its query heads read (tp=8 over 8 KV heads: one), where the
    placements (``cache_specs``) split the head width instead."""
    from repro_torch.models.attention import cache_heads
    from repro_torch.sharding.layout import Layout, Scope

    run = make_run("llama3.2-1b", "decode_32k")
    bundle, traced = _lower(run)
    cfg = run.model
    mesh = MeshSpec.of(run.mesh.shape, run.mesh.axes)
    layout = Layout.of(bundle.abstract_args[0], run,
                       MeshSpec.traced(run.mesh.shape, run.mesh.axes))
    heads = cache_heads(Scope(layout, "blocks/sub0/", True)["attn"], cfg)
    assert heads == cfg.num_kv_heads // run.parallel.tp == 1
    slots = run.shape.global_batch // mesh.size(("data",))
    caches = 2 * cfg.num_layers * slots * run.shape.seq_len * heads * \
        cfg.head_dim * 2
    placed = _arg_bytes(bundle, run, args=(0, 2))
    assert traced.memory_analysis().argument_size_in_bytes == \
        placed + caches + slots * 4 * (1 + cfg.num_layers)
    # one data rank's 8 slots: the scopes of one decode step
    assert traced.cost_analysis().kernel_scopes == {
        "rmsnorm": 2 * run.model.num_layers + 1,
        "decode_attention": run.model.num_layers}


# --------------------------------------------------------------------------
# data parallelism: the traced all-reduces against two gloo ranks
# --------------------------------------------------------------------------

#: (arch, global batch, seq): deepseek's 2 x 512 fill a routing group a rank
DP_CASES = (("llama3.2-1b", 4, 32), ("deepseek-v3-671b", 2, 512))


def _dp_run(arch, batch, seq):
    from repro_torch.launch import train as tlaunch
    cfg = get_smoke_config(arch).replace(dtype="float32")
    run = tlaunch.make_run(cfg, seq=seq, batch=batch, steps=1)
    return run.replace(train=TrainConfig(total_steps=1,
                                         compute_dtype="float32"))


def _dp_rank(rank, root):
    import torch.distributed as dist
    from repro_torch.data.pipeline import make_data
    from repro_torch.launch import train as tlaunch
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import init_train_state, \
        make_train_step

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(root, "store"), 2), rank=rank, world_size=2)
    handed = []
    real = dist.all_reduce

    def recording(tensor, *a, **k):
        handed.append(tensor.numel() * tensor.element_size())
        return real(tensor, *a, **k)

    dist.all_reduce = recording
    try:
        out = {}
        for arch, b, s in DP_CASES:
            run = _dp_run(arch, b, s)
            model = build_model(run.model, run.parallel, device="cpu")
            run, mesh = tlaunch.data_parallel(run, model.device)
            opt = make_optimizer(run.train)
            step = make_train_step(model, run, opt, mesh=mesh)
            state = init_train_state(model, run, opt, seed=0)
            data = tlaunch.rank_rows(make_data(run.model, run.shape, seed=0),
                                     mesh.data_group())
            handed.clear()
            step(state, data.batch_at(0))
            out[arch] = (list(handed), run)
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.all_reduce = real
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def dp_ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dryrun_dp"))
    mp.spawn(_dp_rank, args=(root,), nprocs=2, join=True)
    return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
            for r in range(2)]


@pytest.mark.parametrize("arch", [c[0] for c in DP_CASES])
def test_dp_all_reduce_bytes_equal_what_two_gloo_ranks_hand_over(dp_ranks,
                                                                  arch):
    handed, run = dp_ranks[0][arch]
    assert dp_ranks[1][arch][0] == handed
    _, traced = lower_step(run, MeshSpec.of((2,), ("data",)))
    recorded = [c.nbytes for c in traced.counter.collectives
                if c.kind == "all-reduce"]
    assert sorted(recorded) == sorted(handed) and sum(handed) > 0


# --------------------------------------------------------------------------
# roofline, CompiledPerfEnv, dryrun.main
# --------------------------------------------------------------------------

RECORD = {
    "arch": "llama3.2-1b", "shape": "decode_32k", "kind": "decode",
    "chips": 256,
    "hlo_analysis": {"flops_per_chip": 989e9, "bytes_per_chip": 6.7e9,
                     "total_collective_bytes_per_chip": 4.5e8},
}


def test_roofline_from_record_hand_computed():
    row = roofline.roofline_from_record(RECORD)
    assert row.compute_s == pytest.approx(1e-3)   # 989e9 / 989e12
    assert row.memory_s == pytest.approx(2e-3)    # 6.7e9 / 3.35e12
    assert row.collective_s == pytest.approx(1e-3)  # 4.5e8 / 450e9
    assert row.dominant == "memory" and row.step_time_s == pytest.approx(2e-3)
    n = get_smoke_config("llama3.2-1b")  # noqa: F841 (the config loads)
    mf = roofline.model_flops_for("llama3.2-1b", "decode", 128, 32768)
    assert row.model_flops == mf
    assert row.useful_ratio == pytest.approx(mf / (989e9 * 256))
    assert row.roofline_frac == pytest.approx(mf / 989e12 / 256 / 2e-3)
    assert "llama3.2-1b" in roofline.format_table([row])


def test_compiled_env(tmp_path):
    import repro.tuner.compiled_env as ref_env
    from repro.configs.registry import get_model_config as ref_config
    from repro.tuner.space import framework_space as ref_space
    from repro_torch.configs.registry import get_model_config
    from repro_torch.tuner.compiled_env import (CompiledPerfEnv,
                                                make_aligned_source)
    from repro_torch.tuner.space import framework_space

    assert CompiledPerfEnv.counter_names == \
        ref_env.CompiledPerfEnv.counter_names
    for arch in ("llama3.2-1b", "deepseek-v3-671b", "falcon-mamba-7b"):
        for kind in ("train", "prefill", "decode"):
            mine = framework_space(get_model_config(arch), kind).options
            ref = ref_space(ref_config(arch), kind).options
            assert [(o.name, tuple(o.values), o.default) for o in mine] == \
                [(o.name, tuple(o.values), o.default) for o in ref]
    assert [o.name for o in make_aligned_source().space.options] == \
        [o.name for o in ref_env.make_aligned_source().space.options]

    env = CompiledPerfEnv("llama3.2-1b", "decode_32k",
                          cache_dir=str(tmp_path))
    config = env.space.default_config()
    counters, y = env.intervene(config)
    assert set(counters) == set(env.counter_names)
    assert 0 < y < math.inf
    assert y == max(counters["compute_s"], counters["memory_s"],
                    counters["collective_s"])
    assert len(os.listdir(tmp_path)) == 1
    assert env.intervene(config) == (counters, y)  # from the cache
    # tp beyond the model axis: run.validate() rejects the plan
    assert env.intervene({**config, "tp": 32})[1] == math.inf
    small = CompiledPerfEnv("llama3.2-1b", "decode_32k",
                            cache_dir=str(tmp_path),
                            hardware=dataclasses.replace(
                                H100_SXM, hbm_capacity=2**20))
    assert small.intervene(config)[1] == math.inf  # past the card's memory


def test_compiled_env_prices_sequence_parallel_points(tmp_path, monkeypatch):
    """An ``sp=1`` point of the train space is a plan the port prices: on
    the smoke cell (llama3.2-1b ``train_smoke`` on a (2, 2) ``("data",
    "model")`` mesh at tp=2, standing in for the production cell) the step
    is finite, ``matmul_flops`` is the ``sp=0`` point's, and the
    row-parallel all-reduces become reduce-scatters beside the sequence
    all-gathers."""
    from repro_torch.configs.registry import make_run as registry_run
    from repro_torch.launch.dryrun import parallel_overrides
    from repro_torch.tuner.compiled_env import CompiledPerfEnv

    def smoke_cell(arch, shape, *, multi_pod=False, par_kv=None,
                   mesh_kv=None):
        run = registry_run(arch, "train_smoke", smoke=True)
        run = run.replace(mesh=MeshConfig(shape=(2, 2),
                                          axes=("data", "model")),
                          parallel=parallel_overrides(
                              run.parallel.replace(tp=2), par_kv))
        run.validate()
        return run

    monkeypatch.setattr(dryrun, "cell_run", smoke_cell)
    env = CompiledPerfEnv("llama3.2-1b", "train_4k", cache_dir=str(tmp_path))
    config = env.space.default_config()
    recs = {}
    for sp in (0, 1):
        counters, y = env.intervene({**config, "sp": sp})
        assert 0 < y < math.inf, sp
        (name,) = [n for n in os.listdir(tmp_path)
                   if f"sp-{sp}" in n]
        recs[sp] = json.loads((tmp_path / name).read_text())
    assert recs[1]["parallel"]["sp"] and not recs[0]["parallel"]["sp"]
    assert recs[1]["matmul_flops"] == recs[0]["matmul_flops"]
    off, on = (recs[sp]["hlo_analysis"]["collective_bytes_per_chip"]
               for sp in (0, 1))
    assert on["reduce-scatter"] > off["reduce-scatter"]
    assert on["all-gather"] > off["all-gather"]
    assert on["all-reduce"] < off["all-reduce"]


#: the reference's record keys (``repro/launch/dryrun.py:89-118``), with
#: ``xla_cost_analysis`` as ``op_cost_analysis``
REF_KEYS = {"arch", "shape", "kind", "mesh", "chips", "parallel", "status",
            "lower_s", "compile_s", "memory_analysis", "hlo_analysis",
            "collective_schedule_head"}


def test_dryrun_main_writes_a_record_a_cell(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))
    monkeypatch.setattr(roofline, "ARTIFACT_DIR", str(tmp_path))
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                        "--tag", "t"]) == 0
    (name,) = os.listdir(tmp_path)
    assert name == "llama3.2-1b__decode_32k__pod__t.json"
    rec = json.loads((tmp_path / name).read_text())
    assert REF_KEYS | {"op_cost_analysis", "matmul_flops",
                       "kernel_scopes"} == set(rec)
    assert set(rec["memory_analysis"]) == {
        "argument_bytes", "output_bytes", "temp_bytes", "peak_bytes",
        "alias_bytes"}
    assert rec["chips"] == 256
    assert {c.split()[0] for c in rec["collective_schedule_head"]} == \
        {"all-reduce", "all-gather"}
    assert roofline.load_records("*__t.json")[0] == rec

    # the sweep: one cell that traces and one that fails, exit code 1
    monkeypatch.setattr(dryrun, "list_archs", lambda: ["llama3.2-1b"])
    monkeypatch.setattr(dryrun, "arch_shapes",
                        lambda arch: {"decode_32k": None, "nope": None})
    assert dryrun.main(["--all", "--tag", "sweep"]) == 1
    assert os.path.exists(tmp_path / "llama3.2-1b__decode_32k__pod__sweep"
                                     ".json")
