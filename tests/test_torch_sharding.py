"""The sharding layer of the port against the JAX reference, on the CPU.

- ``configs/shapes.py`` and the registry's cells: ``SHAPES``,
  ``SMOKE_SHAPES``, ``runnable_cells`` (33), ``all_cells`` (40),
  ``make_run``, and ``input_specs`` (``meta`` tensors) with the reference's
  tree paths, shapes and dtypes in every runnable cell;
- ``sharding/specs.py``: the port's specs equal the reference's
  ``PartitionSpec`` leaf by leaf — all ten archs at their full configs, the
  (16, 16) and (2, 16, 16) production meshes (the reference's functions
  run over a ``jax.sharding.AbstractMesh``, no devices), each arch's
  ``default_parallel`` for train and decode and the ``fsdp=2``, ``tp=1``
  and ``moe_expert_axis="data"`` variants, over params, train state, serve
  state and batch; ``to_placements``; ``activation_sharding``;
- ``launch/mesh.py``: the mesh description, ``make_mesh`` without a
  process group, ``local_shard``;
- ``launch/build.py``: ``build_step`` in every runnable cell on the
  (16, 16) mesh — abstract arguments equal to the reference's
  (``jax.eval_shape``), placements equal to the reference's specs,
  ``donate_argnums`` and ``kind``;
- ``runtime/elastic.py``: ``adjust_run_for_devices`` on the reference's
  cases, and ``remesh_state``: the four ranks' blocks of a checkpoint on a
  (2, 2) mesh with ``fsdp=2, tp=2`` put back together equal it bit for
  bit; a (1,) mesh gives the whole state.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as JR
from repro.configs import shapes as jshapes
from repro.launch.build import build_step as jbuild_step
from repro.models.model import build_model as jbuild_model
from repro.runtime.elastic import adjust_run_for_devices as jadjust
from repro.sharding import specs as JS
from repro.train.optimizer import make_optimizer as jmake_optimizer
from repro.train.train_step import init_train_state as jinit_train_state
from repro.utils import config as jconfig
from repro_torch import runtime
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry as TR
from repro_torch.configs import shapes as tshapes
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.build import StepBundle, build_step
from repro_torch.models.model import build_model
from repro_torch.runtime.elastic import adjust_run_for_devices, remesh_state
from repro_torch.sharding import specs as TS
from repro_torch.sharding.specs import P, to_placements
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import (init_train_state,
                                          train_state_template)
from repro_torch.utils import config as tconfig
from repro_torch.utils.trees import flatten_with_paths

torch.set_num_threads(1)

MESHES = {"16x16": ((16, 16), ("data", "model"), False),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"), True)}
VARIANTS = ("train", "decode", "fsdp2", "tp1", "expert_data")


def _jflat(tree):
    """The reference tree's leaves by path, specs and shardings as
    leaves."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (JP, NamedSharding)))
    return {"/".join(JS._key_str(p) for p in path): leaf
            for path, leaf in leaves}


def _abstract(leaf):
    dt = leaf.dtype
    return (tuple(leaf.shape),
            str(dt).replace("torch.", "") if isinstance(dt, torch.dtype)
            else np.dtype(dt).name)


def _same_abstract(port_tree, ref_tree):
    a = {k: _abstract(v) for k, v in flatten_with_paths(port_tree).items()
         if not isinstance(v, int)}
    b = {k: _abstract(v) for k, v in _jflat(ref_tree).items()
         if hasattr(v, "shape") and k != "step"}
    assert a == b


def _specs_equal(port_specs, ref_specs):
    a = {k: tuple(v) for k, v in flatten_with_paths(port_specs).items()}
    b = {k: tuple(v) for k, v in _jflat(ref_specs).items()}
    assert a == b
    return len(a)


def _placements_by_path(tree, n_axes):
    """Placement tuples by leaf path (a tuple flattens into its
    entries)."""
    out = {}
    for k, v in flatten_with_paths(tree).items():
        head, _, i = k.rpartition("/")
        out.setdefault(head, []).append((int(i), v))
    assert all(len(v) == n_axes for v in out.values())
    return {k: tuple(p for _, p in sorted(v)) for k, v in out.items()}


def _placements_equal(port_tree, ref_shardings, axes):
    ref = {k: to_placements(P(*tuple(v.spec)), axes)
           for k, v in _jflat(ref_shardings).items()}
    got = _placements_by_path(port_tree, len(axes))
    assert got == ref


# --------------------------------------------------------------------------
# shapes and cells
# --------------------------------------------------------------------------

def test_shapes_and_cells_match_reference():
    for j, t in ((jshapes.SHAPES, tshapes.SHAPES),
                 (jshapes.SMOKE_SHAPES, tshapes.SMOKE_SHAPES)):
        assert {k: dataclasses.asdict(v) for k, v in j.items()} == \
            {k: dataclasses.asdict(v) for k, v in t.items()}
    for sub in (False, True):
        assert list(tshapes.shape_runs_for(sub)) == \
            list(jshapes.shape_runs_for(sub))
    assert TR.runnable_cells() == JR.runnable_cells()
    assert len(TR.runnable_cells()) == 33
    assert TR.all_cells() == JR.all_cells() and len(TR.all_cells()) == 40
    for arch in TR.list_archs():
        assert list(TR.arch_shapes(arch)) == list(JR.arch_shapes(arch))
        assert dataclasses.asdict(TR.default_train_config(arch)) == \
            dataclasses.asdict(JR.default_train_config(arch))


@pytest.mark.parametrize("multi_pod,smoke", [(False, False), (True, False),
                                             (False, True)])
def test_make_run_matches_reference(multi_pod, smoke):
    shapes = jshapes.SMOKE_SHAPES if smoke else jshapes.SHAPES
    for arch in TR.list_archs():
        for shape in shapes:
            if shape == "long_500k" and \
                    not JR.get_model_config(arch).sub_quadratic:
                with pytest.raises(ValueError, match="documented skip"):
                    TR.make_run(arch, shape, multi_pod=multi_pod)
                continue
            t = TR.make_run(arch, shape, multi_pod=multi_pod, smoke=smoke)
            j = JR.make_run(arch, shape, multi_pod=multi_pod, smoke=smoke)
            assert t.to_json() == j.to_json(), (arch, shape)
    with pytest.raises(KeyError, match="unknown shape"):
        TR.make_run("llama3.2-1b", "train_1k")


def test_input_specs_match_reference_in_every_runnable_cell():
    for arch, shape in JR.runnable_cells():
        got = TR.input_specs(TR.make_run(arch, shape))
        assert all(v.device.type == "meta"
                   for v in flatten_with_paths(got).values())
        _same_abstract(got, JR.input_specs(JR.make_run(arch, shape)))


# --------------------------------------------------------------------------
# placement rules
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jparams(arch):
    cfg = JR.get_model_config(arch)
    par = JR.default_parallel(arch, "train")
    return jax.eval_shape(
        lambda: jbuild_model(cfg, par).init(jax.random.PRNGKey(0)))


def _parallel(mod, arch, variant):
    if variant in ("train", "decode"):
        return mod.default_parallel(arch, variant)
    base = mod.default_parallel(arch, "train")
    return base.replace(**{"fsdp2": dict(fsdp=2), "tp1": dict(tp=1),
                           "expert_data": dict(moe_expert_axis="data")}
                        [variant])


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", JR.list_archs())
def test_specs_match_reference(arch, mesh_name):
    shape, axes, multi_pod = MESHES[mesh_name]
    jmesh = AbstractMesh(shape, axes)
    tm = tmesh.MeshSpec.of(shape, axes)
    if not multi_pod:
        assert tm == tmesh.make_production_mesh()
    else:
        assert tm == tmesh.make_production_mesh(multi_pod=True)
    jcfg, tcfg = JR.get_model_config(arch), TR.get_model_config(arch)
    tparams = build_model(tcfg, device="meta").init(0)
    sharded = 0
    for variant in VARIANTS:
        jpar = _parallel(JR, arch, variant)
        tpar = _parallel(TR, arch, variant)
        assert jpar == jconfig.ParallelConfig(**dataclasses.asdict(tpar))
        # params
        _specs_equal(TS.param_specs(tparams, tcfg, tpar, tm),
                     JS.param_specs(_jparams(arch), jcfg, jpar, jmesh))
        # train state (adafactor's factored slots for the large archs)
        jrun = JR.make_run(arch, "train_4k", multi_pod=multi_pod,
                           parallel=jpar)
        trun = TR.make_run(arch, "train_4k", multi_pod=multi_pod,
                           parallel=tpar)
        jopt = jmake_optimizer(jrun.train)
        jstate = jax.eval_shape(lambda: jinit_train_state(
            jbuild_model(jcfg, jpar), jrun, jopt, jax.random.PRNGKey(0)))
        tstate = train_state_template(build_model(tcfg, tpar, device="meta"),
                                      trun, make_optimizer(trun.train))
        tspecs = TS.train_state_specs(tstate, tcfg, tpar, tm)
        _specs_equal(tspecs,
                     JS.train_state_specs(jstate, jcfg, jpar, jmesh))
        sharded += sum(any(e is not None for e in s)
                       for s in flatten_with_paths(tspecs).values())
        # serve state
        jdec = JR.make_run(arch, "decode_32k", multi_pod=multi_pod,
                           parallel=jpar)
        tdec = TR.make_run(arch, "decode_32k", multi_pod=multi_pod,
                           parallel=tpar)
        _specs_equal(
            TS.serve_state_specs(TR.input_specs(tdec)["state"], tcfg, tpar,
                                 tm),
            JS.serve_state_specs(JR.input_specs(jdec)["state"], jcfg, jpar,
                                 jmesh))
        # batch
        _specs_equal(TS.batch_specs(TR.input_specs(trun)["batch"], tm),
                     JS.batch_specs(JR.input_specs(jrun)["batch"], jmesh))
    assert sharded > 0


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    axes = ("pod", "data", "model")
    assert to_placements(P(("pod", "data"), None, "model"), axes) == \
        (Shard(0), Shard(0), Shard(2))
    assert to_placements(P(None, "data"), axes) == \
        (Replicate(), Shard(1), Replicate())
    assert to_placements(P(), ("data",)) == (Replicate(),)
    # a one-axis tuple is its axis, as in jax
    assert P(("data",), None) == P("data", None)
    with pytest.raises(ValueError, match="order"):
        to_placements(P(("data", "pod")), axes)
    with pytest.raises(ValueError, match="not in the mesh"):
        to_placements(P("model"), ("data",))


def test_activation_sharding_passes_only_what_data_parallelism_is():
    """The data axes and the model axis hold (B, S, D) activations as the
    constraint asks: whole without ``sp``; under ``sp`` each rank holds its
    sequence block where the model axis divides S, the whole stream where
    it does not (or where the axis is 1); any other axis raises."""
    h = torch.zeros(4, 8, 16)
    par = tconfig.ParallelConfig()
    for mesh in (tmesh.MeshSpec.of((1,), ("data",)),
                 tmesh.MeshSpec.of((2,), ("data",)),
                 tmesh.MeshSpec.of((2, 4, 1), ("pod", "data", "model")),
                 tmesh.make_production_mesh(),
                 tmesh.MeshSpec.of((4,), ("model",))):
        assert TS.activation_sharding(h, par, mesh) is h
    with pytest.raises(NotImplementedError, match="'pod', 'data'"):
        TS.activation_sharding(h, par,
                               tmesh.MeshSpec.of((2, 2), ("data", "seq")))
    sp = par.replace(sp=True)
    assert TS.activation_sharding(
        h, sp, tmesh.MeshSpec.of((2, 1), ("data", "model"))) is h
    mesh = tmesh.MeshSpec.of((2, 2), ("data", "model"))
    block = h[:, :4]
    assert TS.activation_sharding(block, sp, mesh, 8) is block
    with pytest.raises(ValueError, match="4 of 8 tokens"):
        TS.activation_sharding(h, sp, mesh, 8)
    odd = torch.zeros(4, 7, 16)
    assert TS.activation_sharding(odd, sp, mesh) is odd
    assert TS.activation_sharding(odd, sp, mesh, 7) is odd


def test_the_train_forward_holds_its_activations_to_the_mesh():
    """The guards run on the executing path: a train step on a mesh
    description with an axis above 1 raises (it has no process group to
    reduce over), for the vlm and audio families too; on the one-device
    mesh it steps as without one, under ``sp`` as well."""
    from repro_torch.data.pipeline import make_data
    from repro_torch.launch.train import make_run
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    cfg = TR.get_smoke_config("llama3.2-1b").replace(dtype="float32")
    run = make_run(cfg, seq=16, batch=2, steps=1)
    model = build_model(cfg, run.parallel, device="cpu")
    opt = make_optimizer(run.train)
    batch = make_data(cfg, run.shape, seed=0).batch_at(0)
    losses = []
    for mesh in (None, tmesh.MeshSpec.of((1,), ("data",))):
        state = init_train_state(model, run, opt, seed=0)
        step = make_train_step(model, run, opt, mesh=mesh)
        losses.append(float(step(state, batch)[1]["loss"]))
    assert losses[0] == losses[1]
    step = make_train_step(model, run, opt,
                           mesh=tmesh.MeshSpec.of((1, 2), ("data", "model")))
    with pytest.raises(RuntimeError, match="no process group"):
        step(init_train_state(model, run, opt, seed=0), batch)
    sp = run.replace(parallel=run.parallel.replace(sp=True))
    step = make_train_step(build_model(cfg, sp.parallel, device="cpu"), sp,
                           opt, mesh=tmesh.MeshSpec.of((1,), ("data",)))
    assert float(step(init_train_state(model, sp, opt, seed=0),
                      batch)[1]["loss"]) == losses[0]
    for arch in ("llama-3.2-vision-11b", "whisper-large-v3"):
        cfg = TR.get_smoke_config(arch).replace(dtype="float32")
        arun = make_run(cfg, seq=16, batch=2, steps=1)
        amodel = build_model(cfg, arun.parallel, device="cpu")
        step = make_train_step(amodel, arun, opt, mesh=tmesh.MeshSpec.of(
            (1, 2), ("data", "model")))
        with pytest.raises(RuntimeError, match="no process group"):
            step(init_train_state(amodel, arun, opt, seed=0),
                 make_data(cfg, arun.shape, seed=0).batch_at(0))


# --------------------------------------------------------------------------
# mesh
# --------------------------------------------------------------------------

def test_mesh_description_and_make_mesh_without_a_process_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    m = tmesh.make_production_mesh(multi_pod=True)
    assert m.axis_names == ("pod", "data", "model")
    assert dict(m.shape) == {"pod": 2, "data": 16, "model": 16}
    assert m.groups is None
    one = tmesh.make_mesh(tconfig.MeshConfig((1,), ("data",)))
    assert one == tmesh.MeshSpec.of((1,), ("data",))
    assert one.groups is None and one.data_group() is None
    with pytest.raises(RuntimeError, match="no process group"):
        m.data_group()
    with pytest.raises(RuntimeError, match="no process group"):
        m.model_group()
    with pytest.raises(RuntimeError, match="needs 2 devices"):
        tmesh.make_mesh(tconfig.MeshConfig((2,), ("data",)))
    assert tmesh.coords_of(5, tmesh.MeshSpec.of((2, 4), ("data", "model"))) \
        == {"data": 1, "model": 1}


def test_local_shard_is_the_row_major_block():
    mesh = tmesh.MeshSpec.of((2, 2, 2), ("pod", "data", "model"))
    x = torch.arange(8 * 6).reshape(8, 6)
    spec = P(("pod", "data"), "model")
    blocks = {}
    for rank in range(8):
        c = tmesh.coords_of(rank, mesh)
        b = tmesh.local_shard(x, spec, mesh, c)
        assert b.shape == (2, 3)
        blocks[(c["pod"] * 2 + c["data"], c["model"])] = b
    assert torch.equal(torch.cat([torch.cat([blocks[(i, j)]
                                             for j in range(2)], 1)
                                  for i in range(4)], 0), x)


# --------------------------------------------------------------------------
# build_step
# --------------------------------------------------------------------------

def test_build_step_matches_reference_in_every_runnable_cell():
    jmesh = AbstractMesh((16, 16), ("data", "model"))
    tm = tmesh.make_production_mesh()
    for arch, shape in JR.runnable_cells():
        ref = jbuild_step(JR.make_run(arch, shape), jmesh)
        got = build_step(TR.make_run(arch, shape), tm)
        assert isinstance(got, StepBundle)
        assert (got.kind, got.donate_argnums) == \
            (ref.kind, ref.donate_argnums), (arch, shape)
        assert len(got.abstract_args) == len(ref.abstract_args)
        for a, b in zip(got.abstract_args, ref.abstract_args):
            _same_abstract(a, b)
        for a, b in zip(got.in_shardings, ref.in_shardings):
            _placements_equal(a, b, tm.axis_names)
        for a, b in zip(got.out_shardings, ref.out_shardings):
            _placements_equal(a, b, tm.axis_names)


# --------------------------------------------------------------------------
# elastic
# --------------------------------------------------------------------------

def _tiny(mod):
    return mod.ModelConfig(vocab_size=64, d_model=32, num_heads=4,
                           num_kv_heads=2, d_ff=64, num_layers=2,
                           dtype="float32")


@pytest.mark.parametrize("mesh,par,shape,n", [
    (((16, 16), ("data", "model")), dict(tp=16, microbatch=1), (32, 48), 128),
    (((4, 1), ("data", "model")), dict(tp=1, microbatch=1), (32, 32), 8),
    (((4, 1), ("data", "model")), dict(tp=1, microbatch=1), (32, 32), 3),
    (((1,), ("data",)), dict(), (32, 8), 2),
    (((8,), ("data",)), dict(tp=4, microbatch=2), (16, 24), 6),
])
def test_adjust_run_for_devices_matches_reference(mesh, par, shape, n):
    runs = []
    for mod in (jconfig, tconfig):
        runs.append(mod.RunConfig(
            model=_tiny(mod), shape=mod.ShapeConfig("t", *shape, "train"),
            mesh=mod.MeshConfig(*mesh), parallel=mod.ParallelConfig(**par)))
    jrun, trun = runs
    try:
        want = jadjust(jrun, n)
    except ValueError as e:
        with pytest.raises(ValueError, match="global_batch"):
            adjust_run_for_devices(trun, n)
        assert "global_batch" in str(e)
        return
    assert adjust_run_for_devices(trun, n).to_json() == want.to_json()


def test_remesh_state_blocks_put_back_together_equal_the_checkpoint(
        tmp_path):
    assert runtime.remesh_state is remesh_state
    cfg = _tiny(tconfig)
    run = tconfig.RunConfig(
        model=cfg, shape=tconfig.ShapeConfig("t", 16, 4, "train"),
        mesh=tconfig.MeshConfig((2, 2), ("data", "model")),
        parallel=tconfig.ParallelConfig(fsdp=2, tp=2),
        train=tconfig.TrainConfig(optimizer="adafactor"))
    model = build_model(cfg, run.parallel, device="cpu")
    opt = make_optimizer(run.train)
    state = init_train_state(model, run, opt, seed=3)
    ckpt = CheckpointManager(str(tmp_path), keep=1)
    ckpt.save(7, state, blocking=True)
    template = train_state_template(model, run, opt)
    mesh = tmesh.MeshSpec.of((2, 2), ("data", "model"))
    specs = flatten_with_paths(TS.train_state_specs(template, cfg,
                                                    run.parallel, mesh))
    whole = flatten_with_paths(state)
    rebuilt = {k: torch.full_like(v, float("nan"))
               for k, v in whole.items() if not isinstance(v, int)}
    n_split = 0
    for rank in range(4):
        local = flatten_with_paths(remesh_state(ckpt, 7, template, run,
                                                mesh, rank=rank,
                                                device="cpu"))
        assert local.keys() == whole.keys()
        coords = tmesh.coords_of(rank, mesh)
        for k, v in local.items():
            if isinstance(v, int):
                assert v == whole[k] == 0
                continue
            dst = tmesh.local_shard(rebuilt[k], specs[k], mesh, coords)
            assert dst.shape == v.shape and v.is_contiguous()
            n_split += v.numel() < whole[k].numel()
            dst.copy_(v)
    assert n_split > 0
    for k, v in rebuilt.items():
        assert torch.equal(v, whole[k]), k
    # a one-device mesh: the whole state
    one = tmesh.MeshSpec.of((1,), ("data",))
    full = flatten_with_paths(remesh_state(
        ckpt, 7, template, run.replace(mesh=tconfig.MeshConfig((1,),
                                                               ("data",))),
        one, device="cpu"))
    assert all(torch.equal(full[k], whole[k]) if not isinstance(v, int)
               else full[k] == v for k, v in whole.items())
