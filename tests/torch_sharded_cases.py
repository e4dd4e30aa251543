"""Sharded train and serve steps of the port against one process, on the
CPU: the machinery the tensor-parallel, FSDP / EP, sequence-parallel and
sharded-serve test files share.

A case is ``(id, arch, global batch, seq, ParallelConfig kwargs, mesh,
optimizer)`` (``arch`` a name, or ``(name, config overrides)``);
``mesh`` is ``(shape, axes)`` or None for the mesh
``launch.train.data_parallel`` gives (``("data", "model")`` keeping
``tp``).  :func:`spawn` runs every case of a list on ``world`` gloo ranks
(``torch.multiprocessing.spawn``, a ``FileStore``, no network), smoke
configs in fp32 (model and compute), :data:`STEPS` steps each through the
train CLI's loop; each rank records its metrics, the step-1 gradients
gathered whole (the train step's gradients after every reduction, before
clipping), the final parameters gathered whole, and the operand bytes by
kind its collectives sent in step 1 (``sharding.collectives``).
:func:`one_process` is the same loop in this process without a process
group.  :func:`hold` holds every rank against it, and each rank's counted
collective bytes against ``launch.build.lower_step``'s trace of the
rank's program for the same run and mesh.

A serve case is ``(id, arch, batch, prompt, ParallelConfig kwargs,
mesh)``: :func:`serve_loop` runs a prefill of ``prompt`` tokens and
:data:`SERVE_DECODE` greedy decode steps through ``make_prefill_step`` /
``make_decode_step`` (with the rank's mesh and its parameter blocks and
rows under a process group), recording the logits, the tokens and the
collective bytes of the prefill and of each decode step;
:func:`hold_serve` holds the ranks against one process and the bytes
against the traces of the prefill and decode cells.  The vlm family's
cross gates start open (:func:`open_gates`: the reference's zeros would
zero every cross weight's gradient).
:func:`reference_first_loss` and :func:`from_reference` hold a run's first
loss from the reference's parameters against the reference's own.
"""

import os

import numpy as np
import torch
import torch.multiprocessing as mp

from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import train as tlaunch
from repro_torch.utils.config import MeshConfig, ParallelConfig, TrainConfig
from repro_torch.utils.trees import flatten_with_paths

STEPS = 3
REF_LR = 1e-2  # the reference train test's run (tests/test_torch_train.py)
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5   # ||grad - one process's|| / ||one process's||, a leaf
PARAM_TOL = 1e-5   # atol and rtol


def make_run(arch, batch, seq, par, mesh=None, optimizer="adamw",
             ckpt_dir="unused", steps=STEPS):
    name, cuts = (arch, {}) if isinstance(arch, str) else arch
    cfg = get_smoke_config(name).replace(dtype="float32", **cuts)
    run = tlaunch.make_run(cfg, seq=seq, batch=batch, steps=steps,
                           checkpoint_dir=ckpt_dir,
                           parallel=ParallelConfig(**par))
    run = run.replace(train=TrainConfig(
        lr=1e-3, warmup_steps=10, total_steps=steps,
        compute_dtype="float32", optimizer=optimizer))
    if mesh is not None:
        run = run.replace(mesh=MeshConfig(*mesh))
    return run


def _whole(flat, layout):
    if layout is None or layout.mesh.groups is None:
        return {k: v.detach().clone() for k, v in flat.items()}
    return {k: layout.gather_whole(v, layout.specs[k]).clone()
            for k, v in flat.items()}


def open_gates(params):
    """Every ``cross_gate`` leaf of a parameter tree (torch or numpy)
    set, in place, to seeded values of either sign, |g| in [0.5, 1.5]."""
    for path, leaf in flatten_with_paths(params).items():
        if path.endswith("cross_gate"):
            rng = np.random.default_rng(11)
            n = int(np.prod(leaf.shape))
            gates = (rng.uniform(0.5, 1.5, n) * rng.choice([-1.0, 1.0], n)
                     ).reshape(leaf.shape)
            if isinstance(leaf, torch.Tensor):
                leaf.copy_(torch.as_tensor(gates, dtype=leaf.dtype))
            else:
                leaf[...] = gates.astype(leaf.dtype)
    return params


def loop(run, params=None):
    """The train CLI's loop (``launch.train``'s pieces): sharded over the
    process group when one is up.  Returns (run as placed, metrics a step,
    step-1 gradients, final parameters, step-1 collective bytes by
    kind), the trees whole and keyed by path."""
    import repro_torch.train.train_step as ts
    from repro_torch.data.pipeline import make_data
    from repro_torch.launch.train import gather_state
    from repro_torch.models.model import build_model
    from repro_torch.sharding import collectives
    from repro_torch.train.optimizer import make_optimizer

    model = build_model(run.model, run.parallel, device="cpu")
    if params is None and run.model.family == "vlm":
        params = open_gates(model.init(0))
    run, mesh = tlaunch.data_parallel(run, model.device)
    opt = make_optimizer(run.train)
    seen = {}
    clip = ts.clip_by_global_norm

    def spy(grads, max_norm, layout=None):
        if "grads" not in seen:  # gathered whole after step 1's counts
            seen["grads"] = ({k: v.detach().clone() for k, v in
                              flatten_with_paths(grads).items()}, layout)
        return clip(grads, max_norm, layout)

    ts.clip_by_global_norm = spy
    try:
        step = ts.make_train_step(model, run, opt, mesh=mesh)
        state = ts.init_train_state(model, run, opt, seed=0, params=params,
                                    mesh=mesh)
        data = tlaunch.rank_rows(make_data(run.model, run.shape, seed=0),
                                 mesh.data_group())
        logged, counted = [], {}
        for i in range(STEPS):
            collectives.reset_counts()
            state, metrics = step(state, data.batch_at(i))
            logged.append({k: float(v) for k, v in metrics.items()})
            if i == 0 and mesh.groups is not None:
                counted = collectives.bytes_by_kind()
            if i == 0:
                seen["grads"] = _whole(*seen["grads"])
    finally:
        ts.clip_by_global_norm = clip
    if mesh.groups is not None:
        state = gather_state(state, run, mesh)
    params = {k: v.detach().clone()
              for k, v in flatten_with_paths(state.params).items()}
    return run, logged, seen["grads"], params, counted


def _rank(rank, root, world, cases, extra):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(root, f"store{world}"), world), rank=rank,
        world_size=world)
    try:
        out = {}
        for cid, arch, b, s, par, mesh, optimizer in cases:
            out[cid] = loop(make_run(arch, b, s, par, mesh, optimizer))
        if extra is not None:
            out.update(extra(rank, root))
        torch.save(out, os.path.join(root, f"w{world}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(root, world, cases, extra=None):
    """Every case on ``world`` gloo ranks; ``extra(rank, root)`` (a
    module-level function) adds what it returns to a rank's record.  The
    records, one a rank."""
    mp.spawn(_rank, args=(root, world, cases, extra), nprocs=world,
             join=True)
    return [torch.load(os.path.join(root, f"w{world}_rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def one_process(case, params=None):
    """The case's loop in this process: its placements without a split
    (``tp`` and ``fsdp`` 1; an expert axis and gradient compression as
    they are)."""
    _, arch, b, s, par, _, optimizer = case
    return loop(make_run(arch, b, s, dict(par, tp=1, fsdp=1), None,
                         optimizer), params)


def close_params(got, want, tol=PARAM_TOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=tol, atol=tol, err_msg=k)


def hold(records, case, must_check=(), param_tol=PARAM_TOL):
    """Every rank of ``records`` against one process: metrics within
    :data:`LOSS_RTOL`, each leaf's step-1 gradient within
    :data:`GRAD_RTOL` (``must_check``: paths that must be among the
    leaves), final parameters within ``param_tol``; and the bytes its
    collectives sent in step 1 equal to the dry run's trace of rank 0's
    step for the same run and mesh (``launch.build.lower_step``)."""
    from repro_torch.launch.build import lower_step
    from repro_torch.launch.mesh import MeshSpec

    _, logged, grads, params, _ = one_process(case)
    names = sorted(logged[0])
    assert {"loss", "ce_loss", "accuracy", "grad_norm"} <= set(names)
    assert set(must_check) <= set(grads), sorted(set(must_check) - set(grads))
    run = records[0][case[0]][0]
    _, traced = lower_step(run, MeshSpec.of(run.mesh.shape, run.mesh.axes))
    recorded = {k: int(v) for k, v in
                traced.cost_analysis().collective_bytes.items()}
    for rec in records:
        _, got_logged, got_grads, got_params, counted = rec[case[0]]
        for k in names:
            want = [m[k] for m in logged]
            assert np.isfinite(want).all(), k
            np.testing.assert_allclose([m[k] for m in got_logged], want,
                                       rtol=LOSS_RTOL, atol=0, err_msg=k)
        assert set(got_grads) == set(grads)
        for k, g in grads.items():
            err = float((got_grads[k] - g).norm())
            assert err <= GRAD_RTOL * float(g.norm()) + 1e-12, (k, err)
        close_params(got_params, params, param_tol)
        assert counted == recorded, (counted, recorded)
        assert sum(counted.values()) > 0
    return records


# --------------------------------------------------------------------------
# sharded serving
# --------------------------------------------------------------------------

SERVE_DECODE = 3
LOGIT_TOL = 1e-5  # atol and rtol


def serve_run(arch, batch, prompt, par, mesh=None, kind="prefill"):
    """The prefill (``prompt`` tokens) or decode (a cache of ``prompt`` +
    :data:`SERVE_DECODE` rows) run of a serve case, smoke config in fp32;
    ``mesh`` as a train case's."""
    from repro_torch.utils.config import RunConfig, ShapeConfig

    name, cuts = (arch, {}) if isinstance(arch, str) else arch
    cfg = get_smoke_config(name).replace(dtype="float32", **cuts)
    seq = prompt if kind == "prefill" else prompt + SERVE_DECODE
    return RunConfig(model=cfg, shape=ShapeConfig(f"serve_{kind}", seq,
                                                  batch, kind),
                     mesh=MeshConfig(*mesh) if mesh is not None else
                     MeshConfig(shape=(1,), axes=("data",)),
                     parallel=ParallelConfig(**par),
                     train=TrainConfig(compute_dtype="float32"))


def serve_loop(case, sharded=True):
    """A serve case's prefill and greedy decode steps, sharded over the
    process group when one is up (else in this process, its placements
    without a split: ``tp`` and ``fsdp`` 1).  Returns (prefill run as
    placed, decode run as placed, {"logits": [(rows, V) a step], "tokens":
    [(rows,) a step], "rows": (first, stop), "bytes": [collective bytes
    by kind a step]})."""
    from repro_torch.launch.serve import make_batch
    from repro_torch.models.model import build_model
    from repro_torch.sharding import collectives
    from repro_torch.sharding.layout import shard_params
    from repro_torch.train.serve_step import (make_decode_step,
                                              make_prefill_step,
                                              sample_token)

    _, arch, b, s, par, mesh = case
    if not sharded:
        par, mesh = dict(par, tp=1, fsdp=1), None
    run = serve_run(arch, b, s, par, mesh)
    model = build_model(run.model, run.parallel, device="cpu")
    params = model.init(0)
    if run.model.family == "vlm":
        open_gates(params)
    run, placed = tlaunch.data_parallel(run, model.device)
    drun = run.replace(shape=serve_run(arch, b, s, par, mesh,
                                       "decode").shape)
    batch = make_batch(run.model, run.shape, b, s, "cpu")
    rows = (0, b)
    if placed.groups is not None:
        data = placed.groups["data"]
        if b % data.size == 0:
            n = b // data.size
            rows = (data.rank * n, (data.rank + 1) * n)
        batch = {k: v[rows[0]:rows[1]] for k, v in batch.items()}
        params = shard_params(params, run, placed, placed.rank)
    else:
        placed = None
    prefill = make_prefill_step(model, run, cache_len=drun.shape.seq_len,
                                mesh=placed)
    decode = make_decode_step(model, drun, mesh=placed)
    out = {"logits": [], "tokens": [], "rows": rows, "bytes": []}
    counting = placed is not None
    for i in range(1 + SERVE_DECODE):
        if counting:
            collectives.reset_counts()
        if i == 0:
            state, logits = prefill(params, batch)
        else:
            state, logits = decode(params, state, tok[:, None])
        tok = sample_token(logits, None)
        out["logits"].append(logits.clone())
        out["tokens"].append(tok.clone())
        out["bytes"].append(collectives.bytes_by_kind() if counting else {})
    return run, drun, out


def _serve_rank(rank, root, world, cases):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(root, f"serve{world}"), world), rank=rank,
        world_size=world)
    try:
        out = {case[0]: serve_loop(case) for case in cases}
        torch.save(out, os.path.join(root, f"serve{world}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_serve(root, world, cases):
    """Every serve case on ``world`` gloo ranks; the records, one a
    rank."""
    mp.spawn(_serve_rank, args=(root, world, cases), nprocs=world,
             join=True)
    return [torch.load(os.path.join(root, f"serve{world}_rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def hold_serve(records, case):
    """Every rank of ``records`` against one process: the logits of its
    rows at each step within :data:`LOGIT_TOL` (atol and rtol), the greedy
    tokens equal; and its collective bytes, of the prefill and of each
    decode step, equal to ``lower_step``'s trace of rank 0's prefill and
    decode steps for the same runs and mesh (rank 0's trace holds every
    rank: the ranks send the same bytes)."""
    from repro_torch.launch.build import lower_step
    from repro_torch.launch.mesh import MeshSpec

    _, _, one = serve_loop(case, sharded=False)
    run, drun, _ = records[0][case[0]]
    mesh = MeshSpec.of(run.mesh.shape, run.mesh.axes)
    want = []
    for r in (run, drun):
        _, traced = lower_step(r, mesh)
        want.append({k: int(v) for k, v in
                     traced.cost_analysis().collective_bytes.items()})
    for rec in records:
        _, _, got = rec[case[0]]
        lo, hi = got["rows"]
        for i, (lg, tk) in enumerate(zip(got["logits"], got["tokens"])):
            np.testing.assert_allclose(
                lg.numpy(), one["logits"][i][lo:hi].numpy(),
                rtol=LOGIT_TOL, atol=LOGIT_TOL, err_msg=f"step {i}")
            assert torch.equal(tk, one["tokens"][i][lo:hi]), i
        assert got["bytes"][0] == want[0], (got["bytes"][0], want[0])
        for i in range(1, 1 + SERVE_DECODE):
            assert got["bytes"][i] == want[1], (i, got["bytes"][i], want[1])
        assert sum(got["bytes"][0].values()) > 0
    return records


def reference_run(arch, **par):
    """The run the reference-parameter checks step: ``arch``'s smoke
    config in fp32, 4 x 24 tokens at the reference train test's learning
    rate, under ``ParallelConfig(**par)`` (placed by ``data_parallel``)."""
    from repro_torch.utils.config import RunConfig, ShapeConfig

    cfg = get_smoke_config(arch).replace(dtype="float32")
    return RunConfig(model=cfg, shape=ShapeConfig("train", 24, 4, "train"),
                     mesh=MeshConfig(shape=(1,), axes=("data",)),
                     parallel=ParallelConfig(**par),
                     train=TrainConfig(lr=REF_LR, warmup_steps=1,
                                       total_steps=10,
                                       compute_dtype="float32"))


def reference_first_loss(root, run, name):
    """The reference's one-device ``make_train_step`` on its own
    parameters (vlm gates opened; saved under ``root`` as ``name`` for
    :func:`from_reference`): the first step's loss on ``run``'s shape."""
    import jax
    import jax.numpy as jnp
    from repro.data.pipeline import make_data as jmake_data
    from repro.models.model import build_model as jbuild
    from repro.train import optimizer as joptim
    from repro.train.train_step import init_train_state as jinit_state
    from repro.train.train_step import make_train_step as jmake_step
    from repro.utils.config import RunConfig as JRun

    jrun = JRun.from_json(run.replace(
        parallel=ParallelConfig(),
        mesh=MeshConfig(shape=(1,), axes=("data",))).to_json())
    model = jbuild(jrun.model, jrun.parallel)
    opt = joptim.make_optimizer(jrun.train)
    state = jinit_state(model, jrun, opt, jax.random.PRNGKey(0))
    params = open_gates(jax.tree.map(np.array, state.params))
    torch.save(params, os.path.join(root, f"{name}_init.pt"))
    state = state._replace(params=jax.tree.map(jnp.asarray, params))
    batch = jmake_data(jrun.model, jrun.shape, seed=0).batch_at(0)
    _, m = jax.jit(jmake_step(model, jrun, opt))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(m["loss"])


def from_reference(rank, root, runs):
    """On a rank (``spawn``'s ``extra`` through ``functools.partial``):
    each ``(name, run)`` of ``runs`` stepped from the parameters
    :func:`reference_first_loss` saved; its first loss by name."""
    from repro_torch.models.interop import params_from_jax

    out = {}
    for name, run in runs:
        init = torch.load(os.path.join(root, f"{name}_init.pt"),
                          weights_only=False)
        params = params_from_jax(init, run.model, device="cpu")
        out[name] = loop(run, params)[1][0]["loss"]
    return out
