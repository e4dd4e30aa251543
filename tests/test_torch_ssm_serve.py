"""The port's SSM families served on the CPU against the JAX reference, at
the smoke configs (``falcon-mamba-smoke``: Mamba-1; ``zamba2-smoke``:
Mamba-2 with the shared attention block), parameters imported from the
reference:

- the decode-state trees of ``init_decode_state`` and
  ``init_paged_decode_state``: the same keys, shapes and dtypes;
- the reference's serving consistency check (``tests/test_serve.py``):
  prefill and decode logits against the full forward at tol 2e-3, and
  against the reference's own prefill / decode logits;
- the continuous batcher at temperature 0 (dense, paged, paged with
  chunked prefill; slot churn and EOS): the reference's tokens,
  completion order and counters, exactly;
- the serve CLI's prompts and tokens for both archs, and its trace replay
  (``--workload``) through the batcher.

Tolerance: the logits agree with the reference's to atol 2e-4 / rtol 1e-4
(fp32 in both packages, sums in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.falcon_mamba_7b import SMOKE as J_FALCON_SMOKE
from repro.configs.zamba2_2p7b import SMOKE as J_ZAMBA_SMOKE
from repro.models.model import build_model as jbuild
from repro.serving.paging import PagedPlan as JPagedPlan
from repro.serving.scheduler import ContinuousBatcher as JBatcher
from repro.serving.scheduler import Request as JRequest
from repro.train.serve_step import generate as jgenerate
from repro.train.serve_step import make_decode_step as jmake_decode
from repro.train.serve_step import make_prefill_step as jmake_prefill
from repro.utils.config import RunConfig as JRunConfig
from repro.utils.config import ShapeConfig as JShapeConfig
from repro_torch.models.interop import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.serving.paging import PagedPlan
from repro_torch.serving.scheduler import ContinuousBatcher, Request
from repro_torch.train.serve_step import make_decode_step, make_prefill_step
from repro_torch.utils.config import ModelConfig, RunConfig, ShapeConfig

torch.set_num_threads(1)

SMOKES = {"ssm": J_FALCON_SMOKE, "hybrid": J_ZAMBA_SMOKE}
ARCHS = {"ssm": "falcon-mamba-7b", "hybrid": "zamba2-2.7b"}
CONSISTENCY_TOL = 2e-3
LOGIT_TOL = dict(atol=2e-4, rtol=1e-4)


def _served(family):
    jcfg = SMOKES[family]
    jrun = JRunConfig(model=jcfg, shape=JShapeConfig("s", 64, 4, "decode"))
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    run = RunConfig(model=cfg, shape=ShapeConfig("s", 64, 4, "decode"))
    tm = build_model(cfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.array, jp), cfg, device="cpu")
    return (jm, jrun, jp), (tm, run, tp)


# one module fixture per family: loadfile puts this file on one worker
@pytest.fixture(scope="module")
def ssm_served():
    return _served("ssm")


@pytest.fixture(scope="module")
def hybrid_served():
    return _served("hybrid")


@pytest.fixture
def served(request, ssm_served, hybrid_served):
    return {"ssm": ssm_served, "hybrid": hybrid_served}[request.param]


FAMILIES = pytest.mark.parametrize("served", list(SMOKES), indirect=True)


def _leaves(tree, prefix=""):
    """{path: (shape, dtype name)} of a decode-state tree of either
    package (dicts and named tuples)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, tuple):
        out = {}
        for name, v in zip(tree._fields, tree):
            out.update(_leaves(v, f"{prefix}.{name}"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


# --------------------------------------------------------------------------
# decode-state trees
# --------------------------------------------------------------------------

@FAMILIES
@pytest.mark.parametrize("paged", [False, True])
def test_decode_state_tree_matches_reference(served, paged):
    (jm, _, _), (tm, _, _) = served
    if paged:
        ref = jm.init_paged_decode_state(3, 6, 4, 5)
        out = tm.init_paged_decode_state(3, 6, 4, 5)
    else:
        ref = jm.init_decode_state(3, 20)
        out = tm.init_decode_state(3, 20)
    assert _leaves(out) == _leaves(ref)
    kinds = {type(v).__name__ if not isinstance(v, dict) else
             tuple(sorted(v)) for v in out.values()}
    if tm.cfg.family == "ssm":
        assert kinds == {"MambaState"}
    else:
        assert kinds == {("mixer",), ("mixer", "shared_kv")}
    # the SSM state is fp32, the conv state in the model dtype
    for path, (_, dtype) in _leaves(out).items():
        if path.endswith(".ssm"):
            assert dtype == "float32"


# --------------------------------------------------------------------------
# prefill / decode against the full forward and the reference
# --------------------------------------------------------------------------

@FAMILIES
def test_prefill_and_decode_logits_match_full_forward_and_reference(served):
    (jm, jrun, jp), (tm, run, tp) = served
    b, s, steps = 2, 8, 4
    toks = np.random.default_rng(1).integers(
        0, tm.cfg.vocab_size, (b, s + steps)).astype(np.int32)
    full, _, _ = tm.forward(tp, torch.as_tensor(toks))
    prefill = make_prefill_step(tm, run, cache_len=s + steps)
    decode = make_decode_step(tm, run)
    jprefill = jmake_prefill(jm, jrun, cache_len=s + steps)
    jdecode = jmake_decode(jm, jrun)
    state, logits = prefill(tp, {"tokens": torch.as_tensor(toks[:, :s])})
    jstate, jlogits = jprefill(jp, {"tokens": jnp.asarray(toks[:, :s])})
    errs = [float((logits - full[:, s - 1]).abs().max())]
    np.testing.assert_allclose(logits.numpy(), np.array(jlogits),
                               **LOGIT_TOL)
    for i in range(steps):
        tok = toks[:, s + i][:, None]
        state, logits = decode(tp, state, torch.as_tensor(tok))
        jstate, jlogits = jdecode(jp, jstate, jnp.asarray(tok))
        np.testing.assert_allclose(logits.numpy(), np.array(jlogits),
                                   **LOGIT_TOL)
        if i < steps - 1:
            errs.append(float((logits - full[:, s + i]).abs().max()))
    assert max(errs) < CONSISTENCY_TOL, errs
    # the recurrent state after the steps is the reference's
    for (path, ref), out in zip(
            jax.tree_util.tree_leaves_with_path(jstate.caches),
            jax.tree_util.tree_leaves(state.caches,
                                      is_leaf=torch.is_tensor)):
        np.testing.assert_allclose(out.numpy(), np.array(ref), atol=1e-4,
                                   rtol=1e-4, err_msg=str(path))


@FAMILIES
def test_decode_updates_the_stacked_state_in_place(served):
    """The step writes the new recurrent states into the tensors it was
    given (the batcher keeps them and scatters into them)."""
    _, (tm, run, tp) = served
    prefill = make_prefill_step(tm, run, cache_len=12)
    decode = make_decode_step(tm, run)
    state, logits = prefill(tp, {"tokens": torch.arange(6)[None] % 7})
    before = {id(t): t.clone() for t in jax.tree_util.tree_leaves(
        state.caches, is_leaf=torch.is_tensor)}
    new, _ = decode(tp, state, logits.argmax(-1, keepdim=True).int())
    for path, (old, now) in zip(
            _leaves(state.caches), zip(
                jax.tree_util.tree_leaves(state.caches,
                                          is_leaf=torch.is_tensor),
                jax.tree_util.tree_leaves(new.caches,
                                          is_leaf=torch.is_tensor))):
        if path.endswith(".ssm") or path.endswith(".conv"):
            assert now is old, path
            assert not torch.equal(now, before[id(old)]), path


# --------------------------------------------------------------------------
# the continuous batcher
# --------------------------------------------------------------------------

GEOMETRIES = {
    "dense": None,
    "paged": dict(pool_pages=8, page_size=4, pages_per_slot_max=8),
    "paged_chunked": dict(pool_pages=8, page_size=4, pages_per_slot_max=8,
                          prefill_chunk=2),
}


def _run_both(served, geometry, *, n_requests=4, max_new=5, num_slots=2,
              eos_token=None, lengths=(5, 3, 7, 4)):
    (jm, jrun, jp), (tm, run, tp) = served
    g = GEOMETRIES[geometry]
    jb = JBatcher(jm, jrun, jp, num_slots=num_slots, cache_len=32,
                  eos_token=eos_token,
                  paged=None if g is None else JPagedPlan(paging=True, **g))
    tb = ContinuousBatcher(
        tm, run, tp, num_slots=num_slots, cache_len=32, eos_token=eos_token,
        paged=None if g is None else PagedPlan(paging=True, **g))
    rng = np.random.default_rng(2)
    for i in range(n_requests):
        p = rng.integers(0, tm.cfg.vocab_size,
                         lengths[i % len(lengths)]).astype(np.int32)
        jb.submit(JRequest(uid=i, prompt=p, max_new_tokens=max_new + i % 2))
        tb.submit(Request(uid=i, prompt=p, max_new_tokens=max_new + i % 2))
    jdone = [(d.request.uid, list(d.generated))
             for d in jb.run_until_drained()]
    tdone = [(d.request.uid, list(d.generated))
             for d in tb.run_until_drained()]
    assert tdone == jdone  # tokens AND completion order
    assert (tb.ticks, tb.prefill_chunks, tb.mean_occupancy) == \
        (jb.ticks, jb.prefill_chunks, jb.mean_occupancy)
    if g is not None:
        assert sorted(tb._free_pages) == list(range(g["pool_pages"]))
    return tdone


@FAMILIES
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_batcher_matches_reference(served, geometry):
    _run_both(served, geometry)


@FAMILIES
@pytest.mark.parametrize("geometry", ["dense", "paged"])
def test_slot_churn_with_eos_matches_reference(served, geometry):
    (jm, jrun, jp), _ = served
    first = np.random.default_rng(2).integers(
        0, jm.cfg.vocab_size, 5).astype(np.int32)
    eos = int(np.array(jgenerate(jm, jrun, jp,
                                 {"tokens": jnp.asarray(first)[None]},
                                 num_steps=2))[0, 1])
    _run_both(served, geometry, n_requests=5, max_new=6, eos_token=eos)


@FAMILIES
def test_batcher_geometries_give_the_same_tokens(served):
    runs = {g: dict(_run_both(served, g)) for g in GEOMETRIES}
    for g, tokens in runs.items():
        assert tokens == runs["dense"], g


# --------------------------------------------------------------------------
# the serve CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(SMOKES))
def test_serve_cli_on_cpu_matches_reference_prompts_and_tokens(family,
                                                               capsys):
    from repro.data.pipeline import make_data as jmake_data
    from repro_torch.launch import serve

    arch, jcfg = ARCHS[family], SMOKES[family]
    assert serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert f"[serve] {jcfg.name}" in out and "decode p50" in out
    shape = ShapeConfig("serve_cli", 12, 2, "decode")
    jshape = JShapeConfig("serve_cli", 12, 2, "decode")
    prompt = serve.make_batch(serve.get_smoke_config(arch), shape, 2, 8,
                              "cpu")["tokens"]
    ref = jmake_data(jcfg, jshape, seed=0).batch_at(0)["inputs"][:2, :8]
    np.testing.assert_array_equal(prompt.numpy(), ref)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    tm = build_model(cfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.array, jp), cfg, device="cpu")
    res = serve.serve_fixed_batch(tm, RunConfig(model=cfg, shape=shape), tp,
                                  prompt, gen=4)
    want = np.array(jgenerate(jm, JRunConfig(model=jcfg, shape=jshape), jp,
                              {"tokens": jnp.asarray(ref)}, num_steps=4))
    np.testing.assert_array_equal(res.tokens, want)


@pytest.mark.parametrize("family", list(SMOKES))
def test_serve_cli_replays_a_workload_through_the_ssm_batcher(family,
                                                              capsys):
    from repro_torch.launch import serve

    assert serve.main([
        "--arch", ARCHS[family], "--device", "cpu", "--workload",
        "poisson:rate=2000,horizon=0.005,mean_prompt=5,mean_output=3,"
        "max_len=12"]) == 0
    assert "12 completed (0 rejected)" in capsys.readouterr().out
