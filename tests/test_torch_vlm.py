"""The port's vlm family (llama-3.2-vision-11b: dense layers with a gated
cross-attention image layer every ``cross_attn_period``-th) against the
JAX reference on the CPU, at the ``llama-vision-smoke`` config (2 layers,
d_model 64, ``vision_seq`` 8), parameters carried from the reference by
``params_from_jax``.  The reference initialises every ``cross_gate`` to 0,
which makes each cross sublayer a no-op (``tanh(0) = 0``), so the carried
gates are set to seeded non-zero values first and the forward test checks
that they move the logits.

Held: the block pattern and decode-state trees (dense and paged);
``apply_cross_attn`` alone, fp32 and a bf16 query over fp32 keys (the
promotion path); ``forward`` with ``vision_embeds``; prefill + 4 decode
steps (logits and caches) against the reference's steps; the port's own
steps against its cacheless forward; greedy ``generate``; the full
config's parameter count; a bf16 smoke model with the fp32 vision
embeddings the serve CLI passes, and the dtypes of its attention
operands (fp32 K/V in every cross-attention); the serve CLI on
``--device cpu``.

Tolerances: fp32 1e-4 + 1e-4|x|; bf16 2e-2 + 2e-2|x| (for bf16 logits |x|
is the row's largest |logit|, see ``_close_bf16_logits``); tokens exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama3p2_vision_11b as jvision
from repro.models import attention as jattn
from repro.models import transformer as jtransformer
from repro.models.model import build_model as jbuild
from repro.models.model import count_params_analytic as jcount
from repro.train.serve_step import generate as jgenerate
from repro.train.serve_step import make_decode_step as jmake_decode
from repro.train.serve_step import make_prefill_step as jmake_prefill
from repro.utils.config import ParallelConfig as JParallelConfig
from repro.utils.config import RunConfig as JRunConfig
from repro.utils.config import ShapeConfig as JShapeConfig
from repro_torch.configs import llama3p2_vision_11b as tvision
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttransformer
from repro_torch.models.interop import params_from_jax
from repro_torch.models.model import build_model as tbuild
from repro_torch.models.model import count_params_analytic as tcount
from repro_torch.train.serve_step import generate as tgenerate
from repro_torch.train.serve_step import make_decode_step, make_prefill_step
from repro_torch.utils.config import ModelConfig, ParallelConfig, RunConfig
from repro_torch.utils.config import ShapeConfig
from repro_torch.utils.trees import tree_map

torch.set_num_threads(1)

TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
B, S, STEPS, CACHE_LEN = 2, 6, 4, 12


def _close(got, want, dtype="float32"):
    np.testing.assert_allclose(
        torch.as_tensor(got).float().numpy(),
        np.array(want).astype(np.float32), **TOL[dtype])


def _close_bf16_logits(got, want):
    """bf16 logits, with |x| the row's largest |logit|: a logit is the
    final hidden state against one embedding row, so one bf16 rounding of
    that state moves every logit of the row by a share of the row's scale
    (0.125 at |logit| 56-64 in these smoke models, with bf16 or fp32
    inputs alike)."""
    a = torch.as_tensor(got).float().numpy()
    b = np.array(want).astype(np.float32)
    tol = TOL["bfloat16"]
    scale = np.abs(b).max(-1, keepdims=True)
    bad = np.abs(a - b) > tol["atol"] + tol["rtol"] * scale
    assert not bad.any(), (f"{int(bad.sum())} logits off, max |diff| "
                           f"{np.abs(a - b).max()} at row scale "
                           f"{scale.max()}")


def _gates(n):
    """Seeded non-zero gates of either sign, |g| in [0.5, 1.5]."""
    rng = np.random.default_rng(11)
    return rng.uniform(0.5, 1.5, n) * rng.choice([-1.0, 1.0], n)


def _served(dtype="float32"):
    jcfg = jvision.SMOKE.replace(dtype=dtype)
    jm = jbuild(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    cross = f"sub{len(jtransformer.block_pattern(jcfg)) - 1}"
    gate = jp["blocks"][cross]["cross_gate"]
    jp["blocks"][cross]["cross_gate"] = jnp.asarray(_gates(gate.shape[0]),
                                                    gate.dtype)
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    tm = tbuild(cfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.array, jp), cfg, device="cpu")
    jrun = JRunConfig(model=jcfg, shape=JShapeConfig("s", CACHE_LEN, B,
                                                     "decode"))
    run = RunConfig(model=cfg, shape=ShapeConfig("s", CACHE_LEN, B,
                                                 "decode"))
    return (jm, jrun, jp), (tm, run, tp)


@pytest.fixture(scope="module")
def served():
    return _served()


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    ve = rng.standard_normal((B, cfg.vision_seq, cfg.vision_dim)).astype(
        np.float32)
    return toks, ve


def _leaves(tree, prefix=""):
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


def test_config_pattern_and_decode_states_match_reference(served):
    (jm, _, _), (tm, _, _) = served
    for which in ("CONFIG", "SMOKE"):
        jcfg, tcfg = getattr(jvision, which), getattr(tvision, which)
        assert tcfg.to_dict() == jcfg.to_dict()
        assert ttransformer.block_pattern(tcfg) == \
            jtransformer.block_pattern(jcfg)
    assert ttransformer.block_pattern(tvision.CONFIG) == ["dense"] * 4 + \
        ["cross"]
    assert _leaves(tm.init_decode_state(3, 20)) == \
        _leaves(jm.init_decode_state(3, 20))
    assert _leaves(tm.init_paged_decode_state(3, 6, 4, 5)) == \
        _leaves(jm.init_paged_decode_state(3, 6, 4, 5))


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_apply_cross_attn_matches_reference(x_dtype):
    """fp32 throughout, and a bf16 model's query over fp32 keys and values
    (the stub frontend's inputs): K/V promote to fp32 as jnp.einsum does,
    the output takes the query's dtype."""
    jcfg = jvision.SMOKE
    cfg = tvision.SMOKE
    jp = jattn.init_cross_attn(jax.random.PRNGKey(3), jcfg, jcfg.vision_dim,
                               jnp.dtype(x_dtype))
    tp = {k: torch.as_tensor(np.array(v).astype(np.float32)).to(
        getattr(torch, x_dtype)) for k, v in jp.items()}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    kv = rng.standard_normal((B, cfg.vision_seq, cfg.vision_dim)).astype(
        np.float32)
    jx = jnp.asarray(x).astype(x_dtype)
    want = jattn.apply_cross_attn(jp, jcfg, JParallelConfig(), jx,
                                  jnp.asarray(kv))
    got = tattn.apply_cross_attn(tp, cfg, ParallelConfig(),
                                 torch.as_tensor(x).to(getattr(torch,
                                                               x_dtype)),
                                 torch.as_tensor(kv))
    assert str(got.dtype).split(".")[-1] == str(want.dtype) == x_dtype
    _close(got, want, x_dtype)


def test_forward_with_vision_embeds_matches_reference(served):
    (jm, _, jp), (tm, _, tp) = served
    toks, ve = _inputs(tm.cfg)
    want, _, _ = jm.forward(jp, jnp.asarray(toks),
                            vision_embeds=jnp.asarray(ve))
    got, _, aux = tm.forward(tp, torch.as_tensor(toks),
                             vision_embeds=torch.as_tensor(ve))
    _close(got, want)
    assert float(aux) == 0.0
    # the gates are open: closing them moves the logits
    shut = tree_map(torch.clone, tp)
    for sub in shut["blocks"].values():
        if "cross_gate" in sub:
            sub["cross_gate"].zero_()
    closed, _, _ = tm.forward(shut, torch.as_tensor(toks),
                              vision_embeds=torch.as_tensor(ve))
    assert float((closed - got).abs().max()) > 1e-2


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, tuple):
        out = {}
        for name, v in zip(tree._fields, tree):
            out.update(_flat(v, f"{prefix}.{name}"))
        return out
    return {prefix: tree}


def _steps_both(served):
    """Prefill + STEPS teacher-forced decode steps in both packages (fp32
    vision embeddings): the logits of each, step by step, and the final
    states."""
    (jm, jrun, jp), (tm, run, tp) = served
    toks, ve = _inputs(tm.cfg)
    jpre = jax.jit(jmake_prefill(jm, jrun, cache_len=CACHE_LEN))
    jdec = jax.jit(jmake_decode(jm, jrun))
    tpre = make_prefill_step(tm, run, cache_len=CACHE_LEN)
    tdec = make_decode_step(tm, run)
    jst, jl = jpre(jp, {"tokens": jnp.asarray(toks[:, :S]),
                        "vision_embeds": jnp.asarray(ve)})
    tst, tl = tpre(tp, {"tokens": torch.as_tensor(toks[:, :S]),
                        "vision_embeds": torch.as_tensor(ve)})
    logits = [(tl, jl)]
    for i in range(STEPS):
        col = toks[:, S + i:S + i + 1]
        jst, jl = jdec(jp, jst, jnp.asarray(col))
        tst, tl = tdec(tp, tst, torch.as_tensor(col))
        logits.append((tl, jl))
    return logits, tst, jst


def test_prefill_and_decode_match_reference(served):
    logits, tst, jst = _steps_both(served)
    for tl, jl in logits:
        _close(tl, jl)
    assert set(tst.extras) == set(jst.extras) == {"vision_embeds"}
    jflat = _flat(jst.caches)
    for path, leaf in _flat(tst.caches).items():
        if leaf.dtype == torch.int32:
            np.testing.assert_array_equal(leaf.numpy(),
                                          np.array(jflat[path]))
        else:
            _close(leaf, jflat[path])
    np.testing.assert_array_equal(tst.lengths.numpy(),
                                  np.array(jst.lengths))


def test_serving_steps_agree_with_the_cacheless_forward(served):
    _, (tm, run, tp) = served
    toks, ve = _inputs(tm.cfg, seed=5)
    full, _, _ = tm.forward(tp, torch.as_tensor(toks),
                            vision_embeds=torch.as_tensor(ve))
    state, lg = make_prefill_step(tm, run, cache_len=CACHE_LEN)(
        tp, {"tokens": torch.as_tensor(toks[:, :S]),
             "vision_embeds": torch.as_tensor(ve)})
    decode = make_decode_step(tm, run)
    _close(lg, full[:, S - 1])
    for i in range(STEPS - 1):
        col = torch.as_tensor(toks[:, S + i:S + i + 1])
        state, lg = decode(tp, state, col)
        _close(lg, full[:, S + i])


def test_generate_tokens_match_reference(served):
    (jm, jrun, jp), (tm, run, tp) = served
    toks, ve = _inputs(tm.cfg, seed=7)
    want = jgenerate(jm, jrun, jp, {"tokens": jnp.asarray(toks[:, :S]),
                                    "vision_embeds": jnp.asarray(ve)},
                     num_steps=STEPS + 2)
    got = tgenerate(tm, run, tp, {"tokens": torch.as_tensor(toks[:, :S]),
                                  "vision_embeds": torch.as_tensor(ve)},
                    num_steps=STEPS + 2)
    np.testing.assert_array_equal(got.numpy(), np.array(want))


def test_full_config_parameter_count_matches_reference():
    assert tcount(tvision.CONFIG) == jcount(jvision.CONFIG) == 10_110_734_344


def test_bf16_model_with_fp32_vision_embeds_matches_reference():
    """The serve CLI's inputs: a bf16 model, fp32 patch embeddings (cross
    K/V in fp32, mixed-dtype attention) — prefill and decode logits."""
    logits, tst, _ = _steps_both(_served("bfloat16"))
    assert tst.extras["vision_embeds"].dtype == torch.float32
    for tl, jl in logits:
        assert tl.dtype == torch.bfloat16
        _close_bf16_logits(tl, jl)


def _spied_attention(monkeypatch):
    """Every ``ops.flash_attention`` call from here on, as (causal, q, k,
    v dtypes); the op itself still runs."""
    from repro_torch.kernels import ops

    calls, real = [], ops.flash_attention

    def spy(q, k, v, **kw):
        calls.append((kw.get("causal", True), q.dtype, k.dtype, v.dtype))
        return real(q, k, v, **kw)
    monkeypatch.setattr(ops, "flash_attention", spy)
    return calls


def test_fp32_vision_embeds_give_the_cross_attention_fp32_kv(monkeypatch):
    """The promotion path pinned by dtype: the logits' bf16 tolerance
    cannot tell fp32 K/V from K/V cast to bf16 (about 2^-8 relative), so
    the operands are recorded.  A bf16 model's prefill and one decode step
    with the CLI's fp32 vision embeddings: every cross-attention call has
    a bf16 query over fp32 K/V (``jnp.einsum`` promotes), every
    self-attention call bf16 operands."""
    calls = _spied_attention(monkeypatch)
    cfg = tvision.SMOKE.replace(dtype="bfloat16")
    tm = tbuild(cfg, device="cpu")
    tp = tm.init(0)
    run = RunConfig(model=cfg, shape=ShapeConfig("s", CACHE_LEN, B,
                                                 "decode"))
    toks, ve = _inputs(cfg)
    state, _ = make_prefill_step(tm, run, cache_len=CACHE_LEN)(
        tp, {"tokens": torch.as_tensor(toks[:, :S]),
             "vision_embeds": torch.as_tensor(ve)})
    n_prefill = len(calls)
    make_decode_step(tm, run)(tp, state, torch.as_tensor(toks[:, S:S + 1]))
    bf, f32 = torch.bfloat16, torch.float32
    n_cross = ttransformer.block_pattern(cfg).count("cross")
    cross = (False, bf, f32, f32)
    assert calls[:n_prefill].count(cross) == n_cross > 0
    assert calls[:n_prefill].count((True, bf, bf, bf)) == n_prefill - n_cross
    assert calls[n_prefill:] == [cross] * n_cross  # decode: cross only


def test_serve_cli_serves_the_vision_arch_on_cpu(capsys):
    from repro_torch.launch.serve import main

    assert main(["--arch", "llama-3.2-vision-11b", "--device", "cpu",
                 "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert "llama-vision-smoke" in out and "decode p50" in out
