"""The port's SSM families against the JAX reference on the CPU: the Mamba-1
and Mamba-2 blocks (sequence form, prefill with final state, and one decode
step), the causal convolution, the ``falcon-mamba-smoke`` and
``zamba2-smoke`` logits from imported parameters, parameter counts and
trees, and the loader's dtypes (the SSM parameters stay fp32 in a bf16
model).

Tolerance: fp32 outputs agree to atol 1e-4 / rtol 1e-4 (both packages
accumulate in fp32, in different orders); the smoke models' logits, which
run through several blocks and a tied head whose logits reach ~1e2, to
atol 2e-4 / rtol 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.falcon_mamba_7b import CONFIG as J_FALCON
from repro.configs.falcon_mamba_7b import SMOKE as J_FALCON_SMOKE
from repro.configs.zamba2_2p7b import CONFIG as J_ZAMBA
from repro.configs.zamba2_2p7b import SMOKE as J_ZAMBA_SMOKE
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.models.model import build_model as jbuild
from repro.models.model import count_params_analytic as jcount
from repro_torch.configs import falcon_mamba_7b as tfalcon
from repro_torch.configs import registry as tregistry
from repro_torch.configs import zamba2_2p7b as tzamba
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttransformer
from repro_torch.models.interop import params_from_jax
from repro_torch.models.model import build_model as tbuild
from repro_torch.models.model import count_params_analytic as tcount
from repro_torch.utils.config import ModelConfig

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
LOGIT_TOL = dict(atol=2e-4, rtol=1e-4)
SMOKES = {"falcon-mamba-smoke": J_FALCON_SMOKE, "zamba2-smoke": J_ZAMBA_SMOKE,
          # zamba2-2.7b's own super-block: 5 x mamba2 + mamba2_shared_attn
          "zamba2-smoke-period6": J_ZAMBA_SMOKE.replace(
              name="zamba2-smoke-period6", num_layers=6,
              hybrid_attn_period=6)}


def port_cfg(jcfg):
    return ModelConfig.from_dict(jcfg.to_dict())


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def tree_T(tree):
    return jax.tree.map(lambda x: T(x), tree)


def hidden(seed, b, s, d):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(
        np.float32)


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tmod,jcfg,jsmoke", [
    (tfalcon, J_FALCON, J_FALCON_SMOKE), (tzamba, J_ZAMBA, J_ZAMBA_SMOKE)])
def test_ssm_configs_equal_reference(tmod, jcfg, jsmoke):
    assert tmod.CONFIG.to_dict() == jcfg.to_dict()
    assert tmod.SMOKE.to_dict() == jsmoke.to_dict()
    assert tregistry.get_model_config(jcfg.name) is tmod.CONFIG
    assert tregistry.get_smoke_config(jcfg.name) is tmod.SMOKE
    assert ttransformer.block_pattern(tmod.CONFIG) == \
        jtransformer.block_pattern(jcfg)


@pytest.mark.parametrize("jcfg", [J_FALCON, J_ZAMBA, J_FALCON_SMOKE,
                                  J_ZAMBA_SMOKE], ids=lambda c: c.name)
def test_ssm_param_count_matches_reference(jcfg):
    assert tcount(port_cfg(jcfg)) == jcount(jcfg)


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

def test_causal_conv_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 6)).astype(np.float32)
    w, b = rng.normal(size=(4, 6)).astype(np.float32), rng.normal(
        size=(6,)).astype(np.float32)
    np.testing.assert_allclose(
        N(tssm._causal_conv_seq(T(x), T(w), T(b))),
        np.array(jssm._causal_conv_seq(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b))), **TOL)
    st = rng.normal(size=(2, 3, 6)).astype(np.float32)
    ns, y = tssm._causal_conv_step(T(st), T(x[:, 0]), T(w), T(b))
    jns, jy = jssm._causal_conv_step(jnp.asarray(st), jnp.asarray(x[:, 0]),
                                     jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(N(ns), np.array(jns), **TOL)
    np.testing.assert_allclose(N(y), np.array(jy), **TOL)


@pytest.mark.parametrize("kind", ["mamba1", "mamba2"])
def test_mamba_block_seq_prefill_and_step_match_reference(kind):
    jcfg = J_FALCON_SMOKE if kind == "mamba1" else J_ZAMBA_SMOKE
    cfg = port_cfg(jcfg)
    jinit = getattr(jssm, f"init_{kind}")
    japply = getattr(jssm, f"apply_{kind}")
    tapply = getattr(tssm, f"apply_{kind}")
    jp = jinit(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = tree_T(jp)
    x = hidden(4, 2, 20, cfg.d_model)
    # sequence form (training)
    ref, _ = japply(jp, jcfg, jnp.asarray(x))
    out, st = tapply(tp, cfg, T(x))
    assert st is None
    np.testing.assert_allclose(N(out), np.array(ref), **TOL)
    # prefill with final state, then one decode step from it
    jref, jst = japply(jp, jcfg, jnp.asarray(x), return_state=True)
    out, st = tapply(tp, cfg, T(x), return_state=True)
    np.testing.assert_allclose(N(out), np.array(jref), **TOL)
    for a, b in zip(st, jst):
        np.testing.assert_allclose(N(a), np.array(b), **TOL)
    x1 = hidden(5, 2, 1, cfg.d_model)
    jy, jst2 = japply(jp, jcfg, jnp.asarray(x1), state=jst, decode=True)
    y, st2 = tapply(tp, cfg, T(x1), state=st, decode=True)
    np.testing.assert_allclose(N(y), np.array(jy), **TOL)
    for a, b in zip(st2, jst2):
        np.testing.assert_allclose(N(a), np.array(b), **TOL)
    # the fresh decode state has the reference's shapes and dtypes
    jfresh = getattr(jssm, f"init_{kind}_state")(jcfg, 3, jnp.bfloat16)
    fresh = getattr(tssm, f"init_{kind}_state")(cfg, 3, torch.bfloat16,
                                                torch.device("cpu"))
    for a, b in zip(fresh, jfresh):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[1] == str(b.dtype)


# --------------------------------------------------------------------------
# models
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference(jcfg):
    m = jbuild(jcfg)
    return jax.jit(m.forward), m.init(jax.random.PRNGKey(0))


@pytest.mark.parametrize("name", list(SMOKES))
def test_ssm_smoke_logits_match_reference(name):
    jcfg = SMOKES[name]
    jfwd, jp = _reference(jcfg)
    cfg = port_cfg(jcfg)
    tm = tbuild(cfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.array, jp), cfg, device="cpu")
    if cfg.family == "hybrid":
        assert set(tp["shared_attn"]) == {"norm", "attn", "mlp_norm", "mlp"}
        assert len(tp["blocks"]) == cfg.hybrid_attn_period
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 37)).astype(np.int32)
    ref, _, _ = jfwd(jp, jnp.asarray(toks))
    out, _, _ = tm.forward(tp, T(toks))
    np.testing.assert_allclose(N(out), np.array(ref), **LOGIT_TOL)


@pytest.mark.parametrize("name", list(SMOKES))
def test_params_from_jax_keeps_fp32_ssm_leaves_in_a_bf16_model(name):
    """The loader gives each leaf its template's dtype: the SSM parameters
    the reference keeps in fp32 (A_log, dt_bias, D) are not rounded to
    the model's bf16."""
    jcfg = SMOKES[name].replace(dtype="bfloat16")
    jp = jbuild(jcfg).init(jax.random.PRNGKey(1))
    cfg = port_cfg(jcfg)
    tp = params_from_jax(jax.tree.map(np.array, jp), cfg, device="cpu")
    mixer, jmixer = tp["blocks"]["sub0"]["mixer"], jp["blocks"]["sub0"]["mixer"]
    for leaf in ("A_log", "dt_bias", "D"):
        assert jmixer[leaf].dtype == jnp.float32
        assert mixer[leaf].dtype == torch.float32
        np.testing.assert_array_equal(N(mixer[leaf]), np.array(jmixer[leaf]))
    assert mixer["w_x"].dtype == torch.bfloat16
    # the port's own init keeps the same dtypes, leaf for leaf
    own = tbuild(cfg, device="cpu").init(0)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        node = own
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).split(".")[1] == str(leaf.dtype), path

