"""The port's dense GQA model against the JAX reference on the CPU.

The reference initialises its parameters; ``params_from_jax`` carries them
across, and both packages run the same tokens.  Covered here: the layers
(rope, the three MLPs, the bf16 embedding scale), parameter counts and
the loader, and logits of a plain forward on ``llama3.2-smoke``,
``default_replay_model()`` and the quickstart config.  The three
``apply_gqa`` cache branches are in ``test_torch_model_decode.py``, which
shares this file's helpers.

Tolerance: fp32 logits agree to atol 1e-4 / rtol 1e-4 (both packages
accumulate in fp32, in different orders); caches, which are written, not
computed, to 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.llama3p2_1b import SMOKE as J_LLAMA_SMOKE
from repro.envs.replay_env import default_replay_model
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.model import build_model as jbuild
from repro.models.model import count_params_analytic as jcount
from repro.utils.config import ModelConfig as JModelConfig
from repro.utils.config import ParallelConfig as JParallelConfig
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.interop import params_from_jax
from repro_torch.models.model import build_model as tbuild
from repro_torch.models.model import count_params_analytic as tcount
from repro_torch.utils.config import ModelConfig, ParallelConfig

# tiny shapes: one intra-op thread per test process, so parallel test
# workers do not oversubscribe the CPU under wall-clock-timed tests
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)

QUICKSTART = JModelConfig(name="quickstart-20m", num_layers=4, d_model=256,
                          num_heads=8, num_kv_heads=4, d_ff=1024,
                          vocab_size=512, dtype="float32")
CONFIGS = {"llama3.2-smoke": J_LLAMA_SMOKE,
           "replay-tiny": default_replay_model(),
           "quickstart": QUICKSTART}


def port_cfg(jcfg):
    return ModelConfig.from_dict(jcfg.to_dict())


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


class _JaxModel:
    """The reference model with a jit-compiled forward (one compile per
    shape, instead of a retrace per eager call)."""

    def __init__(self, jcfg):
        self.m = jbuild(jcfg)
        self.forward = jax.jit(self.m.forward, static_argnames=("decode",))
        self.init_decode_state = self.m.init_decode_state
        self.init_paged_decode_state = self.m.init_paged_decode_state


@functools.lru_cache(maxsize=None)
def _reference(jcfg):
    jm = _JaxModel(jcfg)
    return jm, jm.m.init(jax.random.PRNGKey(0))


def both(jcfg):
    """(jax model, jax params, port model, port params) with one init."""
    jm, jp = _reference(jcfg)
    cfg = port_cfg(jcfg)
    tm = tbuild(cfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.array, jp), cfg, device="cpu")
    return jm, jp, tm, tp


def tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def cache_to_port(jcache, cls):
    return cls(*(T(np.array(x)) for x in jcache))


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("positions", ["seq", "per_slot"])
def test_rope_matches_reference(positions):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = (np.arange(5, dtype=np.int32) if positions == "seq"
           else np.asarray([[7], [130]], np.int32))
    if positions == "per_slot":
        x = x[:, :1]
    ref = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)
    out = tlayers.apply_rope(T(x), T(pos), 500000.0)
    np.testing.assert_allclose(N(out), np.array(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mlp_type", ["swiglu", "relu2", "gelu"])
def test_mlp_matches_reference(mlp_type):
    p = jlayers.init_mlp(jax.random.PRNGKey(0), 32, 64, mlp_type, jnp.float32)
    x = np.random.default_rng(1).normal(size=(2, 3, 32)).astype(np.float32)
    ref = jlayers.apply_mlp(p, jnp.asarray(x), mlp_type)
    out = tlayers.apply_mlp({k: T(v) for k, v in p.items()}, T(x), mlp_type)
    np.testing.assert_allclose(N(out), np.array(ref), **TOL)


def test_bf16_embedding_scale_rounds_like_reference():
    # in bf16 sqrt(2048) is 45.25, not 45.2548...: the products must agree
    # bit for bit
    emb = np.random.default_rng(2).normal(size=(16, 2048)).astype(np.float32)
    toks = np.asarray([[0, 3, 15]], np.int32)
    ref = jlayers.embed_tokens({"embedding": jnp.asarray(emb, jnp.bfloat16)},
                               jnp.asarray(toks), 2048)
    out = tlayers.embed_tokens({"embedding": T(emb).bfloat16()}, T(toks),
                               2048)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(N(out.float()),
                                  np.array(ref.astype(jnp.float32)))


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS) + ["llama3.2-1b"])
def test_param_count_matches_reference(name):
    if name == "llama3.2-1b":
        from repro.configs.llama3p2_1b import CONFIG as jcfg
    else:
        jcfg = CONFIGS[name]
    assert tcount(port_cfg(jcfg)) == jcount(jcfg)
    assert port_cfg(jcfg).param_count() == jcount(jcfg)


def test_params_from_jax_checks_structure_and_shapes():
    _, jp = _reference(default_replay_model())
    tree = jax.tree.map(np.array, jp)
    cfg = port_cfg(default_replay_model())
    del tree["final_norm"]
    with pytest.raises(ValueError, match="tree mismatch"):
        params_from_jax(tree, cfg, device="cpu")
    tree = jax.tree.map(np.array, jp)
    tree["embed"]["embedding"] = tree["embed"]["embedding"][:3]
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tree, cfg, device="cpu")


def test_port_init_draws_reference_shapes_from_a_seed():
    cfg = port_cfg(default_replay_model())
    m = tbuild(cfg, device="cpu")
    a, b = m.init(3), m.init(3)
    _, jtree = _reference(default_replay_model())
    flat_j = jax.tree_util.tree_leaves_with_path(jtree)
    for path, leaf in flat_j:
        node_a, node_b = a, b
        for k in path:
            node_a, node_b = node_a[k.key], node_b[k.key]
        assert tuple(node_a.shape) == leaf.shape
        assert torch.equal(node_a, node_b)
    assert float(a["embed"]["embedding"].abs().max()) <= 2.0  # truncated


# --------------------------------------------------------------------------
# logits: forward, and the three apply_gqa branches
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_logits_match_reference(name):
    jm, jp, tm, tp = both(CONFIGS[name])
    toks = tokens(tm.cfg, 2, 11)
    ref, _, _ = jm.forward(jp, jnp.asarray(toks))
    out, _, _ = tm.forward(tp, T(toks))
    np.testing.assert_allclose(N(out), np.array(ref), **TOL)
