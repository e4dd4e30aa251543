"""The port's audio encoder-decoder (whisper-large-v3, ``models/encdec.py``)
against the JAX reference on the CPU, at the ``whisper-smoke`` config (2 +
2 layers, d_model 64, ``encoder_seq`` 16), parameters carried from the
reference by ``params_from_jax``.

Held: the config, the decode-state tree and the absent paged state;
``encode`` (rope, non-causal attention over the frames); ``decode_forward``
over the reference's encoder output; prefill + 4 decode steps (logits,
caches, ``enc_out``) against the reference's steps; the port's own steps
against its cacheless forward; greedy ``generate``; the full config's
parameter count; a bf16 smoke model with the fp32 frames the serve CLI
passes (the whole encoder in fp32, as jax promotes), and the dtypes of
its attention and norm operands; the serve CLI on ``--device cpu``.

Tolerances (``tests/test_torch_vlm.py``'s): fp32 1e-4 + 1e-4|x|; bf16
2e-2 + 2e-2|x| (for bf16 logits |x| is the row's largest |logit|, see
``_close_bf16_logits``); tokens exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import whisper_large_v3 as jwhisper
from repro.models import encdec as jencdec
from repro.models.model import build_model as jbuild
from repro.models.model import count_params_analytic as jcount
from repro.train.serve_step import generate as jgenerate
from repro.train.serve_step import make_decode_step as jmake_decode
from repro.train.serve_step import make_prefill_step as jmake_prefill
from repro.utils.config import ParallelConfig as JParallelConfig
from repro.utils.config import RunConfig as JRunConfig
from repro.utils.config import ShapeConfig as JShapeConfig
from repro_torch.configs import whisper_large_v3 as twhisper
from repro_torch.models import encdec as tencdec
from repro_torch.models.interop import params_from_jax
from repro_torch.models.model import build_model as tbuild
from repro_torch.models.model import count_params_analytic as tcount
from repro_torch.train.serve_step import generate as tgenerate
from repro_torch.train.serve_step import make_decode_step, make_prefill_step
from repro_torch.utils.config import ModelConfig, ParallelConfig, RunConfig
from repro_torch.utils.config import ShapeConfig
from test_torch_vlm import _close, _close_bf16_logits, _spied_attention

torch.set_num_threads(1)

B, S, STEPS, CACHE_LEN = 2, 6, 4, 12


def _served(dtype="float32"):
    jcfg = jwhisper.SMOKE.replace(dtype=dtype)
    jm = jbuild(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
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
    frames = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    return toks, frames


def test_config_and_decode_state_match_reference(served):
    (jm, _, _), (tm, _, _) = served
    for which in ("CONFIG", "SMOKE"):
        assert getattr(twhisper, which).to_dict() == \
            getattr(jwhisper, which).to_dict()
    tst, jst = tm.init_decode_state(3, 20), jm.init_decode_state(3, 20)
    assert type(tst).__name__ == type(jst).__name__ == "KVCache"
    for name, t, j in zip(tst._fields, tst, jst):
        assert tuple(t.shape) == tuple(j.shape), name
        assert str(t.dtype).split(".")[-1] == str(j.dtype), name
    # no paged serving path for the audio family, as in the reference
    assert tm.init_paged_decode_state is None
    assert jm.init_paged_decode_state is None


def test_encode_matches_reference(served):
    (_, _, jp), (tm, run, tp) = served
    _, frames = _inputs(tm.cfg)
    want = jencdec.encode(jp, jwhisper.SMOKE, JParallelConfig(),
                          jnp.asarray(frames))
    got = tencdec.encode(tp, tm.cfg, ParallelConfig(),
                         torch.as_tensor(frames))
    assert got.shape == (B, tm.cfg.encoder_seq, tm.cfg.d_model)
    _close(got, want)


def test_decode_forward_matches_reference(served):
    """The decoder alone, cacheless, over the reference's encoder output."""
    (_, _, jp), (tm, _, tp) = served
    toks, frames = _inputs(tm.cfg, seed=3)
    enc = jencdec.encode(jp, jwhisper.SMOKE, JParallelConfig(),
                         jnp.asarray(frames))
    want, _ = jencdec.decode_forward(jp, jwhisper.SMOKE, JParallelConfig(),
                                     jnp.asarray(toks), enc)
    got, state = tencdec.decode_forward(tp, tm.cfg, ParallelConfig(),
                                        torch.as_tensor(toks),
                                        torch.as_tensor(np.array(enc)))
    assert state is None
    _close(got, want)
    # the model's forward: encode, then the decoder
    fwd, _, aux = tm.forward(tp, torch.as_tensor(toks),
                             frames=torch.as_tensor(frames))
    _close(fwd, want)
    assert float(aux) == 0.0


def _steps_both(served):
    """Prefill + STEPS teacher-forced decode steps in both packages: the
    logits of each, step by step, and the final states."""
    (jm, jrun, jp), (tm, run, tp) = served
    toks, frames = _inputs(tm.cfg)
    jpre = jax.jit(jmake_prefill(jm, jrun, cache_len=CACHE_LEN))
    jdec = jax.jit(jmake_decode(jm, jrun))
    tpre = make_prefill_step(tm, run, cache_len=CACHE_LEN)
    tdec = make_decode_step(tm, run)
    jst, jl = jpre(jp, {"tokens": jnp.asarray(toks[:, :S]),
                        "frames": jnp.asarray(frames)})
    tst, tl = tpre(tp, {"tokens": torch.as_tensor(toks[:, :S]),
                        "frames": torch.as_tensor(frames)})
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
    assert set(tst.extras) == set(jst.extras) == {"enc_out"}
    _close(tst.extras["enc_out"], jst.extras["enc_out"])
    for name, t, j in zip(tst.caches._fields, tst.caches, jst.caches):
        if t.dtype == torch.int32:
            np.testing.assert_array_equal(t.numpy(), np.array(j), name)
        else:
            _close(t, j)
    np.testing.assert_array_equal(tst.lengths.numpy(),
                                  np.array(jst.lengths))


def test_serving_steps_agree_with_the_cacheless_forward(served):
    _, (tm, run, tp) = served
    toks, frames = _inputs(tm.cfg, seed=5)
    full, _, _ = tm.forward(tp, torch.as_tensor(toks),
                            frames=torch.as_tensor(frames))
    state, lg = make_prefill_step(tm, run, cache_len=CACHE_LEN)(
        tp, {"tokens": torch.as_tensor(toks[:, :S]),
             "frames": torch.as_tensor(frames)})
    decode = make_decode_step(tm, run)
    _close(lg, full[:, S - 1])
    for i in range(STEPS - 1):
        col = torch.as_tensor(toks[:, S + i:S + i + 1])
        state, lg = decode(tp, state, col)
        _close(lg, full[:, S + i])


def test_generate_tokens_match_reference(served):
    (jm, jrun, jp), (tm, run, tp) = served
    toks, frames = _inputs(tm.cfg, seed=7)
    want = jgenerate(jm, jrun, jp, {"tokens": jnp.asarray(toks[:, :S]),
                                    "frames": jnp.asarray(frames)},
                     num_steps=STEPS + 2)
    got = tgenerate(tm, run, tp, {"tokens": torch.as_tensor(toks[:, :S]),
                                  "frames": torch.as_tensor(frames)},
                    num_steps=STEPS + 2)
    np.testing.assert_array_equal(got.numpy(), np.array(want))


def test_full_config_parameter_count_matches_reference():
    assert tcount(twhisper.CONFIG) == jcount(jwhisper.CONFIG) == \
        1_536_240_640


def test_bf16_model_with_fp32_frames_matches_reference():
    """The serve CLI's inputs: a bf16 model and fp32 frames, so the encoder
    runs in fp32 from ``frame_proj`` on and the decoder's cross K/V are
    fp32 against a bf16 query — prefill and decode logits, and the fp32
    encoder output kept for decode, at the fp32 tolerance (a bf16 cast of
    the frames would be off by about 2^-8 relative)."""
    logits, tst, jst = _steps_both(_served("bfloat16"))
    assert tst.extras["enc_out"].dtype == torch.float32
    assert str(jst.extras["enc_out"].dtype) == "float32"
    _close(tst.extras["enc_out"], jst.extras["enc_out"])
    for tl, jl in logits:
        assert tl.dtype == torch.bfloat16
        _close_bf16_logits(tl, jl)


def test_fp32_frames_run_the_encoder_and_the_cross_kv_in_fp32(
        monkeypatch):
    """The promotion path pinned by dtype (the bf16 logits' tolerance
    cannot tell fp32 from a bf16 cast): a bf16 model's prefill and one
    decode step with the CLI's fp32 frames.  The encoder's attention has
    fp32 q, k and v, and its norms fp32 rows; the decoder's
    self-attention is bf16 and its cross-attention a bf16 query over fp32
    K/V."""
    from repro_torch.kernels import ops

    calls = _spied_attention(monkeypatch)
    norms, real_norm = [], ops.rmsnorm

    def norm_spy(x, w, **kw):
        norms.append(x.dtype)
        return real_norm(x, w, **kw)
    monkeypatch.setattr(ops, "rmsnorm", norm_spy)
    cfg = twhisper.SMOKE.replace(dtype="bfloat16")
    tm = tbuild(cfg, device="cpu")
    tp = tm.init(0)
    run = RunConfig(model=cfg, shape=ShapeConfig("s", CACHE_LEN, B,
                                                 "decode"))
    toks, frames = _inputs(cfg)
    state, _ = make_prefill_step(tm, run, cache_len=CACHE_LEN)(
        tp, {"tokens": torch.as_tensor(toks[:, :S]),
             "frames": torch.as_tensor(frames)})
    n_prefill = len(calls)
    make_decode_step(tm, run)(tp, state, torch.as_tensor(toks[:, S:S + 1]))
    bf, f32 = torch.bfloat16, torch.float32
    n_enc = cfg.encoder_layers or cfg.num_layers
    n_dec = cfg.num_layers
    cross = (False, bf, f32, f32)
    assert calls[:n_prefill] == [(False, f32, f32, f32)] * n_enc + [
        (True, bf, bf, bf), cross] * n_dec
    assert calls[n_prefill:] == [cross] * n_dec
    # the encoder's two norms a layer and ``enc_norm``, then the decoder's
    assert norms[:2 * n_enc + 1] == [f32] * (2 * n_enc + 1)
    assert set(norms[2 * n_enc + 1:]) == {bf}


def test_serve_cli_serves_the_audio_arch_on_cpu(capsys):
    from repro_torch.launch.serve import main

    assert main(["--arch", "whisper-large-v3", "--device", "cpu",
                 "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert "whisper-smoke" in out and "decode p50" in out
