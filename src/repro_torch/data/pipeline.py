"""Deterministic, shard-aware, resumable synthetic LM data pipeline.

Design constraints for thousand-node training:

- **Stateless addressing** — ``batch_at(step)`` is a pure function of
  (seed, step, shard), so resume-after-failure needs no pipeline state in the
  checkpoint beyond the step counter, and every host can independently
  produce exactly its shard of the global batch (no data redistribution
  collective at the input layer).
- **Learnable structure** — tokens follow a fixed seeded Markov chain over
  the vocabulary, so end-to-end examples show genuinely decreasing loss
  (pure-uniform tokens would train to the entropy floor immediately and hide
  optimizer bugs).
- **Modality stubs** — per the task spec, vlm/audio frontends are stubbed:
  the pipeline emits deterministic patch/frame embeddings alongside tokens.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from repro_torch.utils.config import ModelConfig, ShapeConfig


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_shards: int = 1
    shard_id: int = 0
    # Markov-chain sharpness: higher -> more predictable tokens
    chain_concentration: float = 0.3
    branching: int = 8  # plausible next-tokens per state
    # modality stubs
    vision_seq: int = 0
    vision_dim: int = 0
    audio_seq: int = 0
    audio_dim: int = 0


class SyntheticLMData:
    """Markov-chain LM data. ``batch_at(step)`` returns this shard's slice."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.num_shards == 0, (
            cfg.global_batch, cfg.num_shards)
        self.cfg = cfg
        self.shard_batch = cfg.global_batch // cfg.num_shards
        # The chain itself must be identical on every shard: seed only by cfg.seed.
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 0xC0FFEE]))
        v, b = cfg.vocab_size, min(cfg.branching, cfg.vocab_size)
        self._succ = rng.integers(0, v, size=(v, b), dtype=np.int32)
        probs = rng.dirichlet(np.full(b, cfg.chain_concentration), size=v)
        self._cum = np.cumsum(probs, axis=1).astype(np.float32)

    def _rng_for(self, step: int) -> np.random.Generator:
        c = self.cfg
        return np.random.default_rng(
            np.random.SeedSequence([c.seed, step, c.shard_id]))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = self._rng_for(step)
        b, s, v = self.shard_batch, c.seq_len, c.vocab_size
        # vectorized Markov walk: one uniform per (b, t), inverse-CDF lookup
        u = rng.random((b, s + 1), dtype=np.float32)
        toks = np.empty((b, s + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, v, size=b)
        cum, succ = self._cum, self._succ
        for t in range(1, s + 1):
            prev = toks[:, t - 1]
            slot = (u[:, t, None] > cum[prev]).sum(axis=1)
            toks[:, t] = succ[prev, np.minimum(slot, succ.shape[1] - 1)]
        out = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
        if c.vision_seq:
            out["vision_embeds"] = rng.standard_normal(
                (b, c.vision_seq, c.vision_dim)).astype(np.float32)
        if c.audio_seq:
            out["frames"] = rng.standard_normal(
                (b, c.audio_seq, c.audio_dim)).astype(np.float32)
        return out

    # iterator sugar for the examples
    def iter_from(self, step: int):
        while True:
            yield self.batch_at(step)
            step += 1


def make_data(model_cfg: ModelConfig, shape: ShapeConfig, *, seed: int = 0,
              num_shards: int = 1, shard_id: int = 0) -> SyntheticLMData:
    kw = {}
    if model_cfg.family == "vlm":
        kw = dict(vision_seq=model_cfg.vision_seq or 16,
                  vision_dim=model_cfg.vision_dim or model_cfg.d_model)
    if model_cfg.family == "audio":
        kw = dict(audio_seq=model_cfg.encoder_seq or 64,
                  audio_dim=model_cfg.d_model)
    return SyntheticLMData(DataConfig(
        vocab_size=model_cfg.vocab_size, seq_len=shape.seq_len,
        global_batch=shape.global_batch, seed=seed,
        num_shards=num_shards, shard_id=shard_id, **kw))
