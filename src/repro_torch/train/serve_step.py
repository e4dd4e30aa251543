"""Serve-step factories: prefill / decode / generate — the port of
:mod:`repro.train.serve_step`.

``make_prefill_step`` runs the whole prompt, filling the KV caches and
computing the recurrent (SSM) states, and returns the last-position
logits; ``make_decode_step`` advances one token per slot.  Both run their body under an *exclusive*
``dispatch.use_launch_config`` so a step is a pure function of its
``launch_config``.  :func:`jitted_steps` keeps its name and its cache key
``(model, run, cache_len, frozen launch config)``; it caches the eager
step closures (PyTorch runs eagerly; CUDA graphs are later work).

Unlike the reference's functional steps, a step updates the caches of the
state it is given in place and returns a state over the same tensors.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import dispatch
from repro_torch.models.model import Model
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.utils.config import RunConfig


def freeze_launch_config(launch_config: Optional[Dict[str, Any]]
                         ) -> Tuple[Tuple[str, Tuple[Tuple[str, Any], ...]], ...]:
    """Hashable canonical form of a launch config (flat or nested) — the
    step-cache key component, so equivalent spellings share one entry."""
    if not launch_config:
        return ()
    nested = dispatch.split_launch_config(launch_config)
    return tuple((f, tuple(sorted(p.items()))) for f, p in sorted(nested.items()))


class ServeState(NamedTuple):
    caches: Any                   # stacked per-super-block decode state
    lengths: torch.Tensor         # (B,) int32 tokens consumed so far
    extras: Dict[str, torch.Tensor]  # static per-request inputs (none for dense)


def make_prefill_step(model: Model, run: RunConfig,
                      cache_len: Optional[int] = None,
                      launch_config: Optional[Dict[str, Any]] = None
                      ) -> Callable[..., Tuple[ServeState, torch.Tensor]]:
    """Returns prefill(params, batch) -> (ServeState, last_logits (B, V))."""
    max_len = cache_len or run.shape.seq_len
    dispatch.split_launch_config(launch_config or {})  # eager validation

    @torch.no_grad()
    def prefill_step(params, batch: Dict) -> Tuple[ServeState, torch.Tensor]:
        with dispatch.use_launch_config(launch_config, exclusive=True):
            tokens = batch["tokens"]
            b, s = tokens.shape
            caches = model.init_decode_state(b, max_len)
            logits, new_caches, _ = model.forward(
                params, tokens, decode_state=caches, decode=False)
            lengths = torch.full((b,), s, dtype=torch.int32,
                                 device=tokens.device)
            return ServeState(new_caches, lengths, {}), logits[:, -1]

    return prefill_step


def make_decode_step(model: Model, run: RunConfig,
                     launch_config: Optional[Dict[str, Any]] = None
                     ) -> Callable[..., Tuple[ServeState, torch.Tensor]]:
    """Returns decode(params, state, tokens (B,1)) -> (state', logits (B, V))."""
    dispatch.split_launch_config(launch_config or {})  # eager validation

    @torch.no_grad()
    def decode_step(params, state: ServeState, tokens: torch.Tensor
                    ) -> Tuple[ServeState, torch.Tensor]:
        with dispatch.use_launch_config(launch_config, exclusive=True):
            positions = state.lengths[:, None]  # (B, 1) per-request positions
            logits, new_caches, _ = model.forward(
                params, tokens, positions=positions,
                decode_state=state.caches, decode=True)
            new_state = ServeState(new_caches, state.lengths + 1, state.extras)
            return new_state, logits[:, -1]

    return decode_step


# --------------------------------------------------------------------------
# step cache
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _jitted_steps_cached(model: Model, run: RunConfig,
                         cache_len: Optional[int],
                         frozen_launch: Tuple) -> Tuple[Callable, Callable]:
    launch_config = {f: dict(p) for f, p in frozen_launch}
    return (make_prefill_step(model, run, cache_len=cache_len,
                              launch_config=launch_config),
            make_decode_step(model, run, launch_config=launch_config))


def jitted_steps(model: Model, run: RunConfig,
                 cache_len: Optional[int] = None,
                 launch_config: Optional[Dict[str, Any]] = None
                 ) -> Tuple[Callable, Callable]:
    """Cached ``(prefill, decode)`` step pair for this serving setup, keyed
    as in the reference on (model, run, cache_len, canonical launch
    config); LRU-bounded."""
    if not obs_trace.enabled():
        return _jitted_steps_cached(model, run, cache_len,
                                    freeze_launch_config(launch_config))
    before = _jitted_steps_cached.cache_info()
    steps = _jitted_steps_cached(model, run, cache_len,
                                 freeze_launch_config(launch_config))
    after = _jitted_steps_cached.cache_info()
    hit = after.hits > before.hits
    obs_metrics.REGISTRY.inc(
        "jit_cache_hits" if hit else "jit_cache_misses")
    obs_trace.instant("jit_cache_hit" if hit else "jit_cache_miss",
                      cat="jit_cache", track=obs_trace.TRACK_KERNEL,
                      cache_len=cache_len if cache_len is not None else -1,
                      currsize=after.currsize)
    return steps


# --------------------------------------------------------------------------
# generation loop
# --------------------------------------------------------------------------

def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 temperature: Any = 0.0) -> torch.Tensor:
    """logits (B, V) -> (B,) int32. temperature 0 = greedy (argmax, first
    index on ties, as ``jnp.argmax``).

    A scalar temperature applies to every row; a (B,) tensor samples each
    row at its own temperature (0 rows decode greedily).  Sampled rows draw
    from ``generator`` — the reference's ``jax.random`` stream cannot be
    reproduced, so only greedy rows match it."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not torch.is_tensor(temperature):
        if temperature <= 0.0:
            return greedy
        return _categorical(logits.float() / temperature, generator)
    temps = temperature.to(device=logits.device, dtype=torch.float32)
    safe = torch.where(temps > 0.0, temps, torch.ones_like(temps))
    sampled = _categorical(logits.float() / safe[:, None], generator)
    return torch.where(temps > 0.0, sampled, greedy)


def _categorical(logits: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def generate(model: Model, run: RunConfig, params, batch: Dict, *,
             num_steps: int, temperature: float = 0.0, seed: int = 0,
             cache_len: Optional[int] = None,
             launch_config: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Prefill + autoregressive decode. Returns generated tokens (B, steps)."""
    prompt = batch["tokens"]
    cache_len = cache_len or (prompt.shape[1] + num_steps)
    prefill, decode = jitted_steps(model, run, cache_len=cache_len,
                                   launch_config=launch_config)
    gen = torch.Generator(device=prompt.device).manual_seed(seed)
    state, logits = prefill(params, batch)
    tok = sample_token(logits, gen, temperature)
    toks = [tok]
    for _ in range(num_steps - 1):
        state, logits = decode(params, state, tok[:, None])
        tok = sample_token(logits, gen, temperature)
        toks.append(tok)
    return torch.stack(toks, dim=1)
