"""Architecture registry — the port of :mod:`repro.configs.registry`: the
reference's ten archs (dense, moe, ssm, hybrid, the vlm
``llama-3.2-vision-11b`` and the audio encoder-decoder
``whisper-large-v3``), in the reference's order, the assigned shape cells
and run assembly, and :func:`input_specs`, the abstract inputs of a cell's
step as tensors on the ``meta`` device (the reference's
``ShapeDtypeStruct`` stand-ins: shapes and dtypes, nothing allocated).
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.shapes import SHAPES, SMOKE_SHAPES, shape_runs_for
from repro_torch.utils.config import (MeshConfig, ModelConfig,
                                      ParallelConfig, RunConfig, ShapeConfig,
                                      TrainConfig)

_ARCH_MODULES: Dict[str, str] = {
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2p7b",
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "llama3.2-1b": "repro_torch.configs.llama3p2_1b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1p8b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama3p2_vision_11b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
}

# archs whose second-moment state must be factored to fit the production
# mesh's memory
_ADAFACTOR_ARCHS = {"deepseek-v3-671b", "llama4-maverick-400b-a17b",
                    "command-r-35b", "nemotron-4-15b"}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch])


def get_model_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def default_parallel(arch: str, kind: str) -> ParallelConfig:
    return _module(arch).default_parallel(kind)


def arch_shapes(arch: str) -> Dict[str, ShapeConfig]:
    return shape_runs_for(get_model_config(arch).sub_quadratic)


def default_train_config(arch: str) -> TrainConfig:
    opt = "adafactor" if arch in _ADAFACTOR_ARCHS else "adamw"
    return TrainConfig(optimizer=opt)


def make_run(arch: str, shape: str, *, multi_pod: bool = False,
             parallel: Optional[ParallelConfig] = None,
             train: Optional[TrainConfig] = None,
             smoke: bool = False) -> RunConfig:
    """The run of one assigned cell (``arch`` x ``shape``) on the
    production mesh — (16, 16) ``("data", "model")``, or (2, 16, 16) with
    a ``"pod"`` axis when ``multi_pod`` — under the arch's default
    parallel plan; ``smoke`` takes the smoke config and shapes on a
    one-device data mesh.  The train CLI's run of a chosen batch and
    sequence is :func:`repro_torch.launch.train.make_run`."""
    shapes = SMOKE_SHAPES if smoke else SHAPES
    if shape not in shapes:
        raise KeyError(f"unknown shape {shape!r}; known: {list(shapes)}")
    shape_cfg = shapes[shape]
    model = get_smoke_config(arch) if smoke else get_model_config(arch)
    if shape_cfg.name == "long_500k" and not model.sub_quadratic:
        raise ValueError(
            f"{arch} is pure full-attention; long_500k is a documented skip")
    mesh = (MeshConfig(shape=(2, 16, 16), axes=("pod", "data", "model"))
            if multi_pod else MeshConfig(shape=(16, 16),
                                         axes=("data", "model")))
    if smoke:
        mesh = MeshConfig(shape=(1,), axes=("data",))
        parallel = parallel or ParallelConfig()
    par = parallel or default_parallel(arch, shape_cfg.kind)
    tc = train or default_train_config(arch)
    run = RunConfig(model=model, shape=shape_cfg, mesh=mesh, parallel=par,
                    train=tc)
    run.validate()
    return run


# --------------------------------------------------------------------------
# input specs (meta tensors, no allocation)
# --------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _i32(*shape) -> torch.Tensor:
    return _meta(shape, torch.int32)


def _modal_extras(cfg: ModelConfig, b: int, dtype) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    if cfg.family == "vlm":
        out["vision_embeds"] = _meta((b, cfg.vision_seq, cfg.vision_dim),
                                     dtype)
    if cfg.family == "audio":
        out["frames"] = _meta((b, cfg.encoder_seq, cfg.d_model), dtype)
    return out


def input_specs(run: RunConfig) -> Dict[str, Any]:
    """Abstract inputs for the step function this shape cell runs, as
    ``meta`` tensors.

    train  -> {"batch": {inputs, targets, [modal]}}
    prefill-> {"batch": {tokens, [modal]}}
    decode -> {"state": ServeState, "tokens": (B, 1)}; the decode state
              is the port's own state init on ``meta``
    """
    from repro_torch.models.model import torch_dtype

    cfg, shape = run.model, run.shape
    b, s = shape.global_batch, shape.seq_len
    dtype = torch_dtype(cfg.dtype)
    if shape.kind == "train":
        batch = {"inputs": _i32(b, s), "targets": _i32(b, s)}
        batch.update(_modal_extras(cfg, b, dtype))
        return {"batch": batch}
    if shape.kind == "prefill":
        batch = {"tokens": _i32(b, s)}
        batch.update(_modal_extras(cfg, b, dtype))
        return {"batch": batch}
    if shape.kind != "decode":
        raise ValueError(f"unknown shape kind {shape.kind!r}")
    return {"state": serve_state_template(run, b, s), "tokens": _i32(b, 1)}


def serve_state_template(run: RunConfig, b: int, s: int, layout=None):
    """The ``ServeState`` of ``b`` requests over ``s`` cache rows, on
    ``meta``: the port's own decode-state init, the lengths, and the vlm /
    audio input a request carries (``vision_embeds`` / ``enc_out``); on a
    ``layout`` (a sharded step's) the state a rank holds
    (``init_decode_state(..., layout=)``)."""
    from repro_torch.models.model import build_model, torch_dtype
    from repro_torch.train.serve_step import ServeState

    cfg = run.model
    dtype = torch_dtype(cfg.dtype)
    caches = build_model(cfg, run.parallel,
                         device="meta").init_decode_state(b, s,
                                                          layout=layout)
    extras: Dict[str, torch.Tensor] = {}
    if cfg.family == "vlm":
        extras["vision_embeds"] = _meta((b, cfg.vision_seq, cfg.vision_dim),
                                        dtype)
    if cfg.family == "audio":
        extras["enc_out"] = _meta((b, cfg.encoder_seq, cfg.d_model), dtype)
    return ServeState(caches=caches, lengths=_i32(b), extras=extras)


def all_cells() -> Tuple[Tuple[str, str], ...]:
    """All 40 assigned (arch, shape) cells, including documented skips."""
    return tuple((arch, shape) for arch in list_archs() for shape in SHAPES)


def runnable_cells() -> Tuple[Tuple[str, str], ...]:
    """Cells that run (excludes full-attention long_500k skips)."""
    return tuple((arch, shape) for arch in list_archs()
                 for shape in arch_shapes(arch))
