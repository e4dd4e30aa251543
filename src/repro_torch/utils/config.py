"""Config system.

Frozen dataclasses with ``replace``-style updates, dict round-trip (for
checkpoint metadata and launch scripts), and validation hooks.  Every model
architecture in ``repro_torch.configs`` is a ``ModelConfig``; the launcher composes
``ModelConfig × ShapeConfig × ParallelConfig × TrainConfig`` into a
``RunConfig``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


def frozen(cls):
    """Decorator alias so configs read as ``@frozen`` like production code."""
    return dataclasses.dataclass(frozen=True)(cls)


def _asdict(obj) -> Dict[str, Any]:
    return dataclasses.asdict(obj)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description; superset of all 10 assigned families."""

    name: str = "tiny"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0  # 0 -> d_model // num_heads
    d_ff: int = 512
    vocab_size: int = 256
    max_seq_len: int = 2048

    # activation / norm
    mlp_type: str = "swiglu"  # swiglu | relu2 | gelu
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    attn_logit_softcap: float = 0.0

    # attention variants
    attn_type: str = "gqa"  # gqa | mla | swa | none
    sliding_window: int = 0  # >0 -> sliding-window attention
    # MLA (deepseek-style latent attention)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_num_shared: int = 0
    moe_layer_period: int = 1  # every k-th layer is MoE (llama4 interleaving)
    moe_capacity_factor: float = 1.25
    moe_router: str = "softmax"  # softmax | sigmoid (deepseek-v3)

    # SSM (mamba1 / mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_num_heads: int = 0  # mamba2 heads; 0 -> mamba1
    ssm_chunk: int = 256
    # hybrid: attention block applied every `hybrid_attn_period` layers,
    # sharing one set of weights (zamba2-style shared block).
    hybrid_attn_period: int = 0

    # VLM cross-attention
    cross_attn_period: int = 0  # every k-th layer has cross-attention
    vision_seq: int = 0  # number of patch embeddings (stub frontend)
    vision_dim: int = 0

    # audio enc-dec
    encoder_layers: int = 0
    encoder_seq: int = 0  # frames after conv frontend (stubbed)

    # MTP (deepseek multi-token prediction) — extra head depth
    mtp_depth: int = 0

    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # -- derived sizes ----------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.moe_num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.attn_type == "none" and self.hybrid_attn_period == 0

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can decode at 500k context with bounded state."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    def param_count(self) -> int:
        """Analytic parameter count (exact for our implementation)."""
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self, active_only=True)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        return _asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (assigned per architecture)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def multi_pod(self) -> bool:
        return "pod" in self.axes


@dataclass(frozen=True)
class ParallelConfig:
    """Parallelism plan — the primary CAMEO-tunable surface."""

    dp: int = 1           # pure data parallel degree (within "data" axis)
    fsdp: int = 1         # parameter/optimizer sharding degree over data axis
    tp: int = 1           # tensor parallel degree over "model" axis
    ep: int = 1           # expert parallel degree (MoE; subdivides data axis)
    sp: bool = False      # sequence/context parallelism for activations
    microbatch: int = 1   # gradient-accumulation microbatches
    remat: str = "none"   # none | full | dots
    grad_compression: str = "none"  # none | int8_ef
    collective_matmul: bool = False  # decompose TP matmuls for overlap
    scan_layers: bool = True
    attn_q_block: int = 512
    attn_kv_block: int = 1024
    decode_kv_shard: str = "model"  # axis KV cache is sharded over at decode
    moe_group_size: int = 512       # GShard routing group size
    moe_expert_axis: str = "model"  # model (TP-combine) | data (EP all-to-all)

    def replace(self, **kw) -> "ParallelConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        return _asdict(self)


@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"  # adamw | adafactor | sgdm
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    schedule: str = "cosine"  # cosine | linear | constant
    seed: int = 0
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    z_loss: float = 1e-4
    moe_aux_loss: float = 1e-2

    def to_dict(self) -> Dict[str, Any]:
        return _asdict(self)


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    shape: ShapeConfig = field(default_factory=lambda: ShapeConfig("train_tiny", 128, 8, "train"))
    mesh: MeshConfig = field(default_factory=MeshConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    checkpoint_dir: str = "/tmp/repro_ckpt"
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    log_every: int = 10

    def validate(self) -> None:
        m, p = self.mesh, self.parallel
        data_size = 1
        for ax, s in zip(m.axes, m.shape):
            if ax in ("data", "pod"):
                data_size *= s
        model_size = dict(zip(m.axes, m.shape)).get("model", 1)
        if p.tp > model_size:
            raise ValueError(f"tp={p.tp} exceeds model axis size {model_size}")
        if self.shape.global_batch % (data_size * p.microbatch) != 0 and self.shape.kind == "train":
            raise ValueError(
                f"global_batch={self.shape.global_batch} not divisible by "
                f"data axis ({data_size}) x microbatch ({p.microbatch})"
            )
        if self.model.is_moe and self.model.moe_num_experts % p.ep != 0:
            raise ValueError("experts not divisible by ep degree")

    def to_json(self) -> str:
        return json.dumps(
            {
                "model": self.model.to_dict(),
                "shape": _asdict(self.shape),
                "mesh": _asdict(self.mesh),
                "parallel": self.parallel.to_dict(),
                "train": self.train.to_dict(),
                "checkpoint_dir": self.checkpoint_dir,
                "checkpoint_every": self.checkpoint_every,
                "keep_checkpoints": self.keep_checkpoints,
            },
            indent=2,
        )

    @classmethod
    def from_json(cls, s: str) -> "RunConfig":
        d = json.loads(s)
        return cls(
            model=ModelConfig.from_dict(d["model"]),
            shape=ShapeConfig(**d["shape"]),
            mesh=MeshConfig(shape=tuple(d["mesh"]["shape"]), axes=tuple(d["mesh"]["axes"])),
            parallel=ParallelConfig(**d["parallel"]),
            train=TrainConfig(**d["train"]),
            checkpoint_dir=d.get("checkpoint_dir", "/tmp/repro_ckpt"),
            checkpoint_every=d.get("checkpoint_every", 100),
            keep_checkpoints=d.get("keep_checkpoints", 3),
        )

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)
