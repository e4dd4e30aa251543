"""llama-3.2-vision-11b — dense backbone with gated cross-attention image
layers every 5th layer [hf:meta-llama/Llama-3.2-11B-Vision; unverified].

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.  The vision
frontend is a STUB per the task spec: ``input_specs()`` provides precomputed
patch embeddings (B, 1600, 4096).  Pure full attention -> ``long_500k``
skipped.
"""

from repro_torch.utils.config import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    mlp_type="swiglu",
    rope_theta=500000.0,
    cross_attn_period=5,  # 8 cross-attention layers
    vision_seq=1600,      # patches after the (stubbed) projector
    vision_dim=4096,
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    name="llama-vision-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=128, cross_attn_period=2,
    vision_seq=8, vision_dim=64, dtype="float32",
)


def default_parallel(kind: str) -> ParallelConfig:
    if kind == "train":
        return ParallelConfig(fsdp=2, tp=16, remat="dots")
    return ParallelConfig(fsdp=2, tp=16)
