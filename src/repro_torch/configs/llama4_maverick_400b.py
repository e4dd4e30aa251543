"""llama4-maverick-400b-a17b — interleaved dense/MoE, 128e top-1, shared
expert, early fusion [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048.
Pure full attention -> ``long_500k`` skipped.
"""

from repro_torch.utils.config import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    mlp_type="swiglu",
    moe_num_experts=128,
    moe_top_k=1,
    moe_d_ff=8192,
    moe_num_shared=1,
    moe_layer_period=2,  # alternating dense / MoE layers
    moe_router="softmax",
    rope_theta=500000.0,
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    name="llama4-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=128, moe_num_experts=8,
    moe_top_k=1, moe_d_ff=128, dtype="float32",
)


def default_parallel(kind: str) -> ParallelConfig:
    if kind == "train":
        return ParallelConfig(fsdp=2, tp=16, remat="dots",
                              moe_expert_axis="model")
    return ParallelConfig(fsdp=2, tp=16, moe_expert_axis="model")
