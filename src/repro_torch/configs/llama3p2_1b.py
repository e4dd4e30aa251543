"""llama3.2-1b — small llama3 [hf:meta-llama/Llama-3.2-1B; unverified].

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256, tied embeddings,
head_dim 64, rope theta 500k. Pure full attention -> ``long_500k`` skipped.
"""

from repro_torch.utils.config import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    mlp_type="swiglu",
    rope_theta=500000.0,
    tie_embeddings=True,
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    name="llama3.2-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=128, dtype="float32",
)


def default_parallel(kind: str) -> ParallelConfig:
    if kind == "train":
        return ParallelConfig(fsdp=2, tp=8, remat="dots")
    return ParallelConfig(fsdp=2, tp=8)
