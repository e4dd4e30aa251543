"""command-r-35b — dense GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01; unverified].

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
Pure full attention -> ``long_500k`` skipped.
"""

from repro_torch.utils.config import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    mlp_type="swiglu",
    rope_theta=8000000.0,
    tie_embeddings=True,  # command-r ties input/output embeddings
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    name="command-r-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=192, vocab_size=128, dtype="float32",
)


def default_parallel(kind: str) -> ParallelConfig:
    if kind == "train":
        return ParallelConfig(fsdp=2, tp=16, remat="dots")
    return ParallelConfig(fsdp=2, tp=16)
