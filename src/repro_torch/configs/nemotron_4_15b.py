"""nemotron-4-15b — dense GQA with squared-ReLU MLP [arXiv:2402.16819; unverified].

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000.
Pure full attention -> ``long_500k`` skipped.
"""

from repro_torch.utils.config import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    mlp_type="relu2",
    rope_theta=10000.0,
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    name="nemotron-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=256, vocab_size=128, dtype="float32",
)


def default_parallel(kind: str) -> ParallelConfig:
    if kind == "train":
        return ParallelConfig(fsdp=2, tp=16, remat="dots")
    return ParallelConfig(fsdp=2, tp=16)
