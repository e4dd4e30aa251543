"""zamba2-2.7b — Mamba-2 backbone with a shared attention+MLP block
[arXiv:2411.15242; hf].

54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000 ssm_state=64.
Shared block applied every 6th layer with one set of weights (zamba2-style);
d_inner = 5120, mamba2 head_dim 64 -> 80 ssm heads. ``long_500k`` runs.
"""

from repro_torch.utils.config import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_num_heads=80,  # d_inner 5120 / head_dim 64
    ssm_chunk=256,
    hybrid_attn_period=6,  # 54 = 9 superblocks x (5 mamba2 + 1 shared-attn)
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    name="zamba2-smoke", num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=128, ssm_state=8, ssm_num_heads=4, ssm_chunk=16,
    hybrid_attn_period=2, dtype="float32",
)


def default_parallel(kind: str) -> ParallelConfig:
    if kind == "train":
        return ParallelConfig(fsdp=2, tp=16, remat="dots")
    return ParallelConfig(fsdp=2, tp=16)
