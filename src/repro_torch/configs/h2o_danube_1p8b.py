"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818; hf].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, window 4096.
The ring KV cache is bounded by the window -> ``long_500k`` runs.
"""

from repro_torch.utils.config import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    mlp_type="swiglu",
    attn_type="swa",
    sliding_window=4096,
    rope_theta=10000.0,
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    name="h2o-danube-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=128, sliding_window=16,
    dtype="float32",
)


def default_parallel(kind: str) -> ParallelConfig:
    if kind == "train":
        return ParallelConfig(fsdp=2, tp=8, remat="dots",
                              attn_kv_block=512)
    return ParallelConfig(fsdp=2, tp=8)
