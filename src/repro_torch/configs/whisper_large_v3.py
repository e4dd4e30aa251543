"""whisper-large-v3 — encoder-decoder backbone; conv/mel frontend stubbed
[arXiv:2212.04356; unverified].

32L (decoder) + 32L (encoder) d_model=1280 20H (kv=20) d_ff=5120
vocab=51866; ``input_specs()`` provides precomputed frame embeddings
(B, 1500, 1280).  Decoder exists -> decode shapes run; full attention ->
``long_500k`` skipped.
"""

from repro_torch.utils.config import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    mlp_type="gelu",
    encoder_layers=32,
    encoder_seq=1500,
    tie_embeddings=True,
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    name="whisper-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=128, vocab_size=128, encoder_layers=2,
    encoder_seq=16, dtype="float32",
)


def default_parallel(kind: str) -> ParallelConfig:
    if kind == "train":
        return ParallelConfig(fsdp=2, tp=4, remat="dots")
    return ParallelConfig(fsdp=2, tp=4)
