"""falcon-mamba-7b — attention-free Mamba-1 LM [arXiv:2410.05355; unverified].

64L d_model=4096 d_ff=0 vocab=65024 ssm_state=16; d_inner = 2*4096 = 8192.
``long_500k`` runs: the recurrent state is O(1) in sequence length.
"""

from repro_torch.utils.config import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    attn_type="none",
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_chunk=256,
    tie_embeddings=True,
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    name="falcon-mamba-smoke", num_layers=2, d_model=64, vocab_size=128,
    ssm_state=4, ssm_chunk=16, dtype="float32",
)


def default_parallel(kind: str) -> ParallelConfig:
    if kind == "train":
        return ParallelConfig(fsdp=2, tp=16, remat="dots", microbatch=1,
                              scan_layers=True)
    return ParallelConfig(fsdp=2, tp=16)
