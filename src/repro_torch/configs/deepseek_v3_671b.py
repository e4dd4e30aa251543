"""deepseek-v3-671b — MLA + 1 shared + 256 routed top-8 MoE + MTP
[arXiv:2412.19437; hf].

61L d_model=7168 128H d_ff(expert)=2048 vocab=129280; MLA ranks
q=1536 / kv=512, rope head 64, nope head 128, v head 128; sigmoid router.
Pure full attention -> ``long_500k`` skipped.
"""

from repro_torch.utils.config import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=2048,
    vocab_size=129280,
    attn_type="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    moe_num_experts=256,
    moe_top_k=8,
    moe_d_ff=2048,
    moe_num_shared=1,
    moe_router="sigmoid",
    moe_capacity_factor=1.25,
    mtp_depth=1,
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    name="deepseek-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=64, vocab_size=128, q_lora_rank=32, kv_lora_rank=16,
    qk_rope_head_dim=8, qk_nope_head_dim=8, v_head_dim=8,
    moe_num_experts=8, moe_top_k=2, moe_d_ff=64, dtype="float32",
)


def default_parallel(kind: str) -> ParallelConfig:
    if kind == "train":
        return ParallelConfig(fsdp=2, tp=16, remat="dots", microbatch=1,
                              moe_expert_axis="model")
    return ParallelConfig(fsdp=2, tp=16, moe_expert_axis="model")
