"""grok-1-314b [moe] — 8 experts, top-2.

64L d_model=6144 48H (GQA kv=8, head_dim 128) d_ff=32768/expert
vocab=131072 [hf:xai-org/grok-1; unverified]. Parameters are kept in
bf16, as in the JAX package.
"""
from repro_torch.models.model import ModelConfig

ID = "grok-1-314b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="moe",
        n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=32768, vocab=131072, rope_theta=1e4,
        n_experts=8, moe_top_k=2, capacity_factor=1.25,
        moe_seq_chunk=2048,  # windowed dispatch (models/moe.py)
        param_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=128, rope_theta=1e4,
        n_experts=2, moe_top_k=2, capacity_factor=1.25,
        q_chunk=16, kv_chunk=16, remat=False,
    )
