"""phi3.5-moe-42b-a6.6b [moe] — 16 experts, top-2.

32L d_model=4096 32H (GQA kv=8, head_dim 128) d_ff=6400/expert vocab=32064
[hf:microsoft/Phi-3.5-MoE-instruct; hf].
"""
from repro_torch.models.model import ModelConfig

ID = "phi3.5-moe-42b-a6.6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=6400, vocab=32064, rope_theta=1e4,
        n_experts=16, moe_top_k=2, capacity_factor=1.25,
        moe_seq_chunk=2048,  # windowed dispatch (models/moe.py)
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab=128, rope_theta=1e4,
        n_experts=4, moe_top_k=2, capacity_factor=1.25,
        q_chunk=16, kv_chunk=16, remat=False,
    )
