"""qwen3-1.7b [dense] — GQA with per-head q/k RMSNorm.

28L d_model=2048 16H (GQA kv=8, head_dim 128) d_ff=6144 vocab=151936
[hf:Qwen/Qwen3-8B family; hf].
"""
from repro_torch.models.model import ModelConfig

ID = "qwen3-1.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="dense",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=6144, vocab=151936, qk_norm=True, rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=128, qk_norm=True, rope_theta=1e6,
        q_chunk=16, kv_chunk=16, remat=False,
    )
