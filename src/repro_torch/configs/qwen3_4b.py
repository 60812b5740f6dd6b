"""qwen3-4b [dense] — GQA with per-head q/k RMSNorm.

36L d_model=2560 32H (GQA kv=8, head_dim 128) d_ff=9728 vocab=151936
[hf:Qwen/Qwen3-8B family; hf]. Note head_dim 128 means the q projection is
2560 -> 4096 (Qwen3 decouples head_dim from d_model / n_heads).
"""
from repro_torch.models.model import ModelConfig

ID = "qwen3-4b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="dense",
        n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=9728, vocab=151936, qk_norm=True, rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=16,
        d_ff=160, vocab=128, qk_norm=True, rope_theta=1e6,
        q_chunk=16, kv_chunk=16, remat=False,
    )
