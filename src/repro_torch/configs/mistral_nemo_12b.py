"""mistral-nemo-12b [dense] — GQA, 128k context.

40L d_model=5120 32H (GQA kv=8, head_dim 128) d_ff=14336 vocab=131072
[hf:mistralai/Mistral-Nemo-Base-2407; hf].
"""
from repro_torch.models.model import ModelConfig

ID = "mistral-nemo-12b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="dense",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=131072, rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=128, rope_theta=1e6,
        q_chunk=16, kv_chunk=16, remat=False,
    )
