"""rwkv6-3b [ssm] — Finch: attention-free, data-dependent decay.

32L d_model=2560 (40 wkv heads of 64) d_ff=8960 vocab=65536
[arXiv:2404.05892; hf]. O(1) decode state -> runs the long_500k shape.
"""
from repro_torch.models.model import ModelConfig

ID = "rwkv6-3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="ssm",
        n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
        d_ff=8960, vocab=65536, ssm_chunk=128,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=224, vocab=128, ssm_chunk=8,
        q_chunk=16, kv_chunk=16, remat=False,
    )
