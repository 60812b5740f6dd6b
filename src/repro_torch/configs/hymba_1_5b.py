"""hymba-1.5b [hybrid] — parallel attention + Mamba heads per layer.

32L d_model=1600 25H (GQA kv=5, head_dim 64) d_ff=5504 vocab=32001,
ssm_state=16 [arXiv:2411.13676; hf]. Most layers use sliding-window
attention (1024); three layers (first/middle/last, per the paper) stay
global, so long-context decode memory stays bounded by the SSM state plus a
windowed KV cache -> runs the long_500k shape.
"""
from repro_torch.models.model import ModelConfig

ID = "hymba-1.5b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
        d_ff=5504, vocab=32001,
        sliding_window=1024, global_layers=(0, 15, 31), rope_theta=1e4,
        ssm_state=16, ssm_d_inner=3200, ssm_heads=25,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke", family="hybrid",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=128,
        sliding_window=8, global_layers=(0,), rope_theta=1e4,
        ssm_state=4, ssm_d_inner=128, ssm_heads=4, ssm_chunk=8,
        q_chunk=16, kv_chunk=16, remat=False,
    )
