"""qwen2-vl-72b [vlm] — M-RoPE backbone (vision frontend stubbed).

80L d_model=8192 64H (GQA kv=8, head_dim 128) d_ff=29568 vocab=152064
[arXiv:2409.12191; hf]. This is the transformer BACKBONE only: it takes
token ids plus the (t, h, w) M-RoPE position tensor a vision preprocessor
would produce; patch embedding is a stub.
"""
from repro_torch.models.model import ModelConfig

ID = "qwen2-vl-72b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=29568, vocab=152064, rope_theta=1e6,
        mrope_sections=(16, 24, 24),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=128, rope_theta=1e6,
        mrope_sections=(2, 3, 3),
        q_chunk=16, kv_chunk=16, remat=False,
    )
