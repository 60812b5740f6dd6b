"""minicpm3-4b [dense] — Multi-head Latent Attention (MLA).

62L d_model=2560 40H d_ff=6400 vocab=73448 [hf:openbmb/MiniCPM3-4B; hf].
MLA dims per the HF config: q_lora 768, kv_lora 256, qk nope/rope head dims
64/32, v head dim 64. Decode uses the absorbed-matmul latent-cache path.
"""
from repro_torch.models.model import ModelConfig

ID = "minicpm3-4b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="dense",
        n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=96,
        d_ff=6400, vocab=73448, rope_theta=1e4,
        mla=True, mla_q_lora=768, mla_kv_lora=256,
        mla_qk_nope_dim=64, mla_qk_rope_dim=32, mla_v_dim=64,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=24,
        d_ff=128, vocab=128, rope_theta=1e4,
        mla=True, mla_q_lora=32, mla_kv_lora=16,
        mla_qk_nope_dim=16, mla_qk_rope_dim=8, mla_v_dim=16,
        q_chunk=16, kv_chunk=16, remat=False,
    )
