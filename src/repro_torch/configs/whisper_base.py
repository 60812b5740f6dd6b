"""whisper-base [audio] — encoder-decoder backbone (conv frontend stubbed).

6L enc + 6L dec, d_model=512 8H (MHA kv=8, head_dim 64) d_ff=2048
vocab=51865 [arXiv:2212.04356; unverified]. The encoder takes
precomputed frame embeddings (B, 1500, 512) in place of the mel+conv
frontend. The decoder uses RoPE instead of Whisper's learned positions
so parameter shapes are request-length independent.
"""
from repro_torch.models.model import ModelConfig

ID = "whisper-base"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="encdec",
        n_layers=6, enc_layers=6, enc_ctx=1500,
        d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
        d_ff=2048, vocab=51865, rope_theta=1e4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke", family="encdec",
        n_layers=2, enc_layers=2, enc_ctx=24,
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=128, rope_theta=1e4,
        q_chunk=16, kv_chunk=16, remat=False,
    )
