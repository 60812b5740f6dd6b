"""Top-level model API: config dataclass, init, forward, loss, prefill, decode.

The JAX package's ``repro.models.model`` in plain PyTorch:
functions over (config, params tree), the tree in the JAX package's layout.
``params_from_jax`` carries a JAX param tree (as numpy arrays) across and
``params_to_numpy`` back, so both packages compute from the same weights.

Entry points run on the card unless the caller passes ``device="cpu"``.
All five families run: dense, MoE, SSM (RWKV6), hybrid (Hymba) through
``repro_torch.models.transformer`` and encoder-decoder (Whisper) through
``repro_torch.models.encdec``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.hints import hint
from repro_torch.models import encdec, transformer
from repro_torch.models import layers as L

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # attention extras
    qk_norm: bool = False
    rope_theta: float = 1e6
    mrope_sections: tuple[int, int, int] | None = None
    sliding_window: int | None = None
    global_layers: tuple[int, ...] = ()
    # MLA (MiniCPM3 / DeepSeek)
    mla: bool = False
    mla_q_lora: int = 768
    mla_kv_lora: int = 256
    mla_qk_nope_dim: int = 64
    mla_qk_rope_dim: int = 32
    mla_v_dim: int = 64
    # MoE
    n_experts: int = 0
    moe_top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    moe_seq_chunk: int = 0     # dispatch window (0 = whole sequence)
    # SSM (Hymba mamba branch / RWKV6 chunking)
    ssm_state: int = 16
    ssm_d_inner: int = 0
    ssm_heads: int = 0
    ssm_chunk: int = 128
    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_ctx: int = 1500
    # numerics / scheduling
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    q_chunk: int = 512
    kv_chunk: int = 1024
    remat: bool = True
    z_loss: float = 1e-4

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def param_count(self) -> int:
        """Total parameters (counted from shapes on the meta device)."""
        return sum(t.numel() for t in _leaves(init(0, self, device="meta")))

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: top_k of n_experts)."""
        p = init(0, self, device="meta")
        total = sum(t.numel() for t in _leaves(p))
        if self.family != "moe":
            return total
        expert_part = sum(t.numel() for t in _leaves(p["layers"]["moe"]))
        return total - expert_part + expert_part * self.moe_top_k // self.n_experts


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def resolve_device(device=None) -> torch.device:
    """CUDA unless the caller says otherwise; raises without a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the host")
    return dev


# ---------------------------------------------------------------------------
# init and weights carried across
# ---------------------------------------------------------------------------


def init(seed, cfg: ModelConfig, device=None) -> Params:
    """Random parameters in the JAX package's tree layout. ``seed`` is an int
    or a ``torch.Generator`` (whose device then wins); the draws are made on
    the device by that generator (``device="meta"`` makes shapes only)."""
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        dev = torch.device("meta") if device == "meta" else resolve_device(device)
        gen = _MetaGenerator() if dev.type == "meta" else \
            torch.Generator(device=dev).manual_seed(int(seed))
    dt = cfg.pdtype
    p: Params = {
        "embed": L.embed_init(gen, cfg.vocab, cfg.d_model, dt),
        "final_norm": L.rmsnorm_init(cfg.d_model, dt, device=gen.device),
        "lm_head": L.dense_init(gen, cfg.d_model, cfg.vocab, dt),
    }
    if cfg.family == "encdec":
        p.update(encdec.encdec_init(gen, cfg, dt))
    else:
        p["layers"] = transformer.stack_init(gen, cfg, dt)
    return p


class _MetaGenerator:
    """Stands in for a generator on the meta device (shapes, no values)."""
    device = torch.device("meta")


def params_from_jax(tree, device=None) -> Params:
    """The JAX package's param tree (nested dicts of numpy arrays, e.g.
    ``jax.device_get(params)``) as the port's tensors on ``device``. A
    bfloat16 leaf crosses as its 16-bit pattern (an int16 view), never as
    numpy bfloat16 arithmetic."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.array(a)                 # a writable copy the tensor may own
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
        return torch.from_numpy(a).to(dev)

    return _map(leaf, tree)


def params_to_numpy(params: Params) -> dict:
    """The inverse of ``params_from_jax``: nested dicts of numpy arrays. A
    bfloat16 leaf leaves as its 16-bit pattern viewed as ``ml_dtypes``'
    bfloat16 where that package is installed (the JAX package's dtype), and
    as exact float32 values where it is not."""
    try:
        import ml_dtypes
    except ImportError:
        ml_dtypes = None

    def leaf(t):
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            if ml_dtypes is None:
                return t.float().numpy()
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    return _map(leaf, params)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def cast_params(params: Params, cfg: ModelConfig) -> Params:
    """Cast floating-point weights of 2 or more dims to the compute dtype.

    1-D leaves (norm scales, per-head gains) stay in their stored dtype.
    A leaf already in the compute dtype is returned as is, so casting a
    cast tree copies nothing.
    """
    def cast(a):
        if a.is_floating_point() and a.ndim >= 2:
            return a.to(cfg.cdtype)
        return a

    return _map(cast, params)


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.to(params["embed"].device)].to(cfg.cdtype)


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.rmsnorm(params["final_norm"], x)
    return (x @ params["lm_head"].to(cfg.cdtype)).to(torch.float32)


def _encode(params: Params, cfg: ModelConfig, enc_frames) -> torch.Tensor:
    assert enc_frames is not None, "encdec family needs encoder frames"
    return encdec.encode_audio(params, cfg, enc_frames.to(cfg.cdtype))


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            mrope_pos: torch.Tensor | None = None, enc_frames=None):
    """tokens (B,S) -> (logits (B,S,V) fp32, aux loss scalar)."""
    params = cast_params(params, cfg)
    x = hint(_embed(params, cfg, tokens), "act")
    if cfg.family == "encdec":
        x = encdec.run_decoder(params, cfg, x, _encode(params, cfg, enc_frames))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        x, aux = transformer.run_stack(params["layers"], cfg, x, mrope_pos=mrope_pos)
    return hint(_logits(params, cfg, x), "logits"), aux


def loss_fn(params: Params, cfg: ModelConfig, batch: dict):
    """Next-token cross entropy (+ z-loss + MoE aux). Labels of -1 are masked.
    Returns (total, metrics), the metrics as 0-d float32 tensors."""
    logits, aux = forward(params, cfg, batch["tokens"], mrope_pos=batch.get("mrope_pos"),
                          enc_frames=batch.get("enc_frames"))
    labels = batch["labels"].to(device=logits.device, dtype=torch.int64)
    mask = (labels >= 0).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
    nll = (lse - picked) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = nll.sum() / denom
    zl = cfg.z_loss * (torch.square(lse) * mask).sum() / denom
    total = ce + zl + cfg.aux_loss_weight * aux
    return total, {"loss": total, "ce": ce, "z_loss": zl, "aux": aux, "tokens": mask.sum()}


# ---------------------------------------------------------------------------
# decode (serve step)
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, seq: int, device=None) -> Params:
    dev = resolve_device(device)
    if cfg.family == "encdec":
        return encdec.dec_cache_init(cfg, batch, seq, cfg.cdtype, dev)
    return transformer.stack_cache_init(cfg, batch, seq, cfg.cdtype, dev)


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            mrope_pos: torch.Tensor | None = None, enc_frames=None):
    """Process a prompt: returns (last-position logits (B,V), decode cache).

    The returned cache covers seq positions [0, S); use ``extend_cache`` to
    grow it to the serving horizon before calling ``decode_step``.
    """
    params = cast_params(params, cfg)
    x = _embed(params, cfg, tokens)
    if cfg.family == "encdec":
        x, caches = encdec.run_decoder_prefill(params, cfg, x, _encode(params, cfg, enc_frames))
    else:
        x, caches = transformer.run_stack_prefill(params["layers"], cfg, x,
                                                  mrope_pos=mrope_pos)
    return hint(_logits(params, cfg, x[:, -1]), "logits2d"), caches


_PAD_SEQ_KEYS = {"k", "v", "c", "k_rope"}


def extend_cache(cache: Params, target_seq: int) -> Params:
    """Pad the seq axis of KV-bearing cache leaves up to ``target_seq``."""
    def walk(d):
        out = {}
        for key, val in d.items():
            if isinstance(val, dict):
                out[key] = walk(val)
            elif key in _PAD_SEQ_KEYS and val.ndim >= 3:
                pad = target_seq - val.shape[2]
                assert pad >= 0, (key, tuple(val.shape), target_seq)
                grown = val.new_zeros(val.shape[:2] + (target_seq,) + val.shape[3:])
                grown[:, :, :val.shape[2]] = val
                out[key] = grown
            else:
                out[key] = val
        return out

    return walk(cache)


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                token: torch.Tensor, pos: int):
    """One serve step: token (B,1) + cache -> (logits (B,V) fp32, cache).

    The cache is updated in place (KV written at ``pos``, recurrent states
    copied over) and returned. Params already in the compute dtype
    (``cast_params``) are used as they are.
    """
    params = cast_params(params, cfg)
    x = _embed(params, cfg, token)
    if cfg.family == "encdec":
        x, cache = encdec.run_decoder_decode(params, cfg, x, cache, pos)
    else:
        x, cache = transformer.run_stack_decode(params["layers"], cfg, x, cache, pos)
    return hint(_logits(params, cfg, x[:, 0]), "logits2d"), cache
