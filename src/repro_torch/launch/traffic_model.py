"""Analytic HBM-traffic model (perfect-fusion lower bound), per device.

The JAX package's ``repro.launch.traffic_model`` on the port, rule for rule.
The roofline memory term needs the traffic of a step under full fusion; the
port's "bytes accessed" (``repro_torch.launch.cost_model``) counts every
eager op's inputs and outputs, an unfused upper bound, so the model is kept
beside it. Assumptions (stated so they can be audited):

* Elementwise chains (norms, RoPE, activations, residual adds, masks) fuse
  into their producing/consuming matmuls: charged 0.
* Every matmul/einsum charges one HBM read of each operand tile it streams
  and one write of its result. Flash-attention K/V are re-read once per
  query chunk (on-chip memory cannot hold 32k of K/V).
* Weights are read in bf16 once per use: forward, remat-recompute and
  backward(dL/dx) -> 3 reads when remat, 2 otherwise; dL/dW writes once
  (fp32). Model-sharded dims stay sharded (1/mp); FSDP-gathered copies are
  read in full (the gather materializes them locally).
* Optimizer update touches its FSDP shard only: read p,m,v + write p,m,v.
* Backward activation traffic = 2x forward matmul I/O (cotangent stream
  read+write mirrors the primal stream).

Per-tensor byte counts come from one layer of ``transformer.stack_init`` on
the ``meta`` device, with each leaf's rule from ``sharding._param_rule`` at
the JAX package's path of that leaf, so every architecture (MoE experts,
MLA low-rank factors, RWKV mixes) is counted from its actual shapes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs import shapes as shapes_lib
from repro_torch.models import model as model_lib
from repro_torch.models import transformer as transformer_lib
from repro_torch.train import sharding as sh_lib

BF16 = 2
F32 = 4


def layer_shapes(cfg) -> dict:
    """One layer's parameter tree (meta tensors, no leading L axis): layer 0
    of a one-layer stack."""
    one = dataclasses.replace(cfg, n_layers=1)
    return transformer_lib.layer_slice(transformer_lib.stack_init(model_lib._MetaGenerator(), one,
                                                                  cfg.pdtype), 0)


def _layer_weight_bytes(cfg, mp: int) -> tuple[float, float]:
    """(bf16 compute-copy bytes, fp32 master bytes) of ONE layer, per device.

    Tensors whose rule puts a dim on ``model`` stay 1/mp; everything else is
    counted full (FSDP copies are gathered before use).
    """
    total_bf16 = 0.0
    total_f32 = 0.0

    def visit(path, leaf):
        nonlocal total_bf16, total_f32
        spec = sh_lib._param_rule(path, tuple(leaf.shape), _FakeMesh(mp))
        shard = 1
        for dim_axes in spec:
            if dim_axes == "model":
                shard *= mp
        n = float(np.prod(leaf.shape))
        total_bf16 += n * BF16 / shard
        total_f32 += n * F32 / shard
        return leaf

    sh_lib._map_with_path(visit, layer_shapes(cfg))
    return total_bf16, total_f32


class _FakeMesh:
    """Just enough mesh for _param_rule: axis sizes + names."""

    def __init__(self, mp: int):
        self.shape = {"model": mp, "data": 1}
        self.axis_names = ("data", "model")


def _activation_io(cfg, Bd: int, S: int, mp: int) -> float:
    """Forward matmul I/O bytes for one layer (per device), bf16."""
    D = cfg.d_model
    A = Bd * S * D * BF16                     # one (B,S,D) stream
    io = 0.0
    if cfg.family == "ssm":
        # rwkv6: 5 mixes share reads; r/k/v/g/w projections + out + channel
        io += 2 * A            # time-mix in/out streams
        io += 5 * (Bd * S * D * BF16 / mp)    # r,k,v,g,dec writes (sharded)
        io += 2 * A            # channel-mix read + write
        io += 2 * Bd * S * cfg.d_ff * BF16 / mp   # k write + read
        io += _wkv_io(cfg, Bd, S, mp)
        return io
    if cfg.mla:
        qh = cfg.mla_qk_nope_dim + cfg.mla_qk_rope_dim
        io += A + Bd * S * cfg.mla_q_lora * BF16          # wdq
        io += Bd * S * cfg.n_heads * qh * BF16 / mp       # wuq write
        io += A + Bd * S * cfg.mla_kv_lora * BF16         # wdkv
        io += 2 * Bd * S * cfg.n_heads * (cfg.mla_qk_nope_dim
                                          + cfg.mla_v_dim) * BF16 / mp
        io += _attn_io(cfg, Bd, S, mp, cfg.n_heads,
                       qh, cfg.mla_v_dim, kv_heads=cfg.n_heads)
        io += Bd * S * cfg.n_heads * cfg.mla_v_dim * BF16 / mp + A  # wo
    else:
        H, Kh, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        io += 3 * A                                       # q,k,v reads
        io += Bd * S * (H + 2 * Kh) * Dh * BF16 / mp      # q,k,v writes
        io += _attn_io(cfg, Bd, S, mp, H, Dh, Dh, kv_heads=Kh)
        io += Bd * S * H * Dh * BF16 / mp + A             # wo
    if cfg.family == "hybrid":
        di = cfg.ssm_d_inner
        io += 2 * A + 2 * Bd * S * di * BF16 / mp         # win in/out (x,z)
        io += _ssd_io(cfg, Bd, S, mp)
        io += Bd * S * di * BF16 / mp + A                 # wout
    if cfg.family == "moe":
        E, K = cfg.n_experts, cfg.moe_top_k
        C = Bd * S * K / E * cfg.capacity_factor
        # dispatch/combine einsums + 3 expert matmuls on (E,C,D)/(E,C,F)
        ec = E * C * cfg.d_model * BF16
        ef = E * C * cfg.d_ff * BF16
        per_dev = 1 / mp if E % mp == 0 else 1.0
        io += A + 2 * ec * per_dev                        # dispatch r/w + read
        io += 2 * ef * per_dev if E % mp == 0 else 2 * ef / mp  # h write/read
        io += ec * per_dev + A                            # combine
    else:
        F = cfg.d_ff
        io += 2 * A + 2 * Bd * S * F * BF16 / mp          # wi,wg
        io += Bd * S * F * BF16 / mp + A                  # wo
    return io


def _attn_io(cfg, Bd, S, mp, H, Dh, Dv, kv_heads) -> float:
    """Flash attention tile traffic: q once, K/V once per q-chunk, o once."""
    h_sh = mp if H % mp == 0 else 1
    nq = max(S // cfg.q_chunk, 1)
    q = Bd * S * H * Dh * BF16 / h_sh
    kv = Bd * S * kv_heads * (Dh + Dv) * BF16 / h_sh * nq
    o = Bd * S * H * Dv * BF16 / h_sh
    return q + kv + o


def _ssd_io(cfg, Bd, S, mp) -> float:
    di, H, ns = cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_state
    h_sh = mp if di % mp == 0 else 1
    x = Bd * S * di * BF16 / h_sh
    state = Bd * H * (di // H) * ns * F32 / h_sh * (S // cfg.ssm_chunk)
    bc = Bd * S * 2 * ns * F32
    return 3 * x + state + bc


def _wkv_io(cfg, Bd, S, mp) -> float:
    D = cfg.d_model
    H = cfg.n_heads
    dh = D // H
    h_sh = mp if D % mp == 0 else 1
    rkv = 3 * Bd * S * D * F32 / h_sh
    state = Bd * H * dh * dh * F32 / h_sh * (S // cfg.ssm_chunk)
    return rkv + state


def _stem_io(cfg, Bd, S, mp, kind: str) -> float:
    D, V = cfg.d_model, cfg.vocab
    A = Bd * S * D * BF16
    emb = A + Bd * S * 4                                 # token reads + embed
    logit_S = S if kind == "train" else 1
    logits = Bd * logit_S * (D * BF16 + V * F32 / mp)
    head_w = D * V * BF16 / mp
    if kind == "train":
        return emb + 3 * (logits + head_w)               # fwd + bwd x2
    return emb + logits + head_w


def traffic(cfg, shape_name: str, mesh_axes: dict[str, int]) -> dict:
    """Per-device HBM bytes for one cell. mesh_axes e.g. {"data":16,"model":16}."""
    sh = shapes_lib.SHAPES[shape_name]
    mp = mesh_axes.get("model", 1)
    dp = int(np.prod([v for k, v in mesh_axes.items() if k != "model"]))
    Bd = max(sh.batch // dp, 1)
    S = sh.seq if sh.kind != "decode" else 1

    w_bf16, w_f32 = _layer_weight_bytes(cfg, mp)
    L = cfg.n_layers
    n_chips = int(np.prod(list(mesh_axes.values())))
    # per-device share of fp32 master/opt state (fully sharded)
    w_master_dev = w_f32 * L / (dp * 1)  # fsdp over data axes; model already /mp

    if sh.kind == "train":
        w_reads = 3 if cfg.remat else 2
        weights = w_reads * w_bf16 * L
        grads = w_f32 * L                          # dL/dW writes
        opt = 6 * w_master_dev                     # r/w of p, m, v shards
        act_fwd = _activation_io(cfg, Bd, S, mp)
        act_mult = (1 + 2 + (1 if cfg.remat else 0))
        acts = act_mult * act_fwd * L
        stem = _stem_io(cfg, Bd, S, mp, "train")
        total = weights + grads + opt + acts + stem
    elif sh.kind == "prefill":
        weights = w_bf16 * L
        acts = _activation_io(cfg, Bd, S, mp) * L
        cache = _cache_bytes(cfg, Bd, S, mp)       # cache writes
        stem = _stem_io(cfg, Bd, S, mp, "prefill")
        total = weights + acts + cache + stem
    else:
        weights = w_bf16 * L
        # read the full (windowed) cache + in-place update of one position
        cache = _cache_bytes(cfg, Bd, sh.seq, mp) * (1 + 1 / sh.seq)
        acts = _activation_io(cfg, Bd, 1, mp) * L
        stem = _stem_io(cfg, Bd, 1, mp, "decode")
        total = weights + cache + acts + stem
    return {"total": total, "weights": weights,
            "acts": acts, "stem": stem,
            "cache": cache if sh.kind != "train" else 0.0,
            "opt": opt if sh.kind == "train" else 0.0,
            "Bd": Bd, "n_chips": n_chips}


def _cache_bytes(cfg, Bd: int, S: int, mp: int) -> float:
    if cfg.family == "ssm":
        D = cfg.d_model
        H = cfg.n_heads
        dh = D // H
        return cfg.n_layers * Bd * H * dh * dh * F32 / mp
    if cfg.mla:
        per_tok = cfg.mla_kv_lora + cfg.mla_qk_rope_dim
    else:
        per_tok = 2 * cfg.n_kv_heads * cfg.head_dim
    kv = cfg.n_layers * Bd * S * per_tok * BF16 / mp  # seq or heads sharded
    if cfg.family == "hybrid":
        kv += cfg.n_layers * Bd * cfg.ssm_d_inner * cfg.ssm_state // \
            cfg.ssm_heads * (cfg.ssm_heads) * F32 / mp
        # sliding-window layers only keep `window` keys live
        n_global = len(cfg.global_layers)
        win_frac = (n_global + (cfg.n_layers - n_global)
                    * min(cfg.sliding_window or S, S) / S) / cfg.n_layers
        kv *= win_frac
    return kv
