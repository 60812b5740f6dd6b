"""The port's sequence mixers (``repro_torch.models.ssm`` and ``encdec``)
against the sequential numpy oracles of ``tests/test_seq_mixers.py`` and the
JAX package's functions, on the CPU in float32.

The chunk scans run at ragged lengths (S not a multiple of the chunk) and
agree with the token-by-token recurrences and with the JAX scans within
rtol = atol = 1e-4; decoding token by token reproduces the chunked forward;
``encode_audio`` and ``cross_attn`` match the JAX package from the same
weights (``params_from_jax``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import encdec, ssm  # noqa: E402
from repro_torch.models.model import params_from_jax  # noqa: E402

try:  # the reference and its tests' oracles (every test here needs them)
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.models import encdec as jencdec
    from repro.models import ssm as jssm
    from tests.test_seq_mixers import naive_ssd, naive_wkv
except ImportError as e:   # no JAX, or another installed package named ``tests``
    pytest.skip(f"the JAX reference or its tests are not importable: {e}",
                allow_module_level=True)

TOL = dict(rtol=1e-4, atol=1e-4)
CHUNK = 8
RAGGED = [(1, 8, 1), (2, 13, 3), (1, 24, 2), (2, 29, 1)]   # (B, S, H); S % CHUNK != 0 mostly


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("B,S,H", RAGGED)
def test_ssd_chunk_scan_matches_sequential_and_reference(B, S, H):
    dh, ns = 4, 3
    rng = np.random.default_rng(S + 7 * H)
    xdt = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    a_log = (-np.abs(rng.standard_normal((B, S, H))) * 0.5).astype(np.float32)
    Bm = rng.standard_normal((B, S, ns)).astype(np.float32)
    Cm = rng.standard_normal((B, S, ns)).astype(np.float32)
    y, final = ssm._ssd_chunk_scan(t(xdt), t(a_log), t(Bm), t(Cm), CHUNK)
    y_ref, final_ref = naive_ssd(xdt, a_log, Bm, Cm)
    close(y, y_ref)
    close(final, final_ref)
    jy, jfinal = jssm._ssd_chunk_scan(*(jnp.asarray(a) for a in (xdt, a_log, Bm, Cm)), CHUNK)
    close(y, jy)
    close(final, jfinal)


@pytest.mark.parametrize("B,S,H", RAGGED)
def test_wkv_chunk_scan_matches_sequential_and_reference(B, S, H):
    dh = 4
    rng = np.random.default_rng(S * 31 + H)
    r, k, v = (rng.standard_normal((B, S, H, dh)).astype(np.float32) for _ in range(3))
    logw = (-np.abs(rng.standard_normal((B, S, H, dh))) - 0.05).astype(np.float32)
    u = np.full((H, dh), 0.3, np.float32)
    y, final = ssm._wkv_chunk_scan(t(r), t(k), t(v), t(logw), t(u), CHUNK)
    y_ref, final_ref = naive_wkv(r, k, v, logw, u)
    close(y, y_ref)
    close(final, final_ref)
    jy, jfinal = jssm._wkv_chunk_scan(*(jnp.asarray(a) for a in (r, k, v, logw, u)), CHUNK)
    close(y, jy)
    close(final, jfinal)


def test_wkv_chunk_scan_has_gradients_everywhere():
    """The masked log decays are -inf before ``exp``: the backward pass
    through them stays finite."""
    rng = np.random.default_rng(0)
    r, k, v = (t(rng.standard_normal((1, 11, 2, 4))).requires_grad_() for _ in range(3))
    logw = t(-np.abs(rng.standard_normal((1, 11, 2, 4))) - 0.05).requires_grad_()
    y, final = ssm._wkv_chunk_scan(r, k, v, logw, t(np.full((2, 4), 0.3)), CHUNK)
    (y.sum() + final.sum()).backward()
    assert all(bool(torch.isfinite(a.grad).all()) for a in (r, k, v, logw))


def _mamba(seed=0):
    jcfg = jget_config("hymba-1.5b", smoke=True)
    jp = jax.tree.map(np.asarray, jssm.mamba_init(jax.random.PRNGKey(seed), jcfg, jnp.float32))
    return get_config("hymba-1.5b", smoke=True), jcfg, params_from_jax(jp, device="cpu"), jp


def _rwkv(seed=0):
    jcfg = jget_config("rwkv6-3b", smoke=True)
    jp = jax.tree.map(np.asarray, jssm.rwkv_time_init(jax.random.PRNGKey(seed), jcfg,
                                                      jnp.float32))
    return get_config("rwkv6-3b", smoke=True), jcfg, params_from_jax(jp, device="cpu"), jp


@pytest.mark.parametrize("S", [5, 12])
def test_mamba_forward_and_decode_match(S):
    """The forward (ragged against the chunk) equals the JAX forward and its
    cache; decoding token by token from an empty cache equals the forward."""
    cfg, jcfg, p, jp = _mamba()
    B = 2
    x = np.random.default_rng(1).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    y, state = ssm.mamba_forward(p, cfg, t(x), return_state=True)
    jy, jstate = jssm.mamba_forward(jp, jcfg, jnp.asarray(x), return_state=True)
    close(y, jy)
    close(state["state"], jstate["state"])
    close(state["conv"], jstate["conv"])
    cache = ssm.mamba_cache_init(cfg, B, torch.float32)
    ys = []
    for i in range(S):
        y_i, cache = ssm.mamba_decode(p, cfg, t(x[:, i:i + 1]), cache)
        ys.append(y_i)
    close(torch.cat(ys, dim=1), y.detach().numpy())
    close(cache["state"], state["state"].numpy())
    close(cache["conv"], state["conv"].numpy())


@pytest.mark.parametrize("S", [5, 12])
def test_rwkv_time_forward_and_decode_match(S):
    cfg, jcfg, p, jp = _rwkv()
    B = 2
    x = (np.random.default_rng(1).standard_normal((B, S, cfg.d_model)) * 0.3).astype(np.float32)
    y, state = ssm.rwkv_time_forward(p, cfg, t(x), return_state=True)
    jy, jstate = jssm.rwkv_time_forward(jp, jcfg, jnp.asarray(x), return_state=True)
    close(y, jy)
    close(state["state"], jstate["state"])
    close(state["x_prev"], jstate["x_prev"])
    cache = ssm.rwkv_cache_init(cfg, B, torch.float32)["time"]
    ys = []
    for i in range(S):
        y_i, cache = ssm.rwkv_time_decode(p, cfg, t(x[:, i:i + 1]), cache)
        ys.append(y_i)
    close(torch.cat(ys, dim=1), y.detach().numpy())
    close(cache["state"], state["state"].numpy())


def test_rwkv_channel_mix_matches_reference():
    jcfg = jget_config("rwkv6-3b", smoke=True)
    jp = jax.tree.map(np.asarray, jssm.rwkv_channel_init(jax.random.PRNGKey(3), jcfg,
                                                         jnp.float32))
    p = params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(2)
    x, xp = (rng.standard_normal((2, 7, jcfg.d_model)).astype(np.float32) for _ in range(2))
    close(ssm.rwkv_channel_forward(p, t(x), t(xp)),
          jssm.rwkv_channel_forward(jp, jnp.asarray(x), jnp.asarray(xp)))


def _whisper():
    jcfg = jget_config("whisper-base", smoke=True)
    jp = jax.tree.map(np.asarray, jencdec.encdec_init(jax.random.PRNGKey(0), jcfg, jnp.float32))
    return get_config("whisper-base", smoke=True), jcfg, params_from_jax(jp, device="cpu"), jp


def test_encode_audio_matches_reference():
    """enc_ctx 24 against q_chunk = kv_chunk = 16: the bidirectional
    attention masks the padded keys of the last chunk."""
    cfg, jcfg, p, jp = _whisper()
    frames = np.random.default_rng(5).standard_normal((2, cfg.enc_ctx, cfg.d_model))
    frames = frames.astype(np.float32)
    assert cfg.enc_ctx % cfg.kv_chunk != 0
    np.testing.assert_array_equal(encdec.sinusoid_pos(cfg.enc_ctx, cfg.d_model),
                                  jencdec.sinusoid_pos(cfg.enc_ctx, cfg.d_model))
    close(encdec.encode_audio(p, cfg, t(frames)), jencdec.encode_audio(jp, jcfg,
                                                                      jnp.asarray(frames)))


def test_cross_attn_matches_reference():
    cfg, jcfg, p, jp = _whisper()
    rng = np.random.default_rng(6)
    enc_out = rng.standard_normal((2, cfg.enc_ctx, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    lp = {k: v[1] for k, v in p["dec_layers"]["xattn"].items()}
    jlp = {k: v[1] for k, v in jp["dec_layers"]["xattn"].items()}
    k, v = encdec.cross_kv(lp, cfg, t(enc_out))
    jk, jv = jencdec.cross_kv(jlp, jcfg, jnp.asarray(enc_out))
    close(k, jk)
    close(v, jv)
    close(encdec.cross_attn(lp, cfg, t(x), k, v),
          jencdec.cross_attn(jlp, jcfg, jnp.asarray(x), jk, jv))
    cache = encdec.fill_cross_cache(p, cfg, t(enc_out),
                                    encdec.dec_cache_init(cfg, 2, 8, torch.float32))
    jcache = jencdec.fill_cross_cache(jp, jcfg, jnp.asarray(enc_out),
                                      jencdec.dec_cache_init(jcfg, 2, 8, jnp.float32))
    for key in ("xk", "xv"):
        close(cache[key], jcache[key])
