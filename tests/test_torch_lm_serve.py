"""LM serving of the PyTorch/CUDA port against the JAX package.

For every dense and MoE smoke config the JAX package's random weights are
carried across by ``params_from_jax`` and both packages run the same prompt
on the CPU: ``prefill`` logits and caches, ``extend_cache``, ``decode_step``
logits and caches, ``forward`` and ``generate``'s greedy tokens. In float32
the logits agree within 1e-4 and the tokens are the same; in bfloat16 the
largest error is within 2e-2 of each tensor's scale (``close``). The
``ssm``, ``hybrid`` and ``encdec`` families raise ``NotImplementedError``
in the port. A ``gpu`` test holds the card against the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.train import steps  # noqa: E402

try:  # the reference
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.launch import serve as jserve
    from repro.models import model as JM
except ImportError:
    jax = None

SERVED = [a for a in ARCHS if get_config(a, smoke=True).family in ("dense", "moe")]
UNPORTED = [a for a in ARCHS if a not in SERVED]
B, S, NEW = 2, 20, 6


@pytest.fixture(autouse=True)
def _reference(request):
    if jax is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference package is not installed")


def configs(arch, dtype):
    over = dict(compute_dtype=dtype) if dtype else {}
    return (dataclasses.replace(get_config(arch, smoke=True), **over),
            dataclasses.replace(jget_config(arch, smoke=True), **over))


def jax_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, jax.device_get(JM.init(jax.random.PRNGKey(seed), jcfg)))


def paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(paths(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (tuple(v.shape), str(v.dtype))
    return out


def prompt(cfg, seed=1, length=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, length), dtype=np.int32)


def mrope(cfg, length):
    if cfg.mrope_sections is None:
        return None, None
    pos = np.broadcast_to(np.arange(length, dtype=np.int32)[None, None], (3, B, length)).copy()
    return torch.from_numpy(pos), jnp.asarray(pos)


def close(got: torch.Tensor, want, tol):
    """float32: rtol = atol = ``tol`` elementwise. bfloat16: the largest
    error within ``tol`` of the tensor's scale, max(1, max |want|): XLA keeps
    fused bf16 intermediates in float32 where torch rounds each op, so a
    second layer sees inputs a bf16 unit (2^-8 relative) apart."""
    got, want = got.float().numpy(), np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    if tol >= 1e-2:
        err, scale = np.abs(got - want).max(initial=0.0), max(1.0, np.abs(want).max(initial=0.0))
        assert err <= tol * scale, f"max error {err} over scale {scale}"
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def cache_close(got: dict, want: dict, tol):
    assert sorted(got) == sorted(want)
    for key in got:
        close(got[key], want[key], tol)


@pytest.mark.parametrize("arch", SERVED)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_prefill_and_decode_match_reference(arch, dtype, tol):
    cfg, jcfg = configs(arch, dtype)
    jp = jax_params(jcfg)
    params = M.params_from_jax(jp, device="cpu")
    tokens = prompt(cfg)
    pos_t, pos_j = mrope(cfg, S)
    logits, cache = M.prefill(params, cfg, torch.from_numpy(tokens), mrope_pos=pos_t)
    jlogits, jcache = JM.prefill(jp, jcfg, jnp.asarray(tokens), mrope_pos=pos_j)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (B, cfg.vocab)
    close(logits, jlogits, tol)
    cache_close(cache, jcache, tol)
    assert all(cache[k].dtype == cfg.cdtype for k in cache)
    cache, jcache = M.extend_cache(cache, S + NEW), JM.extend_cache(jcache, S + NEW)
    cache_close(cache, jcache, tol)
    assert all(c.shape[2] == S + NEW for c in cache.values())
    nxt = np.random.default_rng(2).integers(0, cfg.vocab, size=(B, 1), dtype=np.int32)
    cast = M.cast_params(params, cfg)
    for i in range(2):
        logits, cache = M.decode_step(cast, cfg, cache, torch.from_numpy(nxt), S + i)
        jlogits, jcache = JM.decode_step(jp, jcfg, jcache, jnp.asarray(nxt), jnp.int32(S + i))
        close(logits, jlogits, tol)
        cache_close(cache, jcache, tol)
        nxt = (nxt + 7) % cfg.vocab


@pytest.mark.parametrize("arch", SERVED)
def test_forward_and_generate_match_reference(arch):
    """float32: forward logits within 1e-4, generate's greedy tokens equal;
    the port's own tree has the reference's paths, shapes and dtypes."""
    cfg, jcfg = configs(arch, "float32")
    jp = jax_params(jcfg)
    params = M.params_from_jax(jp, device="cpu")
    assert paths(M.params_to_numpy(M.init(0, cfg, device="cpu"))) == paths(jp)
    tokens = prompt(cfg, seed=3)
    pos_t, pos_j = mrope(cfg, S)
    logits, aux = M.forward(params, cfg, torch.from_numpy(tokens), mrope_pos=pos_t)
    jlogits, jaux = JM.forward(jp, jcfg, jnp.asarray(tokens), mrope_pos=pos_j)
    close(logits, jlogits, 1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-4, atol=1e-6)
    got, stats = serve.generate(cfg, params, torch.from_numpy(tokens), NEW)
    want, _ = jserve.generate(jcfg, jp, jnp.asarray(tokens), NEW)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.shape == (B, S + NEW) and stats["decode_tok_per_s"] > 0


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_decode_matches_forward(arch):
    """The counterpart of tests/test_models.py's: prefill the first half,
    decode the next token, against forward() at the same positions, at the
    reference's tolerances (2e-2 for prefill, 5e-2 for decode), in the
    configs' own bfloat16 compute, on that test's weights and tokens (an MoE
    forward over 32 tokens and a prefill over 16 fill their experts'
    capacity differently, so not every prompt passes in either package)."""
    cfg, jcfg = configs(arch, None)
    params = M.params_from_jax(jax_params(jcfg), device="cpu")
    n = 32
    tokens = torch.from_numpy(np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (B, n), 0, cfg.vocab, dtype=jnp.int32)))
    pos, _ = mrope(cfg, n)
    full, _ = M.forward(params, cfg, tokens, mrope_pos=pos)
    half = n // 2
    step = steps.build_prefill_step(cfg)
    inputs = {"tokens": tokens[:, :half]}
    if pos is not None:
        inputs["mrope_pos"] = pos[:, :, :half]
    pf, cache = step(params, inputs)
    np.testing.assert_allclose(pf.numpy(), full[:, half - 1].numpy(), rtol=2e-2, atol=2e-2)
    cache = M.extend_cache(cache, n)
    _, dec, cache = steps.build_serve_step(cfg)(params, cache, tokens[:, half:half + 1], half)
    np.testing.assert_allclose(dec.numpy(), full[:, half].numpy(), rtol=5e-2, atol=5e-2)


def test_chunked_attention_skips_only_masked_blocks():
    """Longer than one kv chunk, ragged against both chunk sizes, GQA: the
    chunked online softmax equals one dense masked softmax."""
    from repro_torch.models import layers
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 45, h, 8, generator=g) for h in (4, 2, 2))
    for window in (None, 7, 40):
        got = layers.chunked_attention(q, k, v, causal=True, window=window, q_chunk=8,
                                       kv_chunk=16)
        rows, cols = torch.arange(45)[:, None], torch.arange(45)[None, :]
        ok = cols <= rows
        if window is not None:
            ok = ok & (cols > rows - window)
        qg = q.reshape(2, 45, 2, 2, 8)
        s = torch.einsum("bqkrd,bskd->bkrqs", qg, k) / np.sqrt(8)
        s = torch.where(ok, s, torch.tensor(float("-inf")))
        want = torch.einsum("bkrqs,bskd->bqkrd", torch.softmax(s, -1), v).reshape(2, 45, 4, 8)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_families_raise(arch):
    cfg = get_config(arch, smoke=True)
    assert cfg.family in ("ssm", "hybrid", "encdec")
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    for call in (lambda: M.init(0, cfg, device="cpu"),
                 lambda: M.forward({}, cfg, tokens),
                 lambda: M.prefill({}, cfg, tokens),
                 lambda: M.init_cache(cfg, 1, 8, device="cpu"),
                 lambda: M.decode_step({}, cfg, {}, tokens[:, :1], 0),
                 lambda: cfg.param_count()):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "grok-1-314b", "minicpm3-4b"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_params_round_trip_bit_for_bit(arch, param_dtype):
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), param_dtype=param_dtype)
    jp = jax_params(jcfg, seed=5)
    back = M.params_to_numpy(M.params_from_jax(jp, device="cpu"))
    assert paths(back) == paths(jp)
    flat, jflat = jax.tree.leaves(back), jax.tree.leaves(jp)
    assert all(a.dtype == b.dtype and a.tobytes() == b.tobytes() for a, b in zip(flat, jflat))


def test_config_registry_equals_reference():
    from repro.configs import ARCHS as JARCHS
    assert ARCHS == JARCHS
    for arch in ARCHS:
        for smoke in (False, True):
            got, want = get_config(arch, smoke=smoke), jget_config(arch, smoke=smoke)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    cfg = get_config("qwen3-1.7b")
    assert (cfg.pdtype, cfg.cdtype) == (torch.float32, torch.bfloat16)
    assert cfg.param_count() == jget_config("qwen3-1.7b").param_count()
    moe = get_config("phi3.5-moe-42b-a6.6b")
    assert moe.active_param_count() == jget_config("phi3.5-moe-42b-a6.6b").active_param_count()
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")


def test_hints_identity_and_installed():
    from repro_torch import hints
    x = torch.ones(3)
    assert hints.hint(x, "act") is x
    with hints.hints_installed({"act": lambda t: t * 2}):
        assert torch.equal(hints.hint(x, "act"), x * 2)
        assert hints.hint(x, "logits") is x
    assert hints.hint(x, "act") is x
    assert not hints.scan_unroll()
    with hints.unrolled_scans():
        assert hints.scan_unroll()
    assert not hints.scan_unroll()


def test_entry_points_default_to_the_card():
    cfg = get_config("qwen3-1.7b", smoke=True)
    if torch.cuda.is_available():
        assert M.init(0, cfg)["embed"].device.type == "cuda"
    else:
        for call in (lambda: M.init(0, cfg), lambda: M.init_cache(cfg, 1, 4),
                     lambda: M.params_from_jax({"a": np.zeros(2)})):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    assert transformer.FAMILIES == ("dense", "moe")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", SERVED)
def test_card_matches_cpu(arch):
    """float32 (TF32 off): prefill, two decode steps and generate on the card
    against the same weights on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = dataclasses.replace(get_config(arch, smoke=True), compute_dtype="float32")
    host = M.init(0, cfg, device="cpu")
    card = M.params_from_jax(M.params_to_numpy(host), device="cuda")
    tokens = torch.from_numpy(prompt(cfg, seed=6))
    pos, _ = mrope(cfg, S)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = []
        for params, dev in ((card, "cuda"), (host, "cpu")):
            t = tokens.to(dev)
            logits, cache = M.prefill(params, cfg, t, mrope_pos=None if pos is None else pos.to(dev))
            cache = M.extend_cache(cache, S + NEW)
            got = [logits.cpu()]
            for i in range(2):
                logits, cache = M.decode_step(params, cfg, cache, t[:, i:i + 1], S + i)
                got.append(logits.cpu())
            gen, _ = serve.generate(cfg, params, t, NEW)
            outs.append((torch.stack(got), gen))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
