"""LM serving of the PyTorch/CUDA port against the JAX package.

For every smoke config (dense, MoE, SSM, hybrid and encoder-decoder) the
JAX package's random weights are carried across by ``params_from_jax`` and
both packages run the same prompt (and, for the encoder-decoder, the same
encoder frames) on the CPU: ``prefill`` logits and caches, ``extend_cache``,
``decode_step`` logits and caches, ``forward`` and ``generate``'s greedy
tokens. In float32 the logits agree within 1e-4 and the tokens are the same;
in bfloat16 the largest error is within 2e-2 of each tensor's scale
(``close``). A ``gpu`` test holds the card against the CPU.
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

SERVED = list(ARCHS)
B, S, NEW = 2, 20, 6
SEQ_KEYS = {"k", "v", "c", "k_rope"}     # the leaves extend_cache pads along seq


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


def frames(cfg, seed=4):
    """The encoder-decoder's frame embeddings for both packages (None, None
    for the other families)."""
    if cfg.family != "encdec":
        return None, None
    f = np.random.default_rng(seed).standard_normal((B, cfg.enc_ctx, cfg.d_model))
    f = f.astype(np.float32)
    return torch.from_numpy(f), jnp.asarray(f)


def extras(cfg, length):
    """(port kwargs, JAX kwargs) of prefill / forward: M-RoPE positions and
    encoder frames where the family takes them."""
    pos_t, pos_j = mrope(cfg, length)
    enc_t, enc_j = frames(cfg)
    return ({"mrope_pos": pos_t, "enc_frames": enc_t},
            {"mrope_pos": pos_j, "enc_frames": enc_j})


def leaves(tree, prefix=""):
    """(path, leaf) of a nested cache, in sorted path order."""
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out += leaves(tree[k], f"{prefix}{k}/")
        else:
            out.append((prefix + k, tree[k]))
    return out


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
    got, want = leaves(got), leaves(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        close(a, b, tol)


@pytest.mark.parametrize("arch", SERVED)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_prefill_and_decode_match_reference(arch, dtype, tol):
    cfg, jcfg = configs(arch, dtype)
    jp = jax_params(jcfg)
    params = M.params_from_jax(jp, device="cpu")
    tokens = prompt(cfg)
    kw, jkw = extras(cfg, S)
    logits, cache = M.prefill(params, cfg, torch.from_numpy(tokens), **kw)
    jlogits, jcache = JM.prefill(jp, jcfg, jnp.asarray(tokens), **jkw)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (B, cfg.vocab)
    close(logits, jlogits, tol)
    cache_close(cache, jcache, tol)
    # recurrent states stay float32, as in the reference; the rest computes
    # in the compute dtype
    assert all(c.dtype == (torch.float32 if path.endswith("state") else cfg.cdtype)
               for path, c in leaves(cache))
    cache, jcache = M.extend_cache(cache, S + NEW), JM.extend_cache(jcache, S + NEW)
    cache_close(cache, jcache, tol)
    assert all(c.shape[2] == S + NEW for path, c in leaves(cache)
               if path.split("/")[-1] in SEQ_KEYS)
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
    kw, jkw = extras(cfg, S)
    logits, aux = M.forward(params, cfg, torch.from_numpy(tokens), **kw)
    jlogits, jaux = JM.forward(jp, jcfg, jnp.asarray(tokens), **jkw)
    close(logits, jlogits, 1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-4, atol=1e-6)
    got, stats = serve.generate(cfg, params, torch.from_numpy(tokens), NEW,
                                enc_frames=kw["enc_frames"])
    want, _ = jserve.generate(jcfg, jp, jnp.asarray(tokens), NEW, enc_frames=jkw["enc_frames"])
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
    enc = None
    if cfg.family == "encdec":      # tests/test_models.py's frames, in bfloat16
        enc = torch.from_numpy(np.asarray(jax.random.normal(
            jax.random.PRNGKey(1), (B, cfg.enc_ctx, cfg.d_model), jnp.bfloat16), np.float32))
    full, _ = M.forward(params, cfg, tokens, mrope_pos=pos, enc_frames=enc)
    half = n // 2
    step = steps.build_prefill_step(cfg)
    inputs = {"tokens": tokens[:, :half], "enc_frames": enc}
    if pos is not None:
        inputs["mrope_pos"] = pos[:, :, :half]
    pf, cache = step(params, inputs)
    np.testing.assert_allclose(pf.numpy(), full[:, half - 1].numpy(), rtol=2e-2, atol=2e-2)
    cache = M.extend_cache(cache, n)
    _, dec, cache = steps.build_serve_step(cfg)(params, cache, tokens[:, half:half + 1], half)
    np.testing.assert_allclose(dec.numpy(), full[:, half].numpy(), rtol=5e-2, atol=5e-2)


DRIFT = {  # deeper, wider smoke stacks: (overrides, prompt)
    "hymba-1.5b": (dict(n_layers=8, d_model=256, ssm_d_inner=512, n_heads=4, n_kv_heads=2,
                        head_dim=64, d_ff=768, sliding_window=100, global_layers=(0, 4, 7),
                        q_chunk=64, kv_chunk=128, ssm_chunk=32), 200),
    "rwkv6-3b": (dict(n_layers=8, d_model=256, n_heads=4, head_dim=64, d_ff=768,
                      ssm_chunk=32), 200),
}


@pytest.mark.parametrize("arch", sorted(DRIFT))
def test_bf16_decode_drift_matches_reference(arch):
    """In bfloat16, decode after a prefill differs from one longer prefill
    by a few percent of the logits' scale in the JAX package too (8 layers
    here; more at 32). The port's drift is no larger than twice the
    reference's from the same weights, and its decode is no farther from
    the float32 answer (RMS) than twice its own bfloat16 prefill: the bound
    ``chip_smoke.py`` phase 17 holds at full size."""
    over, P = DRIFT[arch]
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), **over)
    jp = jax_params(jcfg)
    params = M.params_from_jax(jp, device="cpu")
    seq = np.random.default_rng(1).integers(0, cfg.vocab, (B, P + 3), dtype=np.int32)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    cast, cast32 = M.cast_params(params, cfg), M.cast_params(params, f32)
    _, cache = M.prefill(cast, cfg, torch.from_numpy(seq[:, :P]))
    _, jcache = JM.prefill(jp, jcfg, jnp.asarray(seq[:, :P]))
    cache, jcache = M.extend_cache(cache, P + 3), JM.extend_cache(jcache, P + 3)
    drift, jdrift, ratio = [], [], []
    for i in range(3):
        pos, tok = P + i, seq[:, P + i:P + i + 1]
        dec, cache = M.decode_step(cast, cfg, cache, torch.from_numpy(tok), pos)
        want, _ = M.prefill(cast, cfg, torch.from_numpy(seq[:, :pos + 1]))
        exact, _ = M.prefill(cast32, f32, torch.from_numpy(seq[:, :pos + 1]))
        jdec, jcache = JM.decode_step(jp, jcfg, jcache, jnp.asarray(tok), jnp.int32(pos))
        jwant, _ = JM.prefill(jp, jcfg, jnp.asarray(seq[:, :pos + 1]))
        drift.append(float((dec - want).abs().max() / want.abs().max()))
        jdrift.append(float(jnp.abs(jdec - jwant).max() / jnp.abs(jwant).max()))
        rms = [float(torch.sqrt(torch.mean((x - exact) ** 2))) for x in (dec, want)]
        ratio.append(rms[0] / rms[1])
    print(f"{arch}: bf16 decode drift, port {drift}, reference {jdrift}; "
          f"RMS from float32, decode over prefill {ratio}")
    assert max(drift) <= 2 * max(jdrift)
    assert max(ratio) <= 2.0


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


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_init_matches_reference_shapes(arch):
    """At full size, the port's ``init(..., device="meta")`` tree has the JAX
    ``init``'s paths, shapes and dtypes (``jax.eval_shape``), and its
    ``init_cache`` those of the JAX ``init_cache``."""
    cfg, jcfg = get_config(arch), jget_config(arch)

    def torch_paths(tree):
        return {p: (tuple(t.shape), str(t.dtype).removeprefix("torch.")) for p, t in leaves(tree)}

    want = paths(jax.eval_shape(lambda: JM.init(jax.random.PRNGKey(0), jcfg)))
    assert torch_paths(M.init(0, cfg, device="meta")) == want
    assert torch_paths(M.init_cache(cfg, 2, 16, device="meta")) == \
        paths(jax.eval_shape(lambda: JM.init_cache(jcfg, 2, 16)))


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
    assert transformer.FAMILIES == ("dense", "moe", "ssm", "hybrid", "encdec")


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
    enc, _ = frames(cfg)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = []
        for params, dev in ((card, "cuda"), (host, "cpu")):
            t = tokens.to(dev)
            on = {"mrope_pos": None if pos is None else pos.to(dev),
                  "enc_frames": None if enc is None else enc.to(dev)}
            logits, cache = M.prefill(params, cfg, t, **on)
            cache = M.extend_cache(cache, S + NEW)
            got = [logits.cpu()]
            for i in range(2):
                logits, cache = M.decode_step(params, cfg, cache, t[:, i:i + 1], S + i)
                got.append(logits.cpu())
            gen, _ = serve.generate(cfg, params, t, NEW, enc_frames=on["enc_frames"])
            outs.append((torch.stack(got), gen))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
