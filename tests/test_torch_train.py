"""Training on the PyTorch/CUDA port (``data/pipeline.py``, ``optim/adamw.py``,
``model.loss_fn``, ``train/steps.py``, ``launch/train.py``) on the CPU.

* The cases of ``tests/test_data_optim.py`` on the port; the token-file
  source reads the same windows as the JAX package's, bit for bit.
* ``loss_fn`` against the JAX package for every arch at float32 compute
  (within 1e-4), from the same weights and batch.
* ``apply_update`` against the JAX package from the same numpy parameters,
  gradients and state (within 1e-6), with and without int8 compression.
* A train step of every arch stays finite and moves the parameters.
* The cases of ``tests/test_train_integration.py``, each on a corpus the
  test writes itself: the loss drops on learnable data, a resume from a
  checkpoint is exact, and compressed gradients still learn.
* The train state's checkpoint layout equals the JAX package's (whisper-base
  at full size: 83 leaves, a 1,316,999,375-byte blob, the same header).

The port's ``SyntheticSource`` draws from ``torch.Generator`` s, not the
reference's threefry stream, so it is held to its own determinism.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # the reference (every test here holds the port against it or runs beside it)
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.data import pipeline as jdata
    from repro.models import model as JM
    from repro.optim import adamw as jadamw
except ImportError as e:
    pytest.skip(f"the JAX reference is not importable: {e}", allow_module_level=True)

from repro_torch.checkpoint import devio  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointConfig, CheckpointManager  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.data import pipeline as data_lib  # noqa: E402
from repro_torch.launch.train import run_training  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import steps  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 32
QUIET = dict(log=lambda *_: None, device="cpu")


# ---------------------------------------------------------------------------
# data (tests/test_data_optim.py)
# ---------------------------------------------------------------------------


def test_synthetic_deterministic_resume():
    d = data_lib.DataConfig(vocab=100, seq=16, global_batch=4, seed=3)
    s1, s2 = data_lib.SyntheticSource(d, "cpu"), data_lib.SyntheticSource(d, "cpu")
    # O(1) resume: step 7's batch identical without replaying 0..6
    assert torch.equal(s1.tokens_at(7), s2.tokens_at(7))
    assert not torch.equal(s1.tokens_at(7), s1.tokens_at(8))
    b = s1.tokens_at(7)
    assert b.shape == (4, 17) and b.dtype == torch.int32 and 0 <= int(b.min()) <= int(b.max()) < 100
    other = data_lib.SyntheticSource(dataclasses.replace(d, seed=4), "cpu")
    assert not torch.equal(other.tokens_at(7), b)


def test_token_file_source_windows(tmp_path):
    toks = np.arange(1000, dtype=np.uint16)
    path = str(tmp_path / "c.bin")
    data_lib.write_corpus(path, toks)
    d = data_lib.DataConfig(vocab=1000, seq=9, global_batch=3, path=path)
    src = data_lib.TokenFileSource(d, "cpu")
    b = src.tokens_at(0).numpy()
    assert b.shape == (3, 10)
    for row in b:       # windows are contiguous spans of the corpus
        assert np.array_equal(row, np.arange(row[0], row[0] + 10))
    np.testing.assert_array_equal(b, data_lib.TokenFileSource(d, "cpu").tokens_at(0).numpy())
    # the JAX package's windows, bit for bit, at several steps and seeds
    for seed in (0, 5):
        dd = dataclasses.replace(d, seed=seed)
        jd = jdata.DataConfig(vocab=1000, seq=9, global_batch=3, path=path, seed=seed)
        for step in (0, 1, 17, 40):
            got = data_lib.TokenFileSource(dd, "cpu").tokens_at(step).numpy()
            want = np.asarray(jdata.TokenFileSource(jd).tokens_at(step))
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_batch_for_extras():
    cfg = get_config("qwen2-vl-72b", smoke=True)
    d = data_lib.DataConfig(vocab=cfg.vocab, seq=8, global_batch=2)
    batch = data_lib.batch_for(cfg, data_lib.SyntheticSource(d, "cpu"), 0)
    assert batch["mrope_pos"].shape == (3, 2, 8)
    np.testing.assert_array_equal(batch["labels"][:, :-1].numpy(), batch["tokens"][:, 1:].numpy())
    w = get_config("whisper-base", smoke=True)
    dw = data_lib.DataConfig(vocab=w.vocab, seq=8, global_batch=2)
    b1 = data_lib.batch_for(w, data_lib.SyntheticSource(dw, "cpu"), 3)
    b2 = data_lib.batch_for(w, data_lib.SyntheticSource(dw, "cpu"), 3)
    assert b1["enc_frames"].shape == (2, w.enc_ctx, w.d_model)
    assert b1["enc_frames"].dtype == torch.bfloat16
    assert torch.equal(b1["enc_frames"], b2["enc_frames"])


# ---------------------------------------------------------------------------
# optimizer (tests/test_data_optim.py)
# ---------------------------------------------------------------------------


def test_lr_schedule_shape():
    o = adamw.OptConfig(peak_lr=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    lrs = [float(adamw.lr_at(o, torch.tensor(s, dtype=torch.int32))) for s in (0, 5, 10, 50, 100)]
    assert lrs[0] == 0.0
    assert abs(lrs[2] - 1e-3) < 1e-9          # peak at the end of warmup
    assert lrs[1] < lrs[2] and lrs[3] < lrs[2]
    assert abs(lrs[4] - 1e-4) < 1e-8          # min_lr_frac floor
    jo = jadamw.OptConfig(peak_lr=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    want = [float(jadamw.lr_at(jo, jnp.int32(s))) for s in (0, 5, 10, 50, 100)]
    np.testing.assert_allclose(lrs, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed,scale", [(0, 1e-6), (1, 3e-3), (2, 1.0), (3, 37.5), (4, 1e3)])
def test_quantize_roundtrip_bounded(seed, scale):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal(64) * scale).astype(np.float32))
    q, s = adamw.quantize_int8(x)
    assert q.dtype == torch.int8
    back = adamw.dequantize_int8(q, s)
    amax = float(x.abs().max())
    assert float((back - x).abs().max()) <= amax / 127.0 + 1e-6
    jq, js = jadamw.quantize_int8(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(s), float(js), rtol=1e-7)


def test_error_feedback_is_unbiased_over_time():
    """Constant gradient: EF-compressed updates converge to the true sum."""
    g = torch.from_numpy(np.linspace(-1, 1, 32).astype(np.float32)) * 0.37
    err = torch.zeros_like(g)
    total = torch.zeros_like(g)
    for _ in range(50):
        ghat, err = adamw.compress_with_feedback(g, err)
        total = total + ghat
    np.testing.assert_allclose((total / 50).numpy(), g.numpy(), atol=2e-3)


def test_clip_bounds_update_norm():
    params = {"w": torch.ones((8, 8))}
    o = adamw.OptConfig(peak_lr=1.0, warmup_steps=0, total_steps=1, clip_norm=1e-3,
                        weight_decay=0.0)
    state = adamw.init_opt(params, o)
    _, _, m = adamw.apply_update(params, {"w": torch.full((8, 8), 1e6)}, state, o)
    assert float(m["grad_norm"]) > 1e3        # the raw norm is reported


def _tree(rng, shapes):
    return {k: (_tree(rng, v) if isinstance(v, dict) else
                rng.standard_normal(v).astype(np.float32)) for k, v in shapes.items()}


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("clip_norm", [1.0, 1e3])
def test_apply_update_matches_reference(compress, clip_norm):
    """Three steps from the same numpy parameters, gradients and state: the
    parameters, m, v (and the error residual) within 1e-6 of the JAX
    package's, and the same count, lr and grad norm."""
    rng = np.random.default_rng(7)
    shapes = {"embed": (11, 6), "layers": {"w": (3, 6, 5), "norm": (3, 6)}, "bias": (5,)}
    params_np = _tree(rng, shapes)
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip_norm,
              compress_grads=compress)
    ocfg, jocfg = adamw.OptConfig(**kw), jadamw.OptConfig(**kw)
    params, jparams = _torch(params_np), jax.tree.map(jnp.asarray, params_np)
    state, jstate = adamw.init_opt(params, ocfg), jadamw.init_opt(jparams, jocfg)
    for _ in range(3):
        grads_np = _tree(rng, shapes)
        params, state, m = adamw.apply_update(params, _torch(grads_np), state, ocfg)
        jparams, jstate, jm = jadamw.apply_update(jparams, jax.tree.map(jnp.asarray, grads_np),
                                                  jstate, jocfg)
        for a, b in zip(jax.tree.leaves(_np({"p": params, "s": state})),
                        jax.tree.leaves(_np({"p": jparams, "s": jstate}))):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    assert int(state["count"]) == 3 and sorted(state) == sorted(jstate)


# ---------------------------------------------------------------------------
# loss and train step (tests/test_models.py)
# ---------------------------------------------------------------------------


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(B, S), dtype=np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1                         # masked positions
    labels[0, :3] = -1
    batch = {"tokens": tokens, "labels": labels}
    if cfg.mrope_sections is not None:
        batch["mrope_pos"] = np.broadcast_to(np.arange(S, dtype=np.int32)[None, None],
                                             (3, B, S)).copy()
    if cfg.family == "encdec":
        batch["enc_frames"] = rng.standard_normal((B, cfg.enc_ctx, cfg.d_model)) \
            .astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_reference(arch):
    cfg = dataclasses.replace(get_config(arch, smoke=True), compute_dtype="float32")
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), compute_dtype="float32")
    jp = jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(0), jcfg))
    params = M.params_from_jax(jp, device="cpu")
    batch = _batch(cfg)
    loss, metrics = M.loss_fn(params, cfg, _torch(batch))
    jloss, jmetrics = JM.loss_fn(jp, jcfg, jax.tree.map(jnp.asarray, batch))
    assert sorted(metrics) == sorted(jmetrics)
    for key in metrics:
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=1e-4,
                                   atol=1e-4, err_msg=key)
    assert float(metrics["tokens"]) == B * S - B - 3
    assert float(loss) == float(metrics["loss"])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_no_nan(arch):
    cfg = get_config(arch, smoke=True)
    params = M.init(0, cfg, device="cpu")
    before = [t.detach().clone() for t in M._leaves(params)]
    ocfg = adamw.OptConfig(total_steps=10, warmup_steps=2)
    opt = adamw.init_opt(params, ocfg)
    d = data_lib.DataConfig(vocab=cfg.vocab, seq=S, global_batch=B)
    batch = data_lib.batch_for(cfg, data_lib.SyntheticSource(d, "cpu"), 1)
    params2, opt2, metrics = steps.build_train_step(cfg, ocfg)(params, opt, batch)
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    after = M._leaves(params2)
    assert max(float((a.detach() - b).abs().max()) for a, b in zip(after, before)) > 0
    assert all(bool(torch.isfinite(t).all()) for t in after)
    assert int(opt2["count"]) == 1
    ev = steps.build_eval_step(cfg)(params2, batch)
    assert np.isfinite(float(ev["loss"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_run_training_every_arch(arch):
    """``run_training`` drives every config (encoder frames and M-RoPE
    positions from ``batch_for``): finite losses, the count advanced."""
    cfg = get_config(arch, smoke=True)
    d = data_lib.DataConfig(vocab=cfg.vocab, seq=16, global_batch=2, seed=1)
    out = run_training(cfg, adamw.OptConfig(total_steps=3, warmup_steps=1), d, 3, log_every=1,
                       **QUIET)
    assert [h["step"] for h in out["history"]] == [0, 1, 2] and len(out["step_s"]) == 3
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in out["history"])
    assert int(out["opt"]["count"]) == 3


# ---------------------------------------------------------------------------
# end to end (tests/test_train_integration.py)
# ---------------------------------------------------------------------------


def _patterned_corpus(path, vocab=97, n_tokens=60_000, seed=0):
    """Affine next-token rule => cross-entropy can approach 0."""
    rng = np.random.default_rng(seed)
    toks = np.zeros(n_tokens, dtype=np.uint16)
    toks[0] = rng.integers(vocab)
    for i in range(1, n_tokens):
        toks[i] = (toks[i - 1] * 7 + 3) % vocab
    data_lib.write_corpus(str(path), toks)
    return str(path)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _patterned_corpus(tmp_path_factory.mktemp("data") / "corpus.bin")


def _cfg():
    return dataclasses.replace(get_config("qwen3-1.7b", smoke=True), vocab=97)


def test_loss_decreases_on_learnable_data(corpus):
    ocfg = adamw.OptConfig(peak_lr=3e-3, warmup_steps=5, total_steps=60)
    dcfg = data_lib.DataConfig(vocab=97, seq=32, global_batch=8, path=corpus)
    out = run_training(_cfg(), ocfg, dcfg, 60, log_every=20, **QUIET)
    first, last = out["history"][0]["ce"], out["history"][-1]["ce"]
    assert last < first - 1.0, (first, last)   # a big drop on a learnable rule


@pytest.mark.parametrize("device_direct", [False, True])
def test_checkpoint_resume_is_exact(tmp_path, corpus, device_direct):
    """Ten steps, a checkpoint, a "crash", a resume to twenty: on the CPU the
    resumed run's losses and final state equal the unbroken run's, bit for
    bit, through the host route and the device-direct (coded) route."""
    cfg = _cfg()
    ocfg = adamw.OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20)
    dcfg = data_lib.DataConfig(vocab=97, seq=32, global_batch=4, path=corpus)

    def manager(name):
        return CheckpointManager(CheckpointConfig(root=str(tmp_path / name),
                                                  device_direct=device_direct), device="cpu")
    full = run_training(cfg, ocfg, dcfg, 20, ckpt=manager("a"), save_every=10, log_every=1,
                        **QUIET)
    ck = manager("b")
    run_training(cfg, ocfg, dcfg, 10, ckpt=ck, save_every=10, log_every=1, **QUIET)
    resumed = run_training(cfg, ocfg, dcfg, 20, ckpt=ck, save_every=10, log_every=1, **QUIET)
    assert [h["step"] for h in resumed["history"]] == list(range(10, 20))
    assert resumed["history"] == full["history"][10:]
    for a, b in adamw._zip(resumed["params"], full["params"]):   # leaves by path
        assert torch.equal(a, b)
    assert int(resumed["opt"]["count"]) == 20


def test_compressed_grads_still_learn(corpus):
    ocfg = adamw.OptConfig(peak_lr=3e-3, warmup_steps=5, total_steps=40, compress_grads=True)
    dcfg = data_lib.DataConfig(vocab=97, seq=32, global_batch=8, path=corpus)
    out = run_training(_cfg(), ocfg, dcfg, 40, log_every=10, **QUIET)
    assert out["history"][-1]["ce"] < out["history"][0]["ce"] - 0.5
    assert sorted(out["opt"]) == ["count", "err", "m", "v"]


def test_entry_points_default_to_the_card():
    cfg = get_config("qwen3-1.7b", smoke=True)
    d = data_lib.DataConfig(vocab=cfg.vocab, seq=8, global_batch=2)
    if torch.cuda.is_available():
        assert data_lib.SyntheticSource(d).tokens_at(0).device.type == "cuda"
    else:
        for call in (lambda: data_lib.SyntheticSource(d),
                     lambda: run_training(cfg, adamw.OptConfig(), d, 1, log=print)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


# ---------------------------------------------------------------------------
# the train state's checkpoint layout
# ---------------------------------------------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_whisper_train_state_layout_matches_reference():
    """``chip_smoke.py`` phase 13's whisper-base state, built by the port's
    ``init(..., device="meta")`` and ``init_opt``: 83 leaves and a
    1,316,999,375-byte blob whose header equals the JAX package's for its
    ``init`` and ``init_opt`` (``benchmarks/fig_checkpoint.py``'s state)."""
    from repro.checkpoint import devio as jdevio
    smoke = _chip_smoke()
    layout = devio.state_layout(smoke.whisper_state(lambda shape: torch.empty(shape, device="meta")))
    assert len(layout.metas) == 83 and layout.blob_len == smoke.WHISPER_BLOB_BYTES == 1316999375
    jcfg = jget_config("whisper-base")
    jparams = jax.eval_shape(lambda: JM.init(jax.random.PRNGKey(0), jcfg))
    jopt = jax.eval_shape(lambda: jadamw.init_opt(jparams, jadamw.OptConfig()))
    want = jdevio.state_layout({"params": jparams, "opt": jopt, "step": np.int64(0)})
    assert layout.prefix == want.prefix and layout.blob_len == want.blob_len
