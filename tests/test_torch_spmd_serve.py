"""Prefill and decode over a device mesh on the PyTorch port
(``spmd.build_sharded_prefill_step`` / ``build_sharded_serve_step``,
``ShardedModel.prefill`` / ``decode_step``), on the CPU.

* For every family's smoke config (dense, MoE, MLA, M-RoPE, SSM, hybrid and
  encoder-decoder) over (2, 2) and (2, 2, 2) meshes of ``["cpu"] * n`` in
  the ``2d``, ``fsdp`` and ``serve`` layouts, float32: the sharded prefill's
  last logits and its cache (gathered) within 1e-5 of ``model.prefill``'s
  (the cache grown by ``extend_cache`` to the serving horizon), then four
  greedy decode steps: the same tokens, logits and caches within 1e-5.
* The caches are ``ShardedTensor``s laid out by ``sharding.cache_specs``,
  each position holding exactly its block: K/V split on the sequence over
  ``model``, and at batch 1 over the whole mesh (the ssm and hybrid smoke
  configs, long_500k's rule); SSM states on heads, conv buffers on ``di``,
  whisper's cross K/V on heads.
* The ledger shows how a sequence-split cache is served: the prefill moves
  tensor-parallel K/V from heads to the sequence by an all-to-all; a decode
  step all-gathers q/k/v over ``model`` and combines the softmax over the
  split (an all-max and two all-reduces).
* One case against the JAX package's ``prefill`` / ``decode_step`` from the
  same weights (``model.params_from_jax``), rtol = atol = 1e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import hints  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train import sharding, spmd  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small torch ops: beside pytest-xdist's other workers, torch's
    intra-op thread pools would oversubscribe the cores and spin (a file
    took 20x its time alone), so the module runs on one thread and
    restores the count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FAMILIES = ["qwen3-1.7b", "phi3.5-moe-42b-a6.6b", "grok-1-314b", "minicpm3-4b",
            "qwen2-vl-72b", "rwkv6-3b", "hymba-1.5b", "whisper-base"]
MESHES = {"2x2": (2, 2), "2x2x2": (2, 2, 2)}
LAYOUTS = ["2d", "fsdp", "serve"]
B, S, NEW = 8, 16, 4
TOL = 1e-5


def mesh_of(shape, device="cpu"):
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return mesh_lib.DeviceMesh(names, shape, [device] * int(np.prod(shape)))


def f32(arch):
    return dataclasses.replace(get_config(arch, smoke=True), compute_dtype="float32")


def inputs_for(cfg, batch, seed=1, device="cpu"):
    return {k: v.to(device) for k, v in _inputs_for(cfg, batch, seed).items()}


def _inputs_for(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, size=(batch, S),
                                                   dtype=np.int32))}
    if cfg.mrope_sections is not None:
        out["mrope_pos"] = torch.arange(S, dtype=torch.int32)[None, None].expand(
            3, batch, S).contiguous()
    if cfg.family == "encdec":
        out["enc_frames"] = torch.from_numpy(
            rng.standard_normal((batch, cfg.enc_ctx, cfg.d_model)).astype(np.float32))
    return out


def placed_params(cfg, mesh, params, layout):
    return spmd._tree_map2(sharding.shard, params,
                           sharding.param_shardings(cfg, mesh, params, layout))


def leaves(tree, prefix=""):
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out += leaves(tree[k], f"{prefix}{k}/")
        else:
            out.append((prefix + k, tree[k]))
    return out


def assert_cache_close(got, want, tol=TOL):
    got, want = leaves(got), leaves(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, st), (_, w) in zip(got, want):
        assert isinstance(st, sharding.ShardedTensor), path
        np.testing.assert_allclose(st.full("cpu").float().numpy(), w.float().cpu().numpy(),
                                   rtol=tol, atol=tol, err_msg=path)


def assert_blocks(cache, cfg, mesh, layout):
    """Each leaf laid out by ``cache_specs``, every position holding exactly
    its block in storage of its own."""
    like = M.init_cache(cfg, cache_batch(cache), cache_seq(cache), device="meta")
    specs = dict(leaves(sharding.cache_specs(cfg, mesh, like, layout)))
    for path, st in leaves(cache):
        assert tuple(st.placement.spec) == tuple(specs[path]), path
        for block, shard, dev in zip(st.blocks(), st.shards, mesh.flat):
            assert tuple(shard.shape) == tuple(b.stop - b.start for b in block), path
            assert shard.device == dev
            assert shard.untyped_storage().nbytes() == shard.numel() * shard.element_size()


def cache_batch(cache):
    return leaves(cache)[0][1].shape[1]


def cache_seq(cache):
    got = dict(leaves(cache))
    for key in ("k", "c"):
        if key in got:
            return got[key].shape[2]
    return S + NEW


def serve_both(cfg, mesh, layout, batch=B, new=NEW, device="cpu"):
    """Prefill then ``new`` greedy decode steps, one device and sharded, from
    the same weights and prompt. Returns the (one-device, sharded) results
    and the two steps."""
    params = M.init(0, cfg, device=device)
    inputs = inputs_for(cfg, batch, device=device)
    extra = {k: v for k, v in inputs.items() if k != "tokens"}
    sp = placed_params(cfg, mesh, params, layout)
    with hints.hints_installed({}):
        sharding.set_activation_hints(mesh, batch=batch, layout=layout)
        prefill = spmd.build_sharded_prefill_step(cfg, mesh, layout)
        serve = spmd.build_sharded_serve_step(cfg, mesh, layout)
        want_logits, want_cache = M.prefill(params, cfg, inputs["tokens"], **extra)
        want_cache = M.extend_cache(want_cache, S + new)
        logits, cache = prefill(sp, inputs, S + new)
        steps_ = [(want_logits.cpu(), logits.full("cpu"), None, None)]
        token = torch.argmax(want_logits, -1).to(torch.int32)[:, None]
        got_token = token
        for i in range(new):
            w, want_cache = M.decode_step(params, cfg, want_cache, token, S + i)
            got_token, g, cache = serve(sp, cache, got_token, S + i)
            token = torch.argmax(w, -1).to(torch.int32)[:, None]
            steps_.append((w.cpu(), g.full("cpu"), token.cpu(), got_token.full("cpu")))
    return steps_, want_cache, cache, prefill, serve


CASES = [(a, m, lay) for a in FAMILIES for m in MESHES for lay in LAYOUTS]


@pytest.mark.parametrize("arch,mesh,layout", CASES)
def test_sharded_serving_matches_one_device(arch, mesh, layout):
    cfg = f32(arch)
    m = mesh_of(MESHES[mesh])
    steps_, want_cache, cache, _, _ = serve_both(cfg, m, layout)
    for i, (want, got, token, got_token) in enumerate(steps_):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=f"logits at step {i}")
        if token is not None:
            assert torch.equal(got_token, token), f"greedy token at step {i}"
    assert_cache_close(cache, want_cache)
    assert_blocks(cache, cfg, m, layout)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["rwkv6-3b", "hymba-1.5b"])
def test_batch_one_splits_the_sequence_over_the_mesh(arch, mesh, layout):
    """Batch 1 (long_500k's rule): the batch stays whole and K/V split their
    sequence over every axis of the mesh; the SSM state splits on heads."""
    cfg = f32(arch)
    m = mesh_of(MESHES[mesh])
    new = 8                                    # a horizon of 24 splits 4 and 8 ways
    steps_, want_cache, cache, _, _ = serve_both(cfg, m, layout, batch=1, new=new)
    for want, got, token, got_token in steps_:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
        if token is not None:
            assert torch.equal(got_token, token)
    assert_cache_close(cache, want_cache)
    assert_blocks(cache, cfg, m, layout)
    for path, st in leaves(cache):
        spec = st.placement.spec
        assert spec[1] is None, path                       # batch whole
        if path.split("/")[-1] in ("k", "v"):
            assert sharding.spec_axes(spec[2]) == m.axis_names, path
        if path.endswith("state") and layout != "fsdp":
            assert spec[2] == "model", path


def test_ledger_shows_the_sequence_split_serving():
    cfg = f32("qwen3-1.7b")
    m = mesh_of((2, 2))
    _, _, cache, prefill, serve = serve_both(cfg, m, "2d", new=2)   # 18 positions, 9 a block
    kv = dict(leaves(cache))["k"]
    assert kv.placement.spec[2] == "model" and kv.placement.spec[3] is None
    # the last serve step: q/k/v gathered over model, the softmax combined
    ops = [r.op for r in serve.ledger.records]
    gathered = [r for r in serve.ledger.records if r.op == "all-gather" and len(r.shape) == 4
                and r.shape[1] == 1]
    assert len(gathered) == 3 * cfg.n_layers
    assert ops.count("all-reduce") >= 3 * cfg.n_layers
    # the prefill moved K/V from heads to the sequence by an all-to-all
    moved = [r for r in prefill.ledger.records if r.op == "all-to-all"]
    assert len(moved) == 2 * cfg.n_layers
    assert all(r.shape[1] == (S + 2) // 2 for r in moved)


def test_new_token_written_by_its_owner_only():
    """A decode step writes K/V at ``pos`` in the one sequence block that
    holds it; every other block is as the prefill left it."""
    cfg = f32("qwen3-1.7b")
    m = mesh_of((2, 2))
    params = M.init(0, cfg, device="cpu")
    sp = placed_params(cfg, m, params, "2d")
    with hints.hints_installed({}):
        sharding.set_activation_hints(m, batch=B, layout="2d")
        logits, cache = spmd.build_sharded_prefill_step(cfg, m, "2d")(
            sp, inputs_for(cfg, B), S + NEW)
        before = [s.clone() for s in cache["k"].shards]
        token = torch.zeros((B, 1), dtype=torch.int32)
        spmd.build_sharded_serve_step(cfg, m, "2d")(sp, cache, token, S)
    half = (S + NEW) // 2                      # each model position's block of the sequence
    grid = spmd.Grid(m)
    for c, (old, new) in enumerate(zip(before, cache["k"].shards)):
        changed = (old != new).permute(2, 0, 1, 3, 4).reshape(old.shape[2], -1).any(-1)
        owner = grid.rank(c, ("model",)) == S // half
        assert changed.nonzero().flatten().tolist() == ([S - half] if owner else [])


try:  # the reference
    import jax

    from repro.configs import get_config as jget_config
    from repro.models import model as JM
except ImportError:
    jax = None


def test_sharded_serving_matches_jax_reference():
    if jax is None:
        pytest.skip("the JAX reference package is not installed")
    import jax.numpy as jnp
    arch = "qwen3-1.7b"
    cfg = f32(arch)
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), compute_dtype="float32")
    jparams = jax.tree.map(np.asarray, jax.device_get(JM.init(jax.random.PRNGKey(0), jcfg)))
    params = M.params_from_jax(jparams, device="cpu")
    m = mesh_of((2, 2))
    sp = placed_params(cfg, m, params, "serve")
    toks = inputs_for(cfg, B)["tokens"]
    with hints.hints_installed({}):
        sharding.set_activation_hints(m, batch=B, layout="serve")
        logits, cache = spmd.build_sharded_prefill_step(cfg, m, "serve")(
            sp, {"tokens": toks}, S + NEW)
        serve = spmd.build_sharded_serve_step(cfg, m, "serve")
        jl, jc = JM.prefill(jparams, jcfg, jnp.asarray(toks.numpy()))
        jc = JM.extend_cache(jc, S + NEW)
        np.testing.assert_allclose(logits.full("cpu").numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        token = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
        got_token = torch.from_numpy(np.asarray(token))
        for i in range(NEW):
            jl, jc = JM.decode_step(jparams, jcfg, jc, token, jnp.int32(S + i))
            got_token, got, cache = serve(sp, cache, got_token, S + i)
            np.testing.assert_allclose(got.full("cpu").numpy(), np.asarray(jl), rtol=1e-4,
                                       atol=1e-4)
            token = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
            assert np.array_equal(got_token.full("cpu").numpy(), np.asarray(token))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["2d", "serve"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "minicpm3-4b", "hymba-1.5b", "whisper-base"])
def test_sharded_serving_on_one_card(arch, layout):
    """Sharded prefill and decode on a 2 x 2 mesh of [cuda:0] * 4 against the
    one-device model on the card, float32 with TF32 off: the same greedy
    tokens, logits and caches within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = f32(arch)
        m = mesh_of((2, 2), "cuda:0")
        steps_, want_cache, cache, _, _ = serve_both(cfg, m, layout, device="cuda")
        for i, (want, got, token, got_token) in enumerate(steps_):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=f"logits at step {i}")
            if token is not None:
                assert torch.equal(got_token, token), f"greedy token at step {i}"
        assert_cache_close(cache, want_cache, tol=1e-4)
        assert_blocks(cache, cfg, m, layout)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
