"""Training over a device mesh on the PyTorch port (``train/spmd.py``,
``sharding.set_activation_hints`` / ``param_shardings``,
``adamw.apply_update_sharded``, ``run_training(mesh=)``), on the CPU.

* The sharded step against the port's one-device step from the same weights
  and numpy batch, for one config of each family (qwen3, phi3.5-moe, grok,
  minicpm3 (MLA), qwen2-vl (M-RoPE), rwkv6, hymba, whisper) on (1,2), (2,1),
  (2,2) and (2,2,2) meshes of ``["cpu"] * n`` in the ``2d`` and ``fsdp``
  layouts (and grok's 2 experts on a 4-wide ``model`` axis: TP within each
  expert): loss and gradient norm of both steps and the parameters after
  them within 1e-5, float32 compute. The same against the JAX package's
  step within its rtol = atol = 1e-4.
* Each mesh position holds exactly its spec's block of every leaf, in
  storage of its own.
* ``run_training(mesh=)`` trains every family on (2,2) and (2,2,2) meshes in
  both layouts, its history and parameters within 1e-5 of the one-device run.
* ``apply_update_sharded`` on the blocks of the same gradients equals
  ``apply_update`` (with and without int8 compression): the global norm
  counts each element once, the int8 scale is the whole leaf's max.
* ``set_activation_hints`` / ``param_shardings`` give the JAX package's
  specs (on abstract meshes).
* The collectives' autograd (an all-gather's backward is a reduce-scatter,
  an all-reduce's an all-reduce) and ``Dist.constrain``.
* A device-direct checkpoint saved from a 2 x 2 mesh writes the files of
  the same state saved whole; a run resumed onto 1 x 2 restores the state
  bit for bit and continues the unbroken run's losses.
* On the card (``gpu``): the sharded step on ``[cuda:0] * 4`` against one
  device; ``across``: qwen3-1.7b at full width on a 2 x 2 mesh of four cards.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import hints  # noqa: E402
from repro_torch.checkpoint import devio  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline as data_lib  # noqa: E402
from repro_torch.launch.train import run_training  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import sharding, spmd, steps  # noqa: E402


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
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2), "2x2x2": (2, 2, 2), "1x4": (1, 4)}
B, S = 8, 16
TOL = 1e-5


def mesh_of(shape, device="cpu"):
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return mesh_lib.DeviceMesh(names, shape, [device] * int(np.prod(shape)))


def f32(arch):
    return dataclasses.replace(get_config(arch, smoke=True), compute_dtype="float32")


def np_batch(cfg, seed):
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


def to_torch(batch, device="cpu"):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def placed(cfg, mesh, params, ocfg, layout):
    opt = adamw.init_opt(params, ocfg)
    like = {"params": params, "opt": opt, "step": np.int64(0)}
    sh = sharding.state_shardings(cfg, mesh, like, ocfg, layout)
    return devio.place(params, sh["params"]), devio.place(opt, sh["opt"])


def assert_blocks(tree):
    """Every position holds exactly its spec's block, in storage of its own."""
    for (st,) in adamw._zip(tree):
        assert isinstance(st, sharding.ShardedTensor)
        for block, shard, dev in zip(st.blocks(), st.shards, st.placement.mesh.flat):
            want = tuple(b.stop - b.start for b in block)
            assert tuple(shard.shape) == want and shard.device == dev
            assert shard.untyped_storage().nbytes() == shard.numel() * shard.element_size()


def assert_params_close(one, sharded, tol=TOL):
    for (a,), (st,) in zip(adamw._zip(one), adamw._zip(sharded)):
        np.testing.assert_allclose(st.full("cpu").numpy(), a.detach().cpu().numpy(),
                                   rtol=tol, atol=tol)


def two_steps(cfg, mesh, layout, ocfg=None, seq_shard=False):
    """Two steps of the one-device step and of the sharded step from the
    same weights and batches: (one-device metrics, sharded metrics, params,
    sharded params, sharded opt, the sharded step)."""
    ocfg = ocfg or adamw.OptConfig(total_steps=10, warmup_steps=2)
    params = M.init(0, cfg, device="cpu")
    sp, so = placed(cfg, mesh, params, ocfg, layout)
    opt = adamw.init_opt(params, ocfg)
    one = steps.build_train_step(cfg, ocfg)
    sharded = spmd.build_sharded_train_step(cfg, ocfg, mesh, layout)
    m1s, m2s = [], []
    with hints.hints_installed({}):
        sharding.set_activation_hints(mesh, batch=B, layout=layout, seq_shard=seq_shard)
        for seed in (1, 2):
            b = to_torch(np_batch(cfg, seed))
            params, opt, m1 = one(params, opt, b)
            sp, so, m2 = sharded(sp, so, b)
            m1s.append(m1)
            m2s.append(m2)
    return m1s, m2s, params, sp, so, sharded


CASES = [(a, m, lay) for a in FAMILIES for m in ("1x2", "2x1", "2x2", "2x2x2")
         for lay in ("2d", "fsdp")] + [("grok-1-314b", "1x4", "2d")]


@pytest.mark.parametrize("arch,mesh,layout", CASES)
def test_sharded_step_matches_one_device(arch, mesh, layout):
    cfg = f32(arch)
    m = mesh_of(MESHES[mesh])
    m1s, m2s, params, sp, so, step = two_steps(cfg, m, layout)
    for m1, m2 in zip(m1s, m2s):
        assert sorted(m1) == sorted(m2)
        for key in m1:
            np.testing.assert_allclose(float(m2[key]), float(m1[key]), rtol=TOL, atol=TOL,
                                       err_msg=key)
    assert_params_close(params, sp)
    assert_blocks(sp)
    assert_blocks(so["m"])
    assert int(so["count"].shards[-1]) == 2
    if m.size > 1:
        assert step.ledger.records    # the collectives of the last step


@pytest.mark.parametrize("mesh,layout", [("2x2", "2d"), ("2x2x2", "fsdp")])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "phi3.5-moe-42b-a6.6b", "rwkv6-3b",
                                  "whisper-base"])
def test_remat_step_matches_one_device(arch, mesh, layout):
    """With ``cfg.remat`` each sharded layer keeps only its inputs and is
    recomputed in the backward (its gathers run again: the ledger holds
    more all-gathers than without); the step is still the one-device
    step's, which recomputes through ``torch.utils.checkpoint``."""
    cfg = dataclasses.replace(f32(arch), remat=True)
    m = mesh_of(MESHES[mesh])
    m1s, m2s, params, sp, _, step = two_steps(cfg, m, layout)
    for m1, m2 in zip(m1s, m2s):
        for key in m1:
            np.testing.assert_allclose(float(m2[key]), float(m1[key]), rtol=TOL, atol=TOL,
                                       err_msg=key)
    assert_params_close(params, sp)
    gathers = sum(r.op == "all-gather" for r in step.ledger.records)
    _, _, _, _, _, plain = two_steps(dataclasses.replace(cfg, remat=False), m, layout)
    assert gathers > sum(r.op == "all-gather" for r in plain.ledger.records)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "phi3.5-moe-42b-a6.6b", "hymba-1.5b",
                                  "whisper-base"])
def test_sequence_parallel_hints(arch):
    """With ``seq_shard`` the "act" hint splits S over ``model`` between
    layers; each sublayer gathers S back (the ledger's extra all-gathers)
    and the step stays the one-device step's."""
    cfg = f32(arch)
    m1s, m2s, params, sp, _, step = two_steps(cfg, mesh_of((2, 2)), "2d", seq_shard=True)
    for m1, m2 in zip(m1s, m2s):
        for key in m1:
            np.testing.assert_allclose(float(m2[key]), float(m1[key]), rtol=TOL, atol=TOL,
                                       err_msg=key)
    assert_params_close(params, sp)
    seq = [r for r in step.ledger.records if r.op == "all-gather" and r.shape[:2] == (B // 2, S)]
    assert seq


def test_tensor_parallel_plans():
    """Which sublayers run tensor parallel on a 2-wide ``model`` axis, and
    that an uneven head count (hymba's 25) or grok's 2 experts on 4 fall
    back to gathering / TP within the experts."""
    mesh = mesh_of((1, 2))
    plan = spmd.ShardedModel(f32("qwen3-1.7b"), mesh)
    assert plan.attn_tp and plan.mlp_tp and plan.cfg_attn.n_heads == 2
    moe = spmd.ShardedModel(f32("phi3.5-moe-42b-a6.6b"), mesh)
    assert moe.moe_ep and not moe.moe_tp
    grok = spmd.ShardedModel(f32("grok-1-314b"), mesh_of((1, 4)))
    assert grok.moe_tp and not grok.moe_ep
    hymba = spmd.ShardedModel(get_config("hymba-1.5b"), mesh)
    assert not hymba.attn_tp and hymba.mlp_tp       # 25 heads on 2
    fsdp = spmd.ShardedModel(f32("qwen3-1.7b"), mesh, layout="fsdp")
    assert not (fsdp.attn_tp or fsdp.mlp_tp)


def test_run_training_mesh_needs_its_devices():
    cfg = get_config("qwen3-1.7b", smoke=True)
    d = data_lib.DataConfig(vocab=cfg.vocab, seq=8, global_batch=4)
    with pytest.raises(ValueError, match="either mesh or device"):
        run_training(cfg, adamw.OptConfig(), d, 1, mesh=mesh_of((1, 2)), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_training(cfg, adamw.OptConfig(), d, 1, mesh=mesh_of((1, 2), "cuda"))


# -- the optimizer on blocks -------------------------------------------------


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("layout", ["2d", "fsdp"])
def test_apply_update_sharded_equals_whole(compress, layout):
    """The same gradients, whole and as the blocks of the state's layout
    (every copy of a replicated block holding the whole gradient): the
    updated parameters, moments, residuals and norm agree."""
    cfg = f32("phi3.5-moe-42b-a6.6b")
    mesh = mesh_of((2, 2))
    ocfg = adamw.OptConfig(total_steps=10, warmup_steps=2, compress_grads=compress,
                           clip_norm=0.5)
    params = M.init(0, cfg, device="cpu")
    gen = torch.Generator().manual_seed(5)
    grads = M._map(lambda p: torch.randn(p.shape, generator=gen) * 0.3, params)
    sp, so = placed(cfg, mesh, params, ocfg, layout)
    opt = adamw.init_opt(params, ocfg)
    grid = spmd.Grid(mesh)
    gblocks = _zip_map(lambda g, st: [g[b].clone() for b in st.blocks()], grads, sp)
    for _ in range(2):
        params, opt, om = adamw.apply_update(params, grads, opt, ocfg)
        sp, so, sm = adamw.apply_update_sharded(sp, gblocks, so, ocfg, grid)
        np.testing.assert_allclose(float(sm["grad_norm"]), float(om["grad_norm"]), rtol=1e-6)
    assert_params_close(params, sp, tol=1e-6)
    assert_params_close(opt["v"], so["v"], tol=1e-6)
    if compress:
        assert_params_close(opt["err"], so["err"], tol=1e-6)
        assert any(r.op == "all-reduce" for r in grid.ledger.records)


def _zip_map(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, tree[k], other[k]) for k in tree}
    return fn(tree, other)


def test_compressed_grads_step():
    """int8 error feedback over a mesh: the first step's loss and norm equal
    the one-device step's; rounding to int8 is discontinuous, so a gradient
    element whose reduction order moves it across a rounding boundary gets
    another quantum, and only such elements may part."""
    cfg = f32("qwen3-1.7b")
    ocfg = adamw.OptConfig(total_steps=10, warmup_steps=2, compress_grads=True)
    m1s, m2s, params, sp, so, _ = two_steps(cfg, mesh_of((2, 2)), "2d", ocfg)
    np.testing.assert_allclose(float(m2s[0]["loss"]), float(m1s[0]["loss"]), rtol=TOL)
    np.testing.assert_allclose(float(m2s[1]["loss"]), float(m1s[1]["loss"]), rtol=1e-4)
    diffs = np.concatenate([np.abs(st.full().numpy() - a.detach().numpy()).ravel()
                            for (a,), (st,) in zip(adamw._zip(params), adamw._zip(sp))])
    assert np.mean(diffs > TOL) < 1e-3
    assert sorted(so) == ["count", "err", "m", "v"]
    assert_blocks(so["err"])


# -- collectives and activations ---------------------------------------------


def test_collectives_are_exact_transposes():
    """all_gather / reduce_scatter / all_reduce against their dense
    definitions, forward and backward, on a 2 x 2 x 2 mesh; the ledger
    records each call with its output shape and group size."""
    grid = spmd.Grid(mesh_of((2, 2, 2)))
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn(2, 3, generator=gen, requires_grad=True) for _ in range(grid.n)]
    axes = ("data", "model")
    out = grid.all_gather(xs, axes, 1)
    assert [tuple(o.shape) for o in out] == [(2, 12)] * 8
    for grp in grid.groups(axes):
        whole = torch.cat([xs[q] for q in grp], 1)
        for q in grp:
            assert torch.equal(out[q], whole)
    ws = [torch.randn(2, 12, generator=gen) for _ in range(grid.n)]
    sum(torch.sum(o * w) for o, w in zip(out, ws)).backward()
    for grp in grid.groups(axes):
        total = sum(ws[q] for q in grp)
        for i, q in enumerate(grp):
            torch.testing.assert_close(xs[q].grad, total[:, 3 * i:3 * i + 3])
    ys = [x.detach().clone().requires_grad_(True) for x in xs]
    red = grid.all_reduce(ys, ("pod",))
    sum(torch.sum(r * (i + 1)) for i, r in enumerate(red)).backward()
    for grp in grid.groups(("pod",)):
        for q in grp:
            torch.testing.assert_close(red[q], sum(ys[p] for p in grp).detach())
            torch.testing.assert_close(ys[q].grad, torch.full((2, 3), float(sum(p + 1 for p in grp))))
    ops = [(r.op, r.shape, r.group) for r in grid.ledger.records]
    assert ops == [("all-gather", (2, 12), 4), ("reduce-scatter", (2, 3), 4),
                   ("all-reduce", (2, 3), 2), ("all-reduce", (2, 3), 2)]
    zs = [torch.randn(4, 2, generator=gen, requires_grad=True) for _ in range(grid.n)]
    sc = grid.reduce_scatter(zs, ("model",), 0)
    assert [tuple(s.shape) for s in sc] == [(2, 2)] * 8
    for grp in grid.groups(("model",)):
        total = sum(zs[q] for q in grp).detach()
        for i, q in enumerate(grp):
            torch.testing.assert_close(sc[q], total[2 * i:2 * i + 2])
    mx = grid.all_max([torch.tensor(float(c)) for c in range(grid.n)], grid.names)
    assert [float(m) for m in mx] == [7.0] * 8


def test_dist_constrain_slices_and_gathers():
    grid = spmd.Grid(mesh_of((2, 2)))
    x = torch.arange(4 * 6 * 2, dtype=torch.float32).reshape(4, 6, 2)
    d = spmd.distribute(grid, x, sharding.Spec(("data",), None, None))
    seq = d.constrain(sharding.Spec(("data",), "model", None))
    assert [tuple(b.shape) for b in seq.blocks] == [(2, 3, 2)] * 4
    assert torch.equal(seq.blocks[3], x[2:, 3:])            # (data 1, model 1)
    whole = seq.constrain(sharding.Spec(None, None, None))
    assert all(torch.equal(b, x) for b in whole.blocks)
    odd = d.constrain(sharding.Spec(("data",), None, "model"))   # 2 splits 2: sliced
    assert tuple(odd.blocks[1].shape) == (2, 6, 1)
    three = spmd.distribute(grid, torch.zeros(2, 3), sharding.Spec(("data",), None))
    assert tuple(three.constrain(sharding.Spec(("data",), "model")).blocks[0].shape) == (1, 3)


# -- on the card ---------------------------------------------------------------


def _cuda_or_skip(n=1):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices, have {torch.cuda.device_count()}")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "phi3.5-moe-42b-a6.6b", "whisper-base"])
def test_sharded_step_on_one_card(arch):
    """The sharded step on a 2 x 2 mesh of [cuda:0] * 4 against the one-device
    step on the card, float32 with TF32 off."""
    _cuda_or_skip()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = f32(arch)
        mesh = mesh_of((2, 2), "cuda:0")
        ocfg = adamw.OptConfig(total_steps=10, warmup_steps=2)
        params = M.init(0, cfg, device="cuda")
        sp, so = placed(cfg, mesh, params, ocfg, "2d")
        opt = adamw.init_opt(params, ocfg)
        one = steps.build_train_step(cfg, ocfg)
        sharded = spmd.build_sharded_train_step(cfg, ocfg, mesh)
        for seed in (1, 2):
            b = to_torch(np_batch(cfg, seed), "cuda")
            params, opt, m1 = one(params, opt, b)
            sp, so, m2 = sharded(sp, so, b)
            for key in m1:
                np.testing.assert_allclose(float(m2[key]), float(m1[key]), rtol=1e-4,
                                           atol=1e-4, err_msg=key)
        assert_params_close(params, sp, tol=1e-4)
        assert all(s.device.type == "cuda" for (st,) in adamw._zip(sp) for s in st.shards)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.gpu
def test_across_qwen3_full_width_on_four_cards():
    """qwen3-1.7b at full width on a 2 x 2 mesh of four cards for 2 steps,
    held against the same run on a 2 x 2 mesh of one card; each card's peak
    is reported."""
    _cuda_or_skip(4)
    cfg = get_config("qwen3-1.7b")
    ocfg = adamw.OptConfig(peak_lr=3e-4, warmup_steps=5, total_steps=6)
    dcfg = data_lib.DataConfig(vocab=cfg.vocab, seq=128, global_batch=8, seed=0)
    q = dict(log_every=1, log=lambda *_: None)
    torch.cuda.reset_peak_memory_stats(0)
    one_card = run_training(cfg, ocfg, dcfg, 2, mesh=mesh_of((2, 2), "cuda:0"), **q)
    one_peak = torch.cuda.max_memory_allocated(0) / 2**30
    want = [h["loss"] for h in one_card["history"]]
    del one_card
    torch.cuda.empty_cache()
    for i in range(4):
        torch.cuda.reset_peak_memory_stats(i)
    four = mesh_lib.DeviceMesh(("data", "model"), (2, 2), [f"cuda:{i}" for i in range(4)])
    got = run_training(cfg, ocfg, dcfg, 2, mesh=four, **q)
    peaks = [torch.cuda.max_memory_allocated(i) / 2**30 for i in range(4)]
    print(f"peak GiB per card {[round(p, 3) for p in peaks]} (one card: {one_peak:.3f}); "
          f"step walls {got['step_s']} s")
    losses = [h["loss"] for h in got["history"]]
    np.testing.assert_allclose(losses, want, rtol=1e-3)
    for (st,) in adamw._zip(got["params"]):
        assert [s.device for s in st.shards] == list(four.flat)
    # card 0 also holds the whole initial state while it is placed
    assert max(peaks[1:]) < 0.5 * one_peak
