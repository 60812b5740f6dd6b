"""The sharded train step and the mesh specs of the PyTorch port against the
JAX package, on the CPU: the sharded step (``train/spmd.py``) on a 2 x 2
mesh of ``["cpu"] * 4`` against ``repro.train.steps.build_train_step`` from
the same weights and numpy batch, one config of each family, within the
reference's rtol = atol = 1e-4 (float32 compute); ``set_activation_hints``
and ``param_shardings`` against the JAX package's on abstract meshes.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh
    from jax.sharding import PartitionSpec as P

    from repro import hints as jhints
    from repro.configs import get_config as jget_config
    from repro.models import model as JM
    from repro.optim import adamw as jadamw
    from repro.train import sharding as jsharding
    from repro.train import steps as jsteps
except ImportError as e:
    pytest.skip(f"the JAX reference is not importable: {e}", allow_module_level=True)

from repro_torch import hints  # noqa: E402
from repro_torch.checkpoint import devio  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
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
B, S = 8, 16
TOL = 1e-5


def mesh_of(shape, device="cpu"):
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return mesh_lib.DeviceMesh(names, shape, [device] * int(np.prod(shape)))


def f32(arch):
    return dataclasses.replace(get_config(arch, smoke=True), compute_dtype="float32")


def assert_blocks(tree):
    """Every position holds exactly its spec's block, in storage of its own."""
    for (st,) in adamw._zip(tree):
        assert isinstance(st, sharding.ShardedTensor)
        for block, shard, dev in zip(st.blocks(), st.shards, st.placement.mesh.flat):
            assert tuple(shard.shape) == tuple(b.stop - b.start for b in block)
            assert shard.device == dev
            assert shard.untyped_storage().nbytes() == shard.numel() * shard.element_size()


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


def to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def placed(cfg, mesh, params, ocfg, layout):
    opt = adamw.init_opt(params, ocfg)
    like = {"params": params, "opt": opt, "step": np.int64(0)}
    sh = sharding.state_shardings(cfg, mesh, like, ocfg, layout)
    return devio.place(params, sh["params"]), devio.place(opt, sh["opt"])


def assert_params_close(one, sharded, tol):
    for (a,), (st,) in zip(adamw._zip(one), adamw._zip(sharded)):
        np.testing.assert_allclose(st.full("cpu").numpy(), a.detach().cpu().numpy(),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_step_matches_jax(arch):
    cfg, jcfg = f32(arch), dataclasses.replace(jget_config(arch, smoke=True),
                                               compute_dtype="float32")
    ocfg = adamw.OptConfig(total_steps=10, warmup_steps=2)
    jocfg = jadamw.OptConfig(total_steps=10, warmup_steps=2)
    jp = jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(0), jcfg))
    jopt = jadamw.init_opt(jp, jocfg)
    jstep = jax.jit(jsteps.build_train_step(jcfg, jocfg))
    mesh = mesh_of((2, 2))
    sp, so = placed(cfg, mesh, M.params_from_jax(jp, device="cpu"), ocfg, "2d")
    sharded = spmd.build_sharded_train_step(cfg, ocfg, mesh)
    for seed in (1, 2):
        b = np_batch(cfg, seed)
        jp, jopt, jm = jstep(jp, jopt, jax.tree.map(jnp.asarray, b))
        sp, so, m = sharded(sp, so, to_torch(b))
        for key in ("loss", "ce", "z_loss", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4, atol=1e-4,
                                       err_msg=key)
    want = M.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    assert_params_close(want, sp, tol=1e-4)


# -- specs and hints against the JAX package ---------------------------------


HINT_CASES = [((2, 2), 8, False, "2d"), ((2, 2), 3, False, "2d"), ((2, 2), 8, True, "2d"),
              ((2, 2, 2), 8, True, "2d"), ((2, 2, 2), 8, False, "fsdp"),
              ((2, 2, 2), 2, True, "fsdp")]


@pytest.mark.parametrize("shape,batch,seq_shard,layout", HINT_CASES)
def test_activation_hints_equal_reference(shape, batch, seq_shard, layout):
    mesh = mesh_of(shape)
    names = mesh.axis_names
    old, jold = dict(hints._HINTS), dict(jhints._HINTS)
    try:
        sharding.set_activation_hints(mesh, batch=batch, seq_shard=seq_shard, layout=layout)
        jsharding.set_activation_hints(AbstractMesh(shape, names), batch=batch,
                                       seq_shard=seq_shard, layout=layout)
        got = {k: v.placement for k, v in hints._HINTS.items()}
        want = {k: v.spec for k, v in jhints._HINTS.items()}
    finally:
        hints.set_hints(old)
        jhints.set_hints(jold)
    assert sorted(got) == sorted(want) == ["act", "logits", "logits2d"]
    for site in got:
        assert got[site].mesh == mesh
        assert P(*got[site].spec) == want[site], site
    x = torch.ones(2, 3)
    assert sharding.ActivationHint(got["act"])(x) is x     # a one-device tensor passes


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("shape", [(2, 2), (2, 2, 2)])
def test_param_shardings_equal_reference(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    mesh = mesh_of(shape)
    got = sharding.param_shardings(cfg, mesh, M.init(0, cfg, device="meta"))
    want = jsharding.param_shardings(
        jcfg, AbstractMesh(shape, mesh.axis_names),
        jax.eval_shape(lambda: JM.init(jax.random.PRNGKey(0), jcfg)))
    flat_got = {"/".join(p): s for p, s in _flat(got)}
    flat_want = {"/".join(str(getattr(e, "key", e)) for e in path): s.spec
                 for path, s in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert sorted(flat_got) == sorted(flat_want)
    for path, pl in flat_got.items():
        assert isinstance(pl, sharding.Placement) and pl.mesh == mesh
        assert P(*pl.spec) == flat_want[path], path


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flat(v, path + (k,))]
    return [(path, tree)]
