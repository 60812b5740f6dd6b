"""Sharding rules of the PyTorch port (``train.sharding``) against the JAX
package's (``repro.train.sharding``).

For all ten configs on the two production mesh shapes (16x16 and
2x16x16, fake meshes: no devices), every leaf's spec from ``param_specs``,
``opt_specs``, ``state_specs``, ``cache_specs`` and ``batch_specs`` (and
the decode / prefill input specs) equals the JAX package's, converted to a
``PartitionSpec``; the port's trees come from its ``meta``-device ``init``
/ ``init_cache``, the JAX package's from ``jax.eval_shape``. The four
invariants of ``tests/test_sharding_rules.py`` hold on the port's specs,
and ``state_shardings`` / ``shard`` lay a tensor out over a mesh.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import sharding  # noqa: E402

try:  # the reference
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config as jget_config
    from repro.models import model as JM
    from repro.optim import adamw as jadamw
    from repro.train import sharding as jsharding
except ImportError:
    jax = None


@pytest.fixture(autouse=True)
def _reference():
    if jax is None:
        pytest.skip("the JAX reference package is not installed")


class FakeMesh:
    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.size = int(np.prod(list(shape.values())))


MESHES = [FakeMesh({"data": 16, "model": 16}),
          FakeMesh({"pod": 2, "data": 16, "model": 16})]
MESH_IDS = ["16x16", "2x16x16"]
LAYOUTS = ["2d", "fsdp", "serve"]


def flat_specs(tree, path=()):
    """{path: spec} of a port spec tree (dicts of ``Spec``s)."""
    if isinstance(tree, dict):
        return {p: s for k, v in tree.items() for p, s in flat_specs(v, path + (k,)).items()}
    assert isinstance(tree, sharding.Spec), (path, tree)
    return {"/".join(path): tree}


def flat_jax(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(getattr(e, "key", e)) for e in path): spec for path, spec in leaves}


def assert_same_specs(got, want):
    got, want = flat_specs(got), flat_jax(want)
    assert sorted(got) == sorted(want)
    bad = {p: (got[p], want[p]) for p in want if P(*got[p]) != want[p]}
    assert bad == {}


def shapes(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    return (cfg, jcfg, M.init(0, cfg, device="meta"),
            jax.eval_shape(lambda: JM.init(jax.random.PRNGKey(0), jcfg)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_param_opt_state_specs_equal_reference(arch, mesh):
    cfg, jcfg, params, jparams = shapes(arch)
    for layout in LAYOUTS:
        pspecs = sharding.param_specs(cfg, mesh, params, layout)
        assert_same_specs(pspecs, jsharding.param_specs(jcfg, mesh, jparams, layout))
    ocfg, jocfg = adamw.OptConfig(compress_grads=True), jadamw.OptConfig(compress_grads=True)
    pspecs = sharding.param_specs(cfg, mesh, params)
    jpspecs = jsharding.param_specs(jcfg, mesh, jparams)
    assert_same_specs(sharding.opt_specs(cfg, mesh, pspecs, ocfg),
                      jsharding.opt_specs(jcfg, mesh, jpspecs, jocfg))
    state = {"params": params, "opt": adamw.init_opt(params, adamw.OptConfig()),
             "step": torch.zeros((), dtype=torch.int64, device="meta")}
    jstate = {"params": jparams}
    assert_same_specs(sharding.state_specs(cfg, mesh, state),
                      jsharding.state_specs(jcfg, mesh, jstate))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_cache_batch_input_specs_equal_reference(arch, mesh):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for batch, seq in ((128, 1024), (1, 4096)):
        cache = M.init_cache(cfg, batch, seq, device="meta")
        jcache = jax.eval_shape(lambda: JM.init_cache(jcfg, batch, seq))
        for layout in LAYOUTS:
            assert_same_specs(sharding.cache_specs(cfg, mesh, cache, layout),
                              jsharding.cache_specs(jcfg, mesh, jcache, layout))
    for layout in LAYOUTS:
        assert_same_specs(sharding.batch_specs(cfg, mesh, layout),
                          jsharding.batch_specs(jcfg, mesh, layout))
        for batch in (None, 1, 256):
            assert_same_specs(sharding.decode_input_specs(cfg, mesh, batch, layout),
                              jsharding.decode_input_specs(jcfg, mesh, batch, layout))
            assert_same_specs(sharding.prefill_input_specs(cfg, mesh, batch, layout),
                              jsharding.prefill_input_specs(jcfg, mesh, batch, layout))


def test_layer_param_specs_equal_reference():
    cfg, jcfg, params, jparams = shapes("qwen3-1.7b")
    layer = {k: v for k, v in params["layers"].items()}
    one = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape[1:], a.dtype), jparams["layers"])
    from repro_torch.models import transformer
    assert_same_specs(sharding.layer_param_specs(cfg, MESHES[0], transformer.layer_slice(layer, 0)),
                      jsharding.layer_param_specs(jcfg, MESHES[0], one))


# -- the invariants of tests/test_sharding_rules.py, on the port's specs ----------


def axis_size(mesh, axes):
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(np.prod([mesh.shape[a] for a in axes]))


def leaves_with_specs(tree, specs, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from leaves_with_specs(tree[k], specs[k], path + (k,))
    else:
        yield "/".join(path), tree, specs


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_param_specs_divisible_and_distinct(arch, mesh):
    cfg = get_config(arch)
    params = M.init(0, cfg, device="meta")
    for path, leaf, spec in leaves_with_specs(params, sharding.param_specs(cfg, mesh, params)):
        assert isinstance(spec, sharding.Spec) and len(spec) == leaf.dim(), (path, spec)
        used = []
        for dim, axes in zip(leaf.shape, spec):
            assert dim % axis_size(mesh, axes) == 0, (path, tuple(leaf.shape), spec)
            if axes is not None:
                used.extend([axes] if isinstance(axes, str) else list(axes))
        assert len(used) == len(set(used)), f"axis reused: {path} {spec}"


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_fsdp_shards_most_params(mesh):
    cfg = get_config("qwen3-4b")
    params = M.init(0, cfg, device="meta")
    total = sharded = 0
    for _, leaf, spec in leaves_with_specs(params, sharding.param_specs(cfg, mesh, params)):
        n = leaf.numel()
        total += n
        sharded += n // int(np.prod([axis_size(mesh, a) for a in spec]))
    assert sharded <= total * 3 // mesh.size + total // 100


@pytest.mark.parametrize("arch", ["qwen3-4b", "rwkv6-3b", "hymba-1.5b", "minicpm3-4b",
                                  "whisper-base"])
def test_cache_specs_match_cache_tree(arch):
    cfg = get_config(arch)
    cache = M.init_cache(cfg, 128, 1024, device="meta")
    for path, leaf, spec in leaves_with_specs(cache, sharding.cache_specs(cfg, MESHES[0], cache)):
        assert len(spec) == leaf.dim(), (path, spec)
        for dim, axes in zip(leaf.shape, spec):
            assert dim % axis_size(MESHES[0], axes) == 0, (path, spec, tuple(leaf.shape))


def test_opt_specs_mirror_params():
    cfg = get_config("qwen3-1.7b")
    params = M.init(0, cfg, device="meta")
    pspecs = sharding.param_specs(cfg, MESHES[0], params)
    ospecs = sharding.opt_specs(cfg, MESHES[0], pspecs)
    assert ospecs["m"] is pspecs and ospecs["v"] is pspecs
    assert ospecs["count"] == sharding.Spec() and P(*ospecs["count"]) == P()


# -- placements -------------------------------------------------------------------


def test_state_shardings_place_every_leaf():
    cfg = get_config("qwen3-1.7b", smoke=True)
    mesh = mesh_lib.make_local_mesh(2, 2, devices=["cpu"] * 4)
    params = M.init(0, cfg, device="cpu")
    state = {"params": params, "opt": adamw.init_opt(params, adamw.OptConfig()),
             "step": torch.zeros((), dtype=torch.int64)}
    placements = sharding.state_shardings(cfg, mesh, state)
    specs = sharding.state_specs(cfg, mesh, state)
    for (path, leaf, pl), (_, _, spec) in zip(leaves_with_specs(state, placements),
                                              leaves_with_specs(state, specs)):
        assert pl == sharding.Placement(mesh, spec)
        st = sharding.shard(leaf, pl)
        assert len(st.shards) == 4 and torch.equal(st.full(), leaf), path


@pytest.mark.parametrize("spec,blocks", [
    (("data", "model"), [(4, 3)] * 4), (("model", None), [(4, 6)] * 4),
    ((("data", "model"), None), [(2, 6)] * 4), ((), [(8, 6)] * 4)])
def test_shard_blocks_follow_the_spec(spec, blocks):
    mesh = mesh_lib.make_local_mesh(2, 2, devices=["cpu"] * 4)
    x = torch.arange(48, dtype=torch.float32).reshape(8, 6)
    st = sharding.shard(x, sharding.Placement(mesh, sharding.Spec(*spec)))
    assert [tuple(s.shape) for s in st.shards] == blocks
    assert torch.equal(st.full(), x)
    if spec == (("data", "model"), None):   # data-major: device (d, m) holds part 2d + m
        assert [int(s[0, 0]) for s in st.shards] == [0, 12, 24, 36]
    with pytest.raises(ValueError, match="split"):
        sharding.shard(torch.zeros(3, 6), sharding.Placement(mesh, sharding.Spec("data")))
