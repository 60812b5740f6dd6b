"""Checkpointing in the PyTorch/CUDA port against the JAX package.

On the CPU (``device="cpu"``, the kernels' plain versions):

* the tree serializers (``storage.object_store``): the treedef string is
  jax's ``str(PyTreeDef)`` over a matrix of containers, ``tree_to_bytes``
  is the JAX package's byte for byte over containers x dtypes (bfloat16
  included, through torch), leaves round-trip in their template's kind, and
  corrupt blobs raise the same ``ValueError``s;
* ``devio.state_layout``'s prefix and blob length equal the JAX package's
  for ``meta`` templates of whisper-base (``chip_smoke.py``'s table, held
  against ``jax.eval_shape``) and qwen3-1.7b;
* a state saved by either package, on every route (device-direct chain,
  static, streamed; the manager's host route with its migration), leaves
  the same store tree, manifests included, and restores through the other
  package's ``restore`` and ``restore_sharded``;
* one program per state layout, and the reference's errors.

Tests marked ``gpu`` hold the routes' kernel launches on the card against
the CPU run and skip without one.
"""
import collections
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import devio, manager  # noqa: E402
from repro_torch.core import autotune, jitcache  # noqa: E402
from repro_torch.kernels.gf_encode import kernel, ops  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.storage import archive as arc  # noqa: E402
from repro_torch.storage import object_store as obj  # noqa: E402
from repro_torch.train import sharding  # noqa: E402

try:  # the reference; a machine with only the port installed runs the gpu tests
    import jax
    import jax.numpy as jnp

    from repro.checkpoint import devio as jdevio
    from repro.checkpoint import manager as jmanager
    from repro.storage import archive as jarc
    from repro.storage import object_store as jobj
except ImportError:
    jax = None

ROOT = Path(__file__).resolve().parents[1]
OD = collections.OrderedDict
GEOMS = [(8, 4, 8), (6, 4, 16), (8, 4, 16)]


@pytest.fixture(autouse=True)
def _isolated(request, tmp_path, monkeypatch):
    """A private tuning cache and a clean program cache for every test."""
    if jax is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference package is not installed")
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "tune.json"))
    monkeypatch.setenv(autotune.TUNE_ENV, "cached")
    autotune.reset()
    jitcache.clear()
    yield
    jitcache.clear()
    autotune.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def store_tree(root) -> dict[str, bytes]:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def assert_same_tree(a, b):
    ta, tb = store_tree(a), store_tree(b)
    assert sorted(ta) == sorted(tb)
    assert [f for f in ta if ta[f] != tb[f]] == []


# ---------------------------------------------------------------------------
# the tree serializers
# ---------------------------------------------------------------------------

TREES = [
    1, None, (), [], {}, (1,), [1], {"a": 1}, (1, 2), [None], (None,), {"a": None},
    OD(), OD([("z", 1), ("a", 2)]), ((1,),), {1: 2, 0: 3}, {"x'y": 1, 'q"': 2},
    OD([(1, 1), ("a", 2)]), {"a": {"b": {}}}, [OD([("k", None)])], [(), [], {}, OD()],
    {"b": [1, (2, None)], "a": OD([("y", ()), ("x", [])])},
    {"opt": OD([("z", 1.0), ("a", 2)]), "params": {"b": [1, (2, None)], "w": 3}, "step": 4},
]


@pytest.mark.parametrize("tree", TREES, ids=[repr(t) for t in TREES])
def test_treedef_string_is_jax(tree):
    leaves, treedef = obj.tree_flatten(tree)
    jleaves, jdef = jax.tree.flatten(tree)
    assert str(treedef) == str(jdef)
    assert leaves == jleaves and treedef.num_leaves == jdef.num_leaves
    assert treedef.unflatten(leaves) == tree


@pytest.mark.parametrize("bad,name", [({1, 2}, "set"), (collections.defaultdict(int),
                                                               "defaultdict"),
                                      (object(), "object"), ("text", "str"),
                                      ([np.zeros(2), {"a": b"raw"}], "bytes")])
def test_tree_flatten_names_unsupported_types(bad, name):
    with pytest.raises(TypeError, match=f"cannot flatten a {name}"):
        obj.tree_flatten(bad)


DTYPES = ["float32", "bfloat16", "int64", "int32", "uint8", "bool"]
SHAPES = [(), (3,), (2, 5), (0, 4)]


def leaf_pair(dtype, shape, seed):
    """The same leaf as a torch tensor (the port's state) and a jax array
    (the reference's), from seeded numpy values."""
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        vals = rng.integers(0, 2, size=shape).astype(bool)
    elif dtype in ("float32", "bfloat16"):
        vals = rng.standard_normal(shape).astype(np.float32)
    else:
        vals = rng.integers(0, 120, size=shape).astype(dtype)
    jarr = vals.astype(jnp.bfloat16 if dtype == "bfloat16" else dtype)   # numpy: keeps int64
    tarr = torch.from_numpy(np.array(vals)).to(getattr(torch, dtype))
    return tarr, jarr


CONTAINERS = ["dict", "odict", "list", "tuple", "nested"]


def build(kind, leaves):
    if kind == "dict":
        return {f"k{i}": x for i, x in enumerate(leaves)}
    if kind == "odict":
        return OD((f"z{9 - i}", x) for i, x in enumerate(leaves))
    if kind == "list":
        return list(leaves)
    if kind == "tuple":
        return tuple(leaves)
    return {"b": [leaves[0], (leaves[1], None)], "a": OD([("y", (leaves[2],)), ("x", [])]),
            "c": {}, "d": leaves[3:]}


@pytest.mark.parametrize("kind", CONTAINERS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_tree_to_bytes_equals_reference(kind, dtype):
    pairs = [leaf_pair(dtype, shape, seed) for seed, shape in enumerate(SHAPES)]
    extra = [(np.int64(7), np.int64(7)), (np.float32(1.5), np.float32(1.5))]
    t_leaves = [t for t, _ in pairs] + [a for a, _ in extra]
    j_leaves = [j for _, j in pairs] + [b for _, b in extra]
    tree, jtree = build(kind, t_leaves), build(kind, j_leaves)
    blob = obj.tree_to_bytes(tree)
    assert blob == jobj.tree_to_bytes(jtree)
    back = obj.bytes_to_leaves(blob, tree)
    got, want = obj.tree_flatten(back)[0], obj.tree_flatten(tree)[0]
    for g, w in zip(got, want):
        if isinstance(w, torch.Tensor):        # a tensor template gives a tensor
            assert isinstance(g, torch.Tensor) and g.dtype == w.dtype
            assert torch.equal(g, w)
        else:                                  # a numpy template gives numpy
            assert isinstance(g, np.ndarray) and g == w
    # the reference reads the port's blob (its own numpy kinds)
    jback = jobj.bytes_to_leaves(blob, jtree)
    for j, t in zip(jax.tree.leaves(jback), want):
        t = t.float().numpy() if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16 \
            else np.asarray(t)
        np.testing.assert_array_equal(np.asarray(j, dtype=t.dtype), t)


def test_numpy_leaves_and_scalars_equal_reference():
    tree = {"w": np.arange(12, dtype=np.float32).reshape(3, 4), "s": np.int64(9),
            "f": 2.5, "i": 3, "b": True, "u": np.arange(5, dtype=np.uint16), "n": None}
    assert obj.tree_to_bytes(tree) == jobj.tree_to_bytes(tree)
    back = obj.bytes_to_leaves(obj.tree_to_bytes(tree), tree)
    for key in ("w", "s", "u"):
        np.testing.assert_array_equal(back[key], tree[key])
    assert back["f"] == 2.5 and back["i"] == 3 and back["b"] and back["n"] is None


def corruptions(blob):
    hlen = int.from_bytes(blob[4:12], "little")
    return [
        ("magic", b"XXXX" + blob[4:]),
        ("header length", blob[:4] + (10 ** 9).to_bytes(8, "little") + blob[12:]),
        ("bad header", blob[:12] + b"!" + blob[13:]),
        ("ends past the blob", blob[:12 + hlen + 10]),
    ]


@pytest.mark.parametrize("case", range(4))
def test_corrupt_blobs_raise_the_reference_errors(case):
    tree = {"w": torch.arange(8, dtype=torch.float32), "s": np.int64(3)}
    jtree = {"w": jnp.arange(8, dtype=jnp.float32), "s": np.int64(3)}
    blob = obj.tree_to_bytes(tree)
    match, bad = corruptions(blob)[case]
    with pytest.raises(ValueError, match=match):
        obj.bytes_to_leaves(bad, tree)
    if case < 3:   # the reference's own messages for the header defects
        with pytest.raises(ValueError):
            jobj.bytes_to_leaves(bad, jtree)
    with pytest.raises(ValueError, match="leaves"):
        obj.bytes_to_leaves(blob, {"only": np.zeros(1)})
    with pytest.raises(TypeError, match="object"):
        obj.tree_to_bytes({"bad": np.array(["a", "bc"], dtype=object)})


# ---------------------------------------------------------------------------
# state layouts at the model zoo's sizes (meta templates)
# ---------------------------------------------------------------------------


def jax_state_shapes(arch: str):
    """``benchmarks/fig_checkpoint.py``'s abstract train state for ``arch``."""
    from benchmarks.fig_checkpoint import _state_shapes
    return _state_shapes(arch)


def meta_like(jstate):
    """The port's meta template of a ``jax.eval_shape`` state."""
    def conv(x):
        if isinstance(x, jax.ShapeDtypeStruct):
            return torch.empty(x.shape, dtype=getattr(torch, str(np.dtype(x.dtype))),
                               device="meta")
        return x
    return jax.tree.map(conv, jstate)


@pytest.mark.parametrize("arch,gib", [("whisper-base", 1.227), ("qwen3-1.7b", 22.706)])
def test_state_layout_equals_reference(arch, gib):
    jstate = jax_state_shapes(arch)
    want = jdevio.state_layout(jstate)
    got = devio.state_layout(meta_like(jstate))
    assert got.prefix == want.prefix and got.blob_len == want.blob_len
    assert got.key[0] == want.key[0] and got.device_leaf == want.device_leaf
    assert round(got.blob_len / 2 ** 30, 3) == gib


def test_chip_smoke_whisper_table_is_the_reference_state():
    """``chip_smoke.py``'s whisper-base table: the same paths, shapes and
    dtypes as ``jax.eval_shape`` of the JAX package's ``model.init`` and
    ``adamw.init_opt``, and a byte-identical layout prefix."""
    jstate = jax_state_shapes("whisper-base")
    state = chip_smoke().whisper_state(lambda shape: torch.empty(shape, device="meta"))
    jleaves = jax.tree_util.tree_flatten_with_path(jstate)[0]
    leaves = obj.tree_flatten(state)[0]
    assert len(leaves) == len(jleaves) == 83
    for leaf, (_, jleaf) in zip(leaves, jleaves):
        assert tuple(leaf.shape) == tuple(np.shape(jleaf))
        assert obj.leaf_metas([leaf])[0]["dtype"] == str(np.dtype(jleaf.dtype))
    assert devio.state_layout(state).prefix == jdevio.state_layout(jstate).prefix


# ---------------------------------------------------------------------------
# save / restore across the two packages
# ---------------------------------------------------------------------------


def states(seed=0, scale=1):
    """The same small train state for both packages: (torch, jax)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((12 * scale, 10)).astype(np.float32)
    b = rng.standard_normal(17).astype(np.float32)
    m = rng.standard_normal((12 * scale, 10)).astype(np.float32)
    mask = rng.integers(0, 2, 9).astype(bool)
    t = {"params": {"w": torch.from_numpy(w), "b": torch.from_numpy(b).to(torch.bfloat16)},
         "opt": OD([("m", torch.from_numpy(m)), ("count", torch.tensor(7, dtype=torch.int32)),
                    ("mask", torch.from_numpy(mask))]),
         "step": np.int64(900 + seed)}
    j = {"params": {"w": jnp.asarray(w), "b": jnp.asarray(b).astype(jnp.bfloat16)},
         "opt": OD([("m", jnp.asarray(m)), ("count", jnp.int32(7)),
                    ("mask", jnp.asarray(mask))]),
         "step": np.int64(900 + seed)}
    return t, j


def assert_state_equal(got, want):
    g, w = obj.tree_flatten(got)[0], obj.tree_flatten(want)[0]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        if isinstance(b, torch.Tensor):
            assert isinstance(a, torch.Tensor) and a.dtype == b.dtype
            assert torch.equal(a.cpu(), b)
        else:
            np.testing.assert_array_equal(a, b)


def assert_jax_state_equal(jgot, want):
    for a, b in zip(jax.tree.leaves(jgot), obj.tree_flatten(want)[0]):
        b = b.float().numpy() if isinstance(b, torch.Tensor) and b.dtype == torch.bfloat16 \
            else np.asarray(b)
        np.testing.assert_array_equal(np.asarray(a, dtype=b.dtype), b)


def configs(n, k, l, family="rapidraid"):
    return (arc.ArchiveConfig(n=n, k=k, l=l, seed=3, family=family),
            jarc.ArchiveConfig(n=n, k=k, l=l, seed=3, family=family))


ROUTES = {"chain": {}, "static": {"use_devices": False}}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("n,k,l", GEOMS)
def test_device_direct_save_equals_reference(tmp_path, n, k, l, route):
    acfg, jacfg = configs(n, k, l)
    t, j = states()
    store, jstore = obj.NodeStore(str(tmp_path / "p"), n), jobj.NodeStore(str(tmp_path / "j"), n)
    m = devio.save_state(store, 1, t, acfg, device="cpu", **ROUTES[route])
    assert m == jdevio.save_state(jstore, 1, j, jacfg)
    assert_same_tree(tmp_path / "p", tmp_path / "j")
    for i in range(n - k):          # lose n - k nodes: both restore each other's
        store.fail_node(2 * i % n)
        jstore.fail_node(2 * i % n)
    for s in (store, jstore):
        assert_state_equal(devio.restore_state(s, 1, t, acfg, device="cpu",
                                               **ROUTES[route]), t)
        assert_jax_state_equal(jdevio.restore_state(s, 1, j, jacfg), t)
        assert_jax_state_equal(jmanager.CheckpointManager(jmanager.CheckpointConfig(
            root=s.root, n=n, k=k, l=l, seed=3)).restore(1, j), t)
        assert_state_equal(manager.CheckpointManager(manager.CheckpointConfig(
            root=s.root, n=n, k=k, l=l, seed=3), device="cpu").restore(1, t), t)


@pytest.mark.parametrize("n,k,l", GEOMS)
def test_streamed_save_equals_reference(tmp_path, n, k, l):
    acfg, jacfg = configs(n, k, l)
    t, j = states(seed=1, scale=40)
    store, jstore = obj.NodeStore(str(tmp_path / "p"), n), jobj.NodeStore(str(tmp_path / "j"), n)
    budget = 1 << 14
    m = devio.save_state(store, 2, t, acfg, footprint_bytes=budget, device="cpu")
    assert m["streaming"]["num_superchunks"] > 1
    assert m == jdevio.save_state(jstore, 2, j, jacfg, footprint_bytes=budget)
    assert_same_tree(tmp_path / "p", tmp_path / "j")
    store.fail_node(1)
    assert_state_equal(devio.restore_state(store, 2, t, acfg, device="cpu"), t)
    assert_jax_state_equal(jdevio.restore_state(store, 2, j, jacfg), t)


@pytest.mark.parametrize("n,k,l", GEOMS)
def test_manager_host_route_equals_reference(tmp_path, n, k, l):
    """save x 3 with hot_keep=1 (the two oldest migrate: archive_step, then
    archive_many), restore and read_range on both stores, each package
    reading the other's; ``save_sharded`` / ``restore_sharded`` besides."""
    cfg = dict(n=n, k=k, l=l, seed=3, hot_keep=1)
    mgr = manager.CheckpointManager(manager.CheckpointConfig(root=str(tmp_path / "p"), **cfg),
                                    device="cpu")
    jmgr = jmanager.CheckpointManager(jmanager.CheckpointConfig(root=str(tmp_path / "j"), **cfg))
    pairs = [states(seed=s) for s in range(4)]
    for step, (t, j) in zip((10, 20, 30), pairs):
        assert mgr.save(step, t) == jmgr.save(step, j)
    assert mgr.save_sharded(40, pairs[3][0]) == jmgr.save_sharded(40, pairs[3][1])
    assert [mgr.tier(s) for s in mgr.steps()] == ["archive", "archive", "archive", "archive"]
    assert_same_tree(tmp_path / "p", tmp_path / "j")
    for i in range(n - k):
        mgr.store.fail_node(i)
        jmgr.store.fail_node(i)
    blob = obj.tree_to_bytes(pairs[0][0])
    layout = devio.state_layout(pairs[0][0])
    lo = len(layout.prefix) + layout.metas[1]["offset"] - 7   # across opt.m | opt.count
    for m_ in (mgr, jmgr):
        assert m_.read_range(10, lo, 64) == blob[lo:lo + 64]
    for step, (t, j) in zip((10, 20, 30, 40), pairs):
        assert_state_equal(mgr.restore(step, t), t)
        assert_state_equal(mgr.restore_sharded(step, t), t)
        assert_jax_state_equal(jmgr.restore(step, j), t)
    for s in (mgr, jmgr):
        assert s.steps() == [10, 20, 30, 40]
    assert mgr.restore_latest(pairs[3][0])[0] == 40


def test_one_program_per_state_layout(tmp_path):
    acfg, _ = configs(8, 4, 16)
    store = obj.NodeStore(str(tmp_path), 8)
    t0, _ = states(seed=0)
    devio.save_state(store, 1, t0, acfg, device="cpu")
    before = jitcache.compile_counts()
    for step in (2, 3):
        t, _ = states(seed=step)            # new values, same layout
        devio.save_state(store, step, t, acfg, device="cpu")
        assert_state_equal(devio.restore_state(store, step, t, acfg, device="cpu"), t)
    built = {k: v for k, v in jitcache.compile_counts().items() if k not in before}
    assert list(jitcache.entry_counts("ckpt_save").values()) == [1]
    assert list(jitcache.entry_counts("ckpt_restore").values()) == [1]
    assert [k for k in built if "ckpt_save" in k] == []
    t_big, _ = states(seed=0, scale=2)      # a new layout builds a new program
    devio.save_state(store, 4, t_big, acfg, device="cpu")
    assert len(jitcache.entry_counts("ckpt_save")) == 2


def test_restore_errors_are_the_references(tmp_path):
    acfg, _ = configs(8, 4, 16)
    store = obj.NodeStore(str(tmp_path), 8)
    t, _ = states()
    devio.save_state(store, 1, t, acfg, device="cpu")
    big, _ = states(scale=2)
    with pytest.raises(ValueError, match="template does not match"):
        devio.restore_state(store, 1, big, acfg, device="cpu")
    renamed = {"params": t["params"], "ops": t["opt"], "step": t["step"]}   # same length
    with pytest.raises(ValueError, match="template layout"):
        devio.restore_state(store, 1, renamed, acfg, device="cpu")
    for i in range(5):
        store.fail_node(i)
    with pytest.raises(FileNotFoundError, match="need k=4"):
        devio.restore_state(store, 1, t, acfg, device="cpu")
    mbr = arc.ArchiveConfig(n=6, k=4, l=8, family="mbr")
    with pytest.raises(ValueError, match="sub-packetized"):
        devio.save_state(obj.NodeStore(str(tmp_path / "m"), 6), 1, t, mbr, device="cpu")
    with pytest.raises(TypeError, match="mesh must be a DeviceMesh"):
        devio.save_state(store, 2, t, acfg, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="meta"):
        devio.save_state(store, 3, {"w": torch.empty(4, device="meta")}, acfg, device="cpu")


def test_place_and_shardings(tmp_path):
    acfg, _ = configs(8, 4, 8)
    store = obj.NodeStore(str(tmp_path), 8)
    t, _ = states()
    devio.save_state(store, 1, t, acfg, device="cpu")
    cpu = torch.device("cpu")
    sh = {"params": {"w": cpu, "b": "cpu"}, "opt": OD([("m", cpu), ("count", cpu),
                                                        ("mask", cpu)]), "step": cpu}
    got = devio.restore_state(store, 1, t, acfg, shardings=sh, device="cpu")
    assert isinstance(got["step"], torch.Tensor) and int(got["step"]) == 900
    assert_state_equal({k: v for k, v in got.items() if k != "step"},
                       {k: v for k, v in t.items() if k != "step"})
    mgr = manager.CheckpointManager(manager.CheckpointConfig(root=str(tmp_path), n=8, k=4,
                                                             l=8, seed=3), device="cpu")
    restored = mgr.restore(1, t)
    placed = manager.place(restored, "cpu")
    assert all(isinstance(x, torch.Tensor) for x in obj.tree_flatten(placed)[0])
    assert obj.tree_flatten(restored)[1] == obj.tree_flatten(placed)[1]
    with pytest.raises(ValueError, match="do not match"):
        manager.place(t, {"params": cpu})


# ---------------------------------------------------------------------------
# mesh=: the chain's positions on the devices of a mesh
# ---------------------------------------------------------------------------


def cpu_mesh(data, model):
    return mesh_lib.make_local_mesh(data, model, devices=["cpu"] * (data * model))


def tick_calls(monkeypatch):
    """Counts of the ops' tick and static-encode calls (one a launch)."""
    calls = collections.Counter()
    for name in ("chain_tick", "repair_tick", "encode_words"):
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, spy)
    return calls


@pytest.mark.parametrize("n,k,l", GEOMS)
def test_placed_save_state_equals_unplaced_and_reference(tmp_path, n, k, l, monkeypatch):
    """``save_state(mesh=)`` with a mesh of n or more devices runs one tick
    launch a chain position (n x num_chunks), and its coded blobs and
    manifest are the unplaced save's and the JAX package's."""
    acfg, jacfg = configs(n, k, l)
    t, j = states()
    ref = devio.save_state(obj.NodeStore(str(tmp_path / "u"), n), 1, t, acfg, device="cpu")
    calls = tick_calls(monkeypatch)
    m = devio.save_state(obj.NodeStore(str(tmp_path / "p"), n), 1, t, acfg,
                         mesh=cpu_mesh(2, (n + 1) // 2))
    assert calls == {"chain_tick": n * acfg.num_chunks}
    assert m == ref == jdevio.save_state(jobj.NodeStore(str(tmp_path / "j"), n), 1, j, jacfg)
    assert_same_tree(tmp_path / "p", tmp_path / "u")
    assert_same_tree(tmp_path / "p", tmp_path / "j")


@pytest.mark.parametrize("n,k,l", GEOMS)
def test_placed_restore_state_after_losses(tmp_path, n, k, l, monkeypatch):
    """``restore_state(mesh=)`` decodes on a chain of the k helpers placed on
    the mesh's first k devices (one launch a position), bit for bit."""
    acfg, _ = configs(n, k, l)
    t, _ = states(seed=1)
    store = obj.NodeStore(str(tmp_path), n)
    devio.save_state(store, 1, t, acfg, device="cpu")
    for i in range(n - k):
        store.fail_node(2 * i % n)
    calls = tick_calls(monkeypatch)
    got = devio.restore_state(store, 1, t, acfg, mesh=cpu_mesh(1, n))
    assert calls == {"repair_tick": k * acfg.num_chunks}
    assert_state_equal(got, t)
    with pytest.raises(ValueError, match="either mesh or device"):
        devio.restore_state(store, 1, t, acfg, mesh=cpu_mesh(1, n), device="cpu")


@pytest.mark.parametrize("n,k,l", GEOMS)
def test_mesh_smaller_than_the_chain_takes_gf_encode(tmp_path, n, k, l, monkeypatch):
    """A mesh of fewer devices than the chain has positions saves (n - 1
    devices) and restores (k - 1) through one static encode on its first
    device, as the JAX package's ``use_chain`` does; same blobs, same state."""
    acfg, _ = configs(n, k, l)
    t, _ = states(seed=2)
    ref = devio.save_state(obj.NodeStore(str(tmp_path / "u"), n), 1, t, acfg, device="cpu")
    calls = tick_calls(monkeypatch)
    store = obj.NodeStore(str(tmp_path / "p"), n)
    m = devio.save_state(store, 1, t, acfg, mesh=cpu_mesh(1, n - 1))
    assert calls == {"encode_words": 1} and m == ref
    assert_same_tree(tmp_path / "p", tmp_path / "u")
    store.fail_node(0)
    calls.clear()
    assert_state_equal(devio.restore_state(store, 1, t, acfg, mesh=cpu_mesh(1, k - 1)), t)
    assert calls == {"encode_words": 1}


@pytest.mark.parametrize("n,k,l", GEOMS)
def test_manager_sharded_save_and_restore_on_a_mesh(tmp_path, n, k, l, monkeypatch):
    """``save_sharded`` / ``restore_sharded`` take the mesh in place of the
    manager's device; the store is the unplaced manager's."""
    cfg = dict(n=n, k=k, l=l, seed=3, archive_old=False)
    t, _ = states(seed=3)
    ref = manager.CheckpointManager(manager.CheckpointConfig(root=str(tmp_path / "u"), **cfg),
                                    device="cpu")
    mgr = manager.CheckpointManager(manager.CheckpointConfig(root=str(tmp_path / "p"), **cfg),
                                    device="cpu")
    mesh = cpu_mesh(2, n)
    assert mgr.save_sharded(4, t, mesh=mesh) == ref.save_sharded(4, t)
    assert_same_tree(tmp_path / "p", tmp_path / "u")
    mgr.store.fail_node(n - 1)
    calls = tick_calls(monkeypatch)
    assert_state_equal(mgr.restore_sharded(4, t, mesh=mesh), t)
    assert calls == {"repair_tick": k * mgr.acfg.num_chunks}


def test_elastic_restore_onto_smaller_mesh(tmp_path):
    """The JAX package's elastic case on ``[cpu] * 16``: save on a 4x4 mesh,
    lose three nodes, restore and ``place`` onto a 2x2 mesh per
    ``Placement``s; ``restore_sharded(shardings=)`` does it in one call."""
    mesh16, mesh4 = cpu_mesh(4, 4), cpu_mesh(2, 2)
    sh4 = sharding.Placement(mesh4, sharding.Spec("data", "model"))
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    m = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    state = {"params": {"w": w}, "opt": {"m": m, "count": torch.tensor(9, dtype=torch.int32)},
             "step": np.int64(4)}
    mgr = manager.CheckpointManager(manager.CheckpointConfig(root=str(tmp_path),
                                                             archive_old=False), device="cpu")
    mgr.save_sharded(4, state, mesh=mesh16)
    for i in (1, 6, 12):
        mgr.store.fail_node(i)
    back = mgr.restore_sharded(4, state, mesh=mesh16)
    assert int(back["step"]) == 4
    placed = manager.place({"params": back["params"], "opt": back["opt"]},
                           {"params": {"w": sh4}, "opt": {
                               "m": sh4, "count": sharding.Placement(mesh4, sharding.Spec())}})
    pw = placed["params"]["w"]
    assert isinstance(pw, sharding.ShardedTensor) and pw.placement == sh4
    assert [tuple(x.shape) for x in pw.shards] == [(8, 4)] * 4
    assert torch.equal(pw.full(), w) and torch.equal(placed["opt"]["m"].full(), m)
    assert int(placed["opt"]["count"].full()) == 9
    mgr.save_sharded(5, {"w": w}, mesh=mesh16)
    back2 = mgr.restore_sharded(5, {"w": w}, shardings={"w": sh4})
    assert back2["w"].placement == sh4 and torch.equal(back2["w"].full(), w)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("l", [8, 16])
def test_device_direct_routes_on_the_card(tmp_path, cuda, l):
    """Each route's kernels launch, and the card's coded blobs and restored
    leaves equal the CPU run's (the kernels' plain versions)."""
    acfg = arc.ArchiveConfig(n=8, k=4, l=l, seed=3)
    rng = np.random.default_rng(l)
    state = {"w": torch.from_numpy(rng.standard_normal((64, 33)).astype(np.float32)),
             "b": torch.from_numpy(rng.standard_normal(50).astype(np.float32)).to(torch.bfloat16),
             "step": np.int64(5)}
    on_card = {k: (v.to(cuda) if isinstance(v, torch.Tensor) else v) for k, v in state.items()}
    ref = devio.save_state(obj.NodeStore(str(tmp_path / "cpu"), 8), 1, state, acfg, device="cpu")
    for route, kw, want in (("chain", {}, "encode_chain"),
                            ("static", {"use_devices": False}, "gf_encode")):
        store = obj.NodeStore(str(tmp_path / route), 8)
        kernel.reset_launch_counts()
        m = devio.save_state(store, 1, on_card, acfg, device=cuda, **kw)
        counts = kernel.launch_counts()
        assert counts[want] >= 1 and m["coded_digests"] == ref["coded_digests"]
        if route == "chain":
            assert counts["encode_chain"] == 1 and counts["chain_tick"] == 0
        for i in (0, 3, 5, 6):
            store.fail_node(i)
        kernel.reset_launch_counts()
        got = devio.restore_state(store, 1, on_card, acfg, device=cuda, **kw)
        counts = kernel.launch_counts()
        assert counts["repair_chain" if route == "chain" else "gf_encode"] >= 1
        assert got["w"].device.type == "cuda"
        assert_state_equal({k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                            for k, v in got.items()}, state)


@pytest.mark.gpu
def test_mesh_across_cards(tmp_path):
    """Chain positions on every card of the host: the save's blobs are the
    CPU save's, the restore is bit for bit, and ``shardings=`` lays each
    leaf's blocks out on the cards of a 2 x 2 mesh."""
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two or more CUDA cards")
    cards = [torch.device("cuda", i % count) for i in range(16)]
    mesh16 = mesh_lib.make_local_mesh(4, 4, devices=cards)
    mesh4 = mesh_lib.make_local_mesh(2, 2, devices=cards[:4])
    acfg = arc.ArchiveConfig(n=16, k=11, l=16, seed=3)
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))
    state = {"w": w.to(cards[0]), "step": np.int64(2)}
    ref = devio.save_state(obj.NodeStore(str(tmp_path / "cpu"), 16), 1, {"w": w, "step":
                                                                          np.int64(2)},
                           acfg, device="cpu")
    store = obj.NodeStore(str(tmp_path / "cards"), 16)
    assert devio.save_state(store, 1, state, acfg, mesh=mesh16) == ref
    for i in (0, 5, 9):
        store.fail_node(i)
    sh = sharding.Placement(mesh4, sharding.Spec("data", "model"))
    got = devio.restore_state(store, 1, state, acfg, mesh=mesh16,
                              shardings={"w": sh, "step": "cpu"})
    assert [s.device for s in got["w"].shards] == list(mesh4.flat)
    assert torch.equal(got["w"].full().cpu(), w) and int(got["step"]) == 2
