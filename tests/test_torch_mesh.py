"""Device meshes of the PyTorch port (``launch.mesh``, ``chain.make_chain_mesh``).

``DeviceMesh`` has a ``jax.sharding.Mesh``'s ``shape`` / ``axis_names`` /
``size`` and hashes by content; the builders raise the JAX package's
messages on too few devices; ``make_chain_mesh`` validates an order as
``repro.storage.chain.make_chain_mesh`` does, message for message (the JAX
side runs with 4 host devices, as its own tests do); ``chain_order`` and
``mesh_tag`` equal the JAX package's on a fake mesh.
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch.mesh import DeviceMesh  # noqa: E402
from repro_torch.storage import chain  # noqa: E402
from repro_torch.train import sharding  # noqa: E402

try:  # the reference
    from repro.launch import mesh as jmesh
    from repro.train import sharding as jsharding

    from tests.subproc import run_with_devices
except ImportError:
    jmesh = None


@pytest.fixture(autouse=True)
def _reference():
    if jmesh is None:
        pytest.skip("the JAX reference package is not installed")


def cpus(n):
    return ["cpu"] * n


def test_device_mesh_has_a_mesh_interface():
    m = DeviceMesh(("data", "model"), (2, 3), cpus(6))
    assert m.shape == {"data": 2, "model": 3} and m.axis_names == ("data", "model")
    assert m.size == 6 and m.devices.shape == (2, 3)
    assert all(d == torch.device("cpu") for d in m.devices.reshape(-1))
    assert m.ids == tuple(range(6))
    assert list(m.shape) == list(m.axis_names)


def test_device_mesh_hashes_and_compares_by_content():
    a = DeviceMesh(("chain",), (4,), cpus(4))
    b = DeviceMesh(["chain"], [4], [torch.device("cpu")] * 4)
    assert a == b and hash(a) == hash(b) and len({a, b}) == 1
    assert a != DeviceMesh(("chain",), (4,), cpus(4), ids=[3, 2, 1, 0])
    assert a != DeviceMesh(("stage",), (4,), cpus(4))
    assert {a: 1}[b] == 1


@pytest.mark.parametrize("shape,devices,ids", [((2, 2), 3, None), ((2,), 2, [0]),
                                               ((0,), 0, None)])
def test_device_mesh_rejects_bad_layouts(shape, devices, ids):
    with pytest.raises(ValueError):
        DeviceMesh(("a", "b")[:len(shape)], shape, cpus(devices), ids=ids)


@pytest.mark.parametrize("data,model", [(1, 1), (2, 4), (4, 4)])
def test_make_local_mesh(data, model):
    m = mesh_lib.make_local_mesh(data, model, devices=cpus(16))
    assert m.shape == {"data": data, "model": model} and m.size == data * model
    assert mesh_lib.mesh_tag(m) == f"{data}x{model}"


def test_builders_raise_the_reference_messages():
    with pytest.raises(ValueError) as want:
        jmesh.make_local_mesh(2, 2)                 # one host device here
    with pytest.raises(ValueError) as got:
        mesh_lib.make_local_mesh(2, 2, devices=cpus(1))
    assert str(got.value) == str(want.value)
    for multi_pod in (False, True):
        with pytest.raises(ValueError) as want:
            jmesh.make_production_mesh(multi_pod=multi_pod)
        with pytest.raises(ValueError) as got:
            mesh_lib.make_production_mesh(multi_pod, devices=cpus(1))
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shapes(multi_pod):
    m = mesh_lib.make_production_mesh(multi_pod, devices=cpus(512))
    want = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
    assert m.shape == want and m.size == int(np.prod(list(want.values())))
    assert mesh_lib.mesh_tag(m) == jmesh.mesh_tag(SimpleNamespace(
        shape=want, axis_names=tuple(want)))


def test_default_devices_are_the_visible_cards():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    assert mesh_lib.visible_devices() == []
    assert mesh_lib.visible_devices("cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="need 1 devices, have 0"):
        mesh_lib.make_local_mesh()
    with pytest.raises(ValueError, match="need 2 devices for an n=2 chain, have 0"):
        chain.make_chain_mesh(2)


CHAIN_CASES = [(4, None), (4, [3, 1, 0, 2]), (2, [3, 1]), (4, [0, 0, 1, 2]), (4, [0, 1, 2]),
               (3, [0, 1, 4]), (5, None), (5, [0, 1, 2, 3, 4]), (1, [3])]

CHAIN_SNIPPET = """
import json
from repro.storage import chain
out = []
for n, order in {cases!r}:
    try:
        m = chain.make_chain_mesh(n, order)
        out.append(["ok", [int(d.id) for d in m.devices.reshape(-1)]])
    except ValueError as e:
        out.append(["error", str(e)])
print("RESULT" + json.dumps(out))
"""


def test_make_chain_mesh_validates_as_the_reference():
    """Distinct ids, in range, enough devices: the same messages as the JAX
    package's ``make_chain_mesh`` over 4 devices."""
    out = run_with_devices(CHAIN_SNIPPET.format(cases=CHAIN_CASES), ndev=4)
    want = json.loads(out.split("RESULT", 1)[1])
    for (n, order), (kind, value) in zip(CHAIN_CASES, want):
        if kind == "ok":
            m = chain.make_chain_mesh(n, order, devices=cpus(4))
            assert list(m.ids) == value and m.axis_names == (chain.AXIS,) and m.size == n
        else:
            with pytest.raises(ValueError) as got:
                chain.make_chain_mesh(n, order, devices=cpus(4))
            assert str(got.value) == value


@pytest.mark.parametrize("shape,ids,n", [((4, 4), None, 11), ((2, 2), None, 11),
                                         ((2, 8), list(range(15, -1, -1)), 16),
                                         ((16,), list(range(16)), 0), ((4, 2), [7, 3, 5, 1, 6, 2, 4, 0], 5)])
def test_chain_order_equals_reference(shape, ids, n):
    size = int(np.prod(shape))
    ids = list(range(size)) if ids is None else ids
    fake = SimpleNamespace(devices=np.array([SimpleNamespace(id=i) for i in ids],
                                            dtype=object).reshape(shape))
    m = DeviceMesh(("a", "b")[:len(shape)], shape, cpus(size), ids=ids)
    assert sharding.chain_order(m, n) == jsharding.chain_order(fake, n)
