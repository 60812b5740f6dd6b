"""``launch/traffic_model.py`` of the PyTorch port: the analytic HBM-traffic
model (perfect-fusion lower bound, per device), on the CPU.

* ``traffic()`` equals the JAX package's, key for key and exactly, for every
  architecture, every cell of ``shape_cells`` and the mesh axes of the
  (16, 16) and (2, 16, 16) production meshes and of the fsdp layout's
  (256, 1) (skipped where JAX is missing). The port takes one layer's
  parameter shapes from layer 0 of a one-layer ``stack_init`` on the meta
  device and each leaf's rule at the JAX package's path.
* The six committed JAX dry-run artifacts' ``hbm_traffic_model`` are
  reproduced exactly (the artifacts are read as data; no JAX needed).
"""
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

try:
    from repro.configs import get_config as jget_config
    from repro.launch import traffic_model as jtraffic
except ImportError:
    jtraffic = None

from repro_torch.configs import ARCHS, get_config, shapes  # noqa: E402
from repro_torch.launch import traffic_model  # noqa: E402
from repro_torch.models import transformer  # noqa: E402


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


MESH_AXES = {"16x16": {"data": 16, "model": 16},
             "2x16x16": {"pod": 2, "data": 16, "model": 16},
             "256x1": {"data": 256, "model": 1}}
ARTIFACTS = sorted((Path(__file__).resolve().parents[1] / "runs" / "dryrun").glob("*.json"))


def _axes_of(tag: str) -> dict:
    dims = [int(d) for d in tag.split("x")]
    names = ("pod", "data", "model") if len(dims) == 3 else ("data", "model")
    return dict(zip(names, dims))


@pytest.mark.parametrize("mesh", list(MESH_AXES))
@pytest.mark.parametrize("arch", ARCHS)
def test_traffic_equals_reference(arch, mesh):
    if jtraffic is None:
        pytest.skip("the JAX reference package is not installed")
    cfg, jcfg = get_config(arch), jget_config(arch)
    for shape in shapes.shape_cells(cfg):
        got = traffic_model.traffic(cfg, shape, MESH_AXES[mesh])
        want = jtraffic.traffic(jcfg, shape, MESH_AXES[mesh])
        assert list(got) == list(want), shape
        for key in want:
            assert got[key] == want[key], (shape, key, got[key], want[key])
            assert type(got[key]) is type(want[key]), (shape, key)


@pytest.mark.parametrize("mp", [1, 2, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_layer_weight_bytes_equal_reference(arch, mp):
    """One layer's (bf16, fp32) bytes per device: the stacked leaves' L axis
    is dropped before each leaf meets its rule."""
    if jtraffic is None:
        pytest.skip("the JAX reference package is not installed")
    assert traffic_model._layer_weight_bytes(get_config(arch), mp) == \
        jtraffic._layer_weight_bytes(jget_config(arch), mp)


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_shapes_are_one_layer_of_the_stack(arch):
    """``layer_shapes`` is the stack's per-layer tree: the same paths as one
    layer of the full stack, the shapes without the leading L axis."""
    cfg = get_config(arch)
    one = traffic_model.layer_shapes(cfg)
    full = transformer.stack_init(traffic_model.model_lib._MetaGenerator(), cfg, cfg.pdtype)

    def walk(a, b):
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k])
            else:
                assert a[k].device.type == "meta"
                assert tuple(a[k].shape) == tuple(b[k].shape[1:]) and a[k].dtype == b[k].dtype
    walk(one, full)


@pytest.mark.parametrize("path", ARTIFACTS, ids=[p.stem for p in ARTIFACTS])
def test_reproduces_committed_artifacts(path):
    art = json.loads(path.read_text())
    tm = traffic_model.traffic(get_config(art["arch"]), art["shape"], _axes_of(art["mesh"]))
    got = {k: (float(v) if not isinstance(v, int) else v) for k, v in tm.items()}
    assert got == art["hbm_traffic_model"]


def test_six_artifacts_are_committed():
    assert len(ARTIFACTS) == 6
