"""``launch/cost_model.py`` of the PyTorch port, on the CPU: the port of
``tests/test_cost_model.py`` with a tighter bound.

* The composed estimate (one-layer program + (L-1) x standalone layer, the
  sliding-window per-layer sum, the encoder-decoder branch) against the
  full-depth program's count, on a (2, 2) meta mesh, for qwen3-1.7b,
  rwkv6-3b and phi3.5-moe smoke at 3 layers, hymba-1.5b (sliding window)
  and whisper-base (encoder-decoder), each for train_4k / prefill_32k /
  decode_32k patched to (seq 32, batch 4): FLOPs and link bytes within 1%,
  bytes accessed within the reference's 25% (the optimizer's work on the
  extra layers is not in the composition).
* The same step counted on ``["meta"] * 4`` and on ``["cpu"] * 4`` gives the
  same FLOPs, bytes accessed and ledger.
* ``OpCounter``'s FLOPs equal ``FlopCounterMode``'s over the same run.
* The ratio of the port's corrected FLOPs to the JAX package's at smoke
  width is printed, with no bound: XLA counts elementwise ops, the port's
  flop counter only matrix products.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import get_config, shapes  # noqa: E402
from repro_torch.launch import cost_model  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402


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


SHAPES = ["train_4k", "prefill_32k", "decode_32k"]
ARCHS = ["qwen3-1.7b", "rwkv6-3b", "phi3.5-moe-42b-a6.6b", "hymba-1.5b", "whisper-base"]


def _small_cfg(arch: str, n_layers: int = 3):
    cfg = get_config(arch, smoke=True)
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_layers=n_layers, enc_layers=n_layers)
    return dataclasses.replace(cfg, n_layers=n_layers)


def _mesh(device="meta", shape=(2, 2)):
    return mesh_lib.DeviceMesh(("data", "model"), shape, [device] * (shape[0] * shape[1]))


@pytest.fixture
def small_shapes(monkeypatch):
    """The shape registry's cells shrunk to something CPU-sized."""
    for name in SHAPES:
        sh = shapes.SHAPES[name]
        monkeypatch.setitem(shapes.SHAPES, name, shapes.ShapeSpec(name, sh.kind, 32, 4))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_corrected_matches_full_depth(arch, shape, small_shapes):
    cfg = _small_cfg(arch)
    mesh = _mesh()
    corrected = cost_model.corrected_costs(cfg, mesh, shape)["total"]
    truth = cost_model._program_cost(cost_model._accounting_cfg(cfg, 32), mesh, shape)
    assert truth.flops > 0 and truth.coll_bytes > 0
    assert abs(corrected["flops"] - truth.flops) <= 0.01 * truth.flops, (corrected, truth)
    assert abs(corrected["coll_bytes"] - truth.coll_bytes) <= 0.01 * truth.coll_bytes, \
        (corrected, truth)
    assert abs(corrected["hbm_bytes"] - truth.hbm_bytes) <= 0.25 * truth.hbm_bytes, \
        (corrected, truth)


@pytest.mark.parametrize("arch,shape", [("qwen3-1.7b", "train_4k"), ("hymba-1.5b", "decode_32k"),
                                        ("whisper-base", "prefill_32k"),
                                        ("phi3.5-moe-42b-a6.6b", "train_4k")])
def test_meta_and_cpu_counts_are_equal(arch, shape, small_shapes):
    cfg = _small_cfg(arch)
    got = {}
    for dev in ("meta", "cpu"):
        mesh = _mesh(dev)
        m = cost_model.measure(cost_model.program(cfg, mesh, shape).run, mesh)
        got[dev] = (m.cost, m.coll.summary(), m.counter.peak)
    assert got["meta"][:2] == got["cpu"][:2]
    assert got["meta"][0].flops > 0


@pytest.mark.parametrize("shape", SHAPES)
def test_op_counter_flops_equal_flop_counter_mode(shape, small_shapes):
    mesh = _mesh()
    prog = cost_model.program(_small_cfg("minicpm3-4b"), mesh, shape)
    with FlopCounterMode(display=False) as fc:
        m = cost_model.measure(prog.run, mesh)
    assert m.counter.flops == fc.get_total_flops() > 0


def test_layer_programs_cover_every_kind(small_shapes):
    """Each standalone program runs on the mesh and its train program's
    backward gathers and reduce-scatters the weights (the ledger)."""
    cfg = _small_cfg("qwen3-1.7b")
    mesh = _mesh()
    fwd = cost_model.layer_fwd_cost(cfg, mesh, 4, 32)
    train = cost_model.layer_train_cost(cfg, mesh, 4, 32)
    assert train.flops == pytest.approx(3 * fwd.flops, rel=0.01)
    assert train.coll_bytes > fwd.coll_bytes > 0


def test_flops_ratio_to_reference(small_shapes, monkeypatch):
    """The port's corrected FLOPs over the JAX package's on a 1 x 1 mesh,
    printed for the record (no bound)."""
    try:
        from repro.configs import get_config as jget_config
        from repro.configs import shapes as jshapes
        from repro.launch import cost_model as jcost_model
        from repro.launch.mesh import make_local_mesh
    except ImportError:
        pytest.skip("the JAX reference package is not installed")
    for name in SHAPES:
        sh = jshapes.SHAPES[name]
        monkeypatch.setitem(jshapes.SHAPES, name, jshapes.ShapeSpec(name, sh.kind, 32, 4))
    jcfg = dataclasses.replace(jget_config("qwen3-1.7b", smoke=True), n_layers=3)
    ratios = {}
    for shape in SHAPES:
        port = cost_model.corrected_costs(_small_cfg("qwen3-1.7b"), _mesh(shape=(1, 1)),
                                          shape)["total"]["flops"]
        ref = jcost_model.corrected_costs(jcfg, make_local_mesh(1, 1), shape)["total"]["flops"]
        ratios[shape] = port / ref
    print(f"qwen3-1.7b smoke, 3 layers, (32, 4) cells: port / JAX corrected FLOPs {ratios}")
    assert all(r > 0 for r in ratios.values())


@pytest.mark.gpu
@pytest.mark.parametrize("arch,shape", [("qwen3-1.7b", "train_4k"),
                                        ("phi3.5-moe-42b-a6.6b", "prefill_32k"),
                                        ("whisper-base", "decode_32k")])
def test_card_counts_equal_meta(arch, shape, small_shapes):
    """The same step on a 2 x 2 mesh of [cuda:0] * 4 and of meta devices:
    equal FLOPs, bytes accessed, ledger and live-bytes peak (the card's
    uploads of host constants are not counted)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    cfg = _small_cfg(arch)
    got = {}
    for dev in ("meta", "cuda:0"):
        mesh = _mesh(dev)
        m = cost_model.measure(cost_model.program(cfg, mesh, shape).run, mesh)
        got[dev] = (m.cost, m.coll.summary(), m.counter.peak)
    assert got["meta"] == got["cuda:0"]
