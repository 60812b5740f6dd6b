"""``launch/dryrun.py`` of the PyTorch port, on the CPU: the dry-run on meta
devices.

* ``lower_cell`` with the production mesh swapped for a (2, 2) meta mesh
  and the shape registry shrunk (as ``tests/test_cost_model.py`` shrinks
  it), smoke configs: one artifact of each kind (train, prefill, decode),
  each with the committed JAX artifacts' key set, its memory consistent
  (peak above the arguments, the totals by the JAX formula) and its
  hbm_traffic_model ``traffic_model.traffic``'s; ``main`` writes it under
  ``--out`` with the JAX file name.
* The per-device argument bytes of qwen3-1.7b's three 16 x 16 cells from the
  placement alone (no step run) equal the committed artifacts': train
  97,243,140 and prefill 32,501,760 exactly; decode 4 bytes fewer than
  1,911,287,844, the ``pos`` scalar, which the port passes as a Python int
  (so no meta tensor is read on the host; ROADMAP Queue 3).
"""
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, shapes  # noqa: E402
from repro_torch.launch import cost_model, dryrun, traffic_model  # noqa: E402
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


ARTIFACTS = Path(__file__).resolve().parents[1] / "runs" / "dryrun"
SHAPES = ["train_4k", "prefill_32k", "decode_32k"]


@pytest.fixture
def small(monkeypatch):
    """A (2, 2) meta mesh for the production one, (seq 32, batch 4) cells
    and the smoke configs."""
    monkeypatch.setattr(dryrun, "production_mesh", lambda multi_pod: mesh_lib.DeviceMesh(
        ("data", "model"), (2, 2), ["meta"] * 4))
    monkeypatch.setattr(dryrun, "get_config", lambda arch: get_config(arch, smoke=True))
    for name in SHAPES:
        sh = shapes.SHAPES[name]
        monkeypatch.setitem(shapes.SHAPES, name, shapes.ShapeSpec(name, sh.kind, 32, 4))


def keys(tree, prefix=""):
    out = set()
    for k, v in tree.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("per_op_bytes", "per_op_count"):
            out |= keys(v, f"{prefix}{k}/")
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_lower_cell_writes_the_reference_keys(shape, small):
    art = dryrun.lower_cell("qwen3-1.7b", shape, multi_pod=False)
    want = json.loads((ARTIFACTS / f"qwen3-1.7b__{shape}__16x16.json").read_text())
    assert keys(art) == keys(want)
    assert art["mesh"] == "2x2" and art["n_chips"] == 4 and art["kind"] == want["kind"]
    m = art["memory"]
    assert m["peak_bytes"] >= m["argument_bytes"] > 0 and m["output_bytes"] > 0
    assert m["total_per_device"] == m["argument_bytes"] + m["output_bytes"] + \
        m["temp_bytes"] - m["alias_bytes"]
    assert m["alias_bytes"] == (0 if shape == "prefill_32k" else m["alias_bytes"]) >= 0
    if shape != "prefill_32k":
        assert 0 < m["alias_bytes"] <= m["argument_bytes"]
    tm = traffic_model.traffic(get_config("qwen3-1.7b", smoke=True), shape,
                               {"data": 2, "model": 2})
    assert art["hbm_traffic_model"]["total"] == tm["total"]
    r = art["roofline"]
    assert r["flops"] == art["cost_corrected"]["total"]["flops"] > 0
    assert r["coll_bytes"] > 0 and r["step_time_s"] > 0
    # eager torch undercounts nothing: the full-depth run at the production
    # tiles is the corrected count at the accounting tiles, an upper bound
    raw = art["cost_raw_whole_program"]
    assert 0.9 * r["flops"] <= raw["flops"] <= r["flops"]


def test_main_writes_the_artifact(small, tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "qwen3-1.7b", "--shape", "decode_32k",
                                      "--mesh", "pod1", "--out", str(tmp_path), "--no-correct"])
    assert dryrun.main() == 0
    art = json.loads((tmp_path / "qwen3-1.7b__decode_32k__16x16.json").read_text())
    assert art["cost_corrected"]["note"].startswith("raw whole-program")
    assert art["cost_corrected"]["total"]["flops"] == art["cost_raw_whole_program"]["flops"]


@pytest.mark.parametrize("shape,by_design", [("train_4k", 0), ("prefill_32k", 0),
                                             ("decode_32k", 4)])
def test_argument_bytes_equal_committed(shape, by_design):
    mesh = dryrun.production_mesh(False)
    prog = cost_model.program(get_config("qwen3-1.7b"), mesh, shape)
    want = json.loads((ARTIFACTS / f"qwen3-1.7b__{shape}__16x16.json").read_text())["memory"]
    # decode: the JAX step's int32 ``pos`` argument (4 bytes) is a Python int here
    assert dryrun.held_bytes(prog.args) == want["argument_bytes"] - by_design
    donated = dryrun.held_bytes({k: prog.args[k] for k in prog.donated})
    assert donated == (0 if shape == "prefill_32k" else want["alias_bytes"])
