"""``configs/shapes.py``, ``launch/roofline.py`` and ``launch/hlo.py`` of the
PyTorch port against the JAX package's, on the CPU.

* ``input_specs``: for every arch and every cell of ``shape_cells``, the same
  keys, shapes and dtypes as the JAX package's ``ShapeDtypeStruct``s; the
  port's stand-ins live on the ``meta`` device (nothing allocated).
* ``roofline``: with the JAX package's TPU constants patched in, the same
  ``to_dict()``; the port's own constants are the H100 SXM's.
* ``hlo.collective_bytes`` over ledger records equals the JAX package's over
  HLO lines written for the same ops, shapes, dtypes and groups, and over
  the ledger of a real sharded step.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax

    from repro.configs import get_config as jget_config
    from repro.configs import shapes as jshapes
    from repro.launch import hlo as jhlo
    from repro.launch import roofline as jroofline
except ImportError as e:
    pytest.skip(f"the JAX reference is not importable: {e}", allow_module_level=True)

from repro_torch.configs import ARCHS, get_config, shapes  # noqa: E402
from repro_torch.launch import hlo, roofline  # noqa: E402


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


_JAX_DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16, "float32": torch.float32}


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {p: v for k, v in tree.items() for p, v in _flat(v, path + (k,)).items()}
    return {"/".join(path): tree}


def _flat_jax(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(e, "key", e)) for e in path): x for path, x in leaves}


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_cells_and_input_specs_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    cells = shapes.shape_cells(cfg)
    assert cells == jshapes.shape_cells(jcfg)
    assert set(shapes.SHAPES) == set(jshapes.SHAPES)
    for name in shapes.SHAPES:
        assert dataclasses.astuple(shapes.SHAPES[name]) == dataclasses.astuple(jshapes.SHAPES[name])
        assert shapes.applicable(cfg, name) == jshapes.applicable(jcfg, name)
    for cell in cells:
        got, want = _flat(shapes.input_specs(cfg, cell)), _flat_jax(jshapes.input_specs(jcfg, cell))
        assert sorted(got) == sorted(want), cell
        for key, x in got.items():
            assert x.device.type == "meta", (cell, key)
            assert tuple(x.shape) == tuple(want[key].shape), (cell, key)
            assert x.dtype == _JAX_DTYPES[str(want[key].dtype)], (cell, key)


def test_roofline_equals_reference(monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(roofline, name, getattr(jroofline, name))
    rng = np.random.default_rng(0)
    for _ in range(20):
        flops, hbm, coll = (float(x) for x in rng.uniform(1e9, 1e15, size=3))
        n = int(rng.integers(1, 10**9))
        for kind in ("train", "decode"):
            mf = roofline.model_flops_per_chip(kind, n, 4096, 256)
            assert mf == jroofline.model_flops_per_chip(kind, n, 4096, 256)
            assert roofline.make_roofline(flops, hbm, coll, mf).to_dict() == \
                jroofline.make_roofline(flops, hbm, coll, mf).to_dict()
    assert roofline.make_roofline(0.0, 0.0, 0.0, 0.0).to_dict() == \
        jroofline.make_roofline(0.0, 0.0, 0.0, 0.0).to_dict()


def test_roofline_constants_are_the_h100s():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.ICI_BW) == (989.4e12, 3.35e12, 450e9)
    r = roofline.make_roofline(989.4e12, 3.35e12, 900e9, 494.7e12)
    assert (r.compute_s, r.memory_s, r.collective_s, r.bound) == (1.0, 1.0, 2.0, "collective")
    assert r.mfu == 0.25


_HLO = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int32: "s32", torch.int8: "s8"}
RECORDS = [("all-gather", torch.float32, (16, 128), 4), ("all-reduce", torch.bfloat16, (8, 2048), 2),
           ("reduce-scatter", torch.float32, (4, 512), 8), ("all-to-all", torch.int32, (64,), 4),
           ("all-reduce", torch.float32, (), 16), ("collective-permute", torch.int8, (3, 5), 2),
           ("all-gather", torch.bfloat16, (2, 3, 7), 2)]


def _hlo_line(op, dtype, shape, g, i):
    dims = ",".join(str(d) for d in shape)
    groups = f"replica_groups=[{32 // g},{g}]<=[32]"
    if op == "collective-permute":
        groups = "source_target_pairs={{0,1},{1,0}}"
    return f"  %c{i} = {_HLO[dtype]}[{dims}]{{0}} {op}(%x{i}), channel_id={i}, {groups}"


def test_collective_bytes_equal_reference():
    text = "\n".join(_hlo_line(*r, i) for i, r in enumerate(RECORDS))
    got, want = hlo.collective_bytes(RECORDS), jhlo.collective_bytes(text)
    assert got.per_op == want.per_op and got.count == want.count
    assert got.total_bytes == want.total_bytes and got.summary() == want.summary()
    with pytest.raises(ValueError, match="unknown collective"):
        hlo.collective_bytes([("broadcast", torch.float32, (2,), 2)])


def test_collective_bytes_of_a_sharded_step():
    """The ledger of a sharded qwen3 step (2 x 2 mesh of the CPU) read by
    the port and, written as HLO lines, by the JAX package."""
    from repro_torch.data import pipeline as data_lib
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.train import run_training
    from repro_torch.optim import adamw
    cfg = get_config("qwen3-1.7b", smoke=True)
    dcfg = data_lib.DataConfig(vocab=cfg.vocab, seq=16, global_batch=4, seed=0)
    out = run_training(cfg, adamw.OptConfig(total_steps=2, warmup_steps=1), dcfg, 1,
                       mesh=mesh_lib.make_local_mesh(2, 2, devices=["cpu"] * 4),
                       log=lambda *_: None)
    records = out["collectives"]
    assert {r.op for r in records} == {"all-gather", "all-reduce", "reduce-scatter"}
    text = "\n".join(_hlo_line(*r, i) for i, r in enumerate(records))
    assert hlo.collective_bytes(records).summary() == jhlo.collective_bytes(text).summary()
