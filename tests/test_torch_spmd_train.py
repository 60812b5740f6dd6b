"""``run_training(mesh=)`` on the PyTorch port, on the CPU: every family's
smoke config trained over (2,2) and (2,2,2) meshes of ``["cpu"] * n`` in the
``2d`` and ``fsdp`` layouts against the one-device run, and the erasure-coded
checkpoint of a sharded state: saved from a 2 x 2 mesh (the files of the
same state saved whole), restored onto 1 x 2 bit for bit, resumed. The
step itself is held in ``tests/test_torch_spmd.py``.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import hints  # noqa: E402
from repro_torch.checkpoint import devio  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointConfig, CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline as data_lib  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch.train import _whole, run_training  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import sharding  # noqa: E402


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


@pytest.mark.parametrize("mesh", ["2x2", "2x2x2"])
@pytest.mark.parametrize("layout", ["2d", "fsdp"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_run_training_over_a_mesh(arch, mesh, layout):
    """``run_training(mesh=)`` against ``run_training(device="cpu")``: the
    same history within 1e-5 and the parameters within 1e-5; the hints are
    installed for the run only. AdamW's first steps divide the gradient by
    its own magnitude, so where a gradient element nearly cancels over the
    tokens (a rarely picked vocabulary column), the reduction order's
    rounding reaches the update: such elements (at most 1e-3 of them) are
    held to 1e-4, the JAX parity bound."""
    cfg = f32(arch)
    ocfg = adamw.OptConfig(total_steps=4, warmup_steps=1)
    dcfg = data_lib.DataConfig(vocab=cfg.vocab, seq=S, global_batch=B, seed=3)
    q = dict(log_every=1, log=lambda *_: None)
    one = run_training(cfg, ocfg, dcfg, 2, device="cpu", **q)
    before = dict(hints._HINTS)
    got = run_training(cfg, ocfg, dcfg, 2, mesh=mesh_of(MESHES[mesh]), layout=layout, **q)
    assert hints._HINTS == before
    for h1, h2 in zip(one["history"], got["history"]):
        assert h1["step"] == h2["step"]
        for key in h1:
            np.testing.assert_allclose(h2[key], h1[key], rtol=TOL, atol=TOL, err_msg=key)
    diffs = np.concatenate([np.abs(st.full().numpy() - a.detach().numpy()).ravel()
                            for (a,), (st,) in zip(adamw._zip(one["params"]),
                                                   adamw._zip(got["params"]))])
    assert np.mean(diffs > TOL) <= 1e-3 and diffs.max() <= 1e-4
    assert_blocks(got["params"])
    assert_blocks(got["opt"]["v"])
    assert got["collectives"] and len(got["step_s"]) == 2


# -- checkpoints from a mesh --------------------------------------------------


def store_files(root) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in Path(root).rglob("*") if p.is_file()}


def test_mesh_checkpoint_save_and_elastic_resume(tmp_path):
    """whisper-base (float32) trained on a 2 x 2 mesh through a device-direct
    manager whose (4, 2) chain runs on the mesh's positions: the step-3
    save's manifest and shards equal those of the same state saved whole;
    restored onto a 1 x 2 mesh bit for bit; a run resumed onto 2 x 2
    continues the unbroken run bit for bit, one resumed onto 1 x 2 within
    1e-5."""
    cfg = f32("whisper-base")
    ocfg = adamw.OptConfig(total_steps=6, warmup_steps=2)
    dcfg = data_lib.DataConfig(vocab=cfg.vocab, seq=S, global_batch=4, seed=1)
    m22, m12 = mesh_of((2, 2)), mesh_of((1, 2))

    def manager(name, n=4, k=2):
        return CheckpointManager(CheckpointConfig(root=str(tmp_path / name), n=n, k=k,
                                                  device_direct=True), device="cpu")
    q = dict(log_every=1, save_every=3)
    full = run_training(cfg, ocfg, dcfg, 6, mesh=m22, ckpt=manager("full"),
                        log=lambda *_: None, **q)
    ck = manager("crash")
    first = run_training(cfg, ocfg, dcfg, 3, mesh=m22, ckpt=ck, log=lambda *_: None, **q)
    saved = {"params": first["params"], "opt": first["opt"], "step": np.int64(3)}
    whole = manager("whole")
    whole.save_sharded(3, _whole(saved))
    crash_files, whole_files = store_files(tmp_path / "crash"), store_files(tmp_path / "whole")
    assert whole_files and all(crash_files[k] == v for k, v in whole_files.items())
    like = {"params": M.init(0, cfg, device="meta"), "step": np.int64(0)}
    like["opt"] = adamw.init_opt(like["params"], ocfg)
    got = ck.restore_sharded(3, saved, mesh=m12,
                             shardings=sharding.state_shardings(cfg, m12, like, ocfg))
    flat_got, flat_want = devio._flatten(got)[0], devio._flatten(saved)[0]
    for a, b in zip(flat_got, flat_want):     # the step too lands on the mesh
        assert a.placement.mesh == m12
        assert torch.equal(a.full(), b.full() if isinstance(b, sharding.ShardedTensor)
                           else torch.as_tensor(b))
    lines = []
    same = run_training(cfg, ocfg, dcfg, 6, mesh=m22, ckpt=ck, log=lines.append, **q)
    assert lines[0].startswith("resuming from checkpoint step 3")
    assert same["history"] == full["history"][3:]
    for (a,), (b,) in zip(adamw._zip(same["params"]), adamw._zip(full["params"])):
        assert torch.equal(a.full(), b.full())
    ck2 = manager("crash2")
    run_training(cfg, ocfg, dcfg, 3, mesh=m22, ckpt=ck2, log=lambda *_: None, **q)
    other = run_training(cfg, ocfg, dcfg, 6, mesh=m12, ckpt=ck2, log=lambda *_: None, **q)
    assert [h["step"] for h in other["history"]] == [3, 4, 5]
    for h1, h2 in zip(full["history"][3:], other["history"]):
        for key in h1:
            np.testing.assert_allclose(h2[key], h1[key], rtol=TOL, atol=TOL, err_msg=key)
    assert_blocks(other["params"])
    assert other["params"]["embed"].placement.mesh == m12


def test_mesh_host_checkpoint_resumes(tmp_path):
    """The host route (``manager.save`` of the assembled state) from a mesh:
    a resumed run on the same mesh continues the unbroken run bit for bit."""
    cfg = f32("qwen3-1.7b")
    ocfg = adamw.OptConfig(total_steps=4, warmup_steps=1)
    dcfg = data_lib.DataConfig(vocab=cfg.vocab, seq=S, global_batch=4, seed=2)
    m = mesh_of((2, 2))

    def manager(name):
        return CheckpointManager(CheckpointConfig(root=str(tmp_path / name)), device="cpu")
    q = dict(log_every=1, save_every=2, log=lambda *_: None)
    full = run_training(cfg, ocfg, dcfg, 4, mesh=m, ckpt=manager("a"), **q)
    ck = manager("b")
    run_training(cfg, ocfg, dcfg, 2, mesh=m, ckpt=ck, **q)
    resumed = run_training(cfg, ocfg, dcfg, 4, mesh=m, ckpt=ck, **q)
    assert resumed["history"] == full["history"][2:]
