"""Pipeline parallelism of the PyTorch port (``train.pipeline_parallel``).

The JAX package's case (``tests/test_pipeline_parallel.py``): 4 stages of a
residual MLP block, 8 microbatches, batch 16, width 32, from the same
seeded numpy parameters. On the CPU the stages sit on a mesh of
``["cpu"] * 4``; the forward must match the sequential stack within
rtol = atol = 1e-5 and the gradients within rtol 1e-4 / atol 1e-5, and
both must match the JAX package's ``make_pipeline_fn``, run as its own test
runs it (a subprocess with 4 host devices). ``gpu`` tests run the stages
on ``[cuda:0] * 4``, and over the cards of a host with several, against
the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import DeviceMesh  # noqa: E402
from repro_torch.train import pipeline_parallel as pp  # noqa: E402

try:  # the reference's multi-device runner (absent where only the port is installed)
    import jax  # noqa: F401

    from tests.subproc import run_with_devices
except ImportError:
    run_with_devices = None

N_STAGES, N_MICRO, B, D = 4, 8, 16, 32


def case(seed=0, n_stages=N_STAGES):
    rng = np.random.default_rng(seed)
    return {"w1": (rng.standard_normal((n_stages, D, 2 * D)) * 0.1).astype(np.float32),
            "w2": (rng.standard_normal((n_stages, 2 * D, D)) * 0.1).astype(np.float32),
            "x": rng.standard_normal((B, D)).astype(np.float32),
            "target": rng.standard_normal((B, D)).astype(np.float32)}


def stage_fn(params, x):          # one residual MLP block per stage
    return x + torch.tanh(x @ params["w1"]) @ params["w2"]


def loss_of(y, t):
    return torch.mean((y - t) ** 2)


def ref_apply(stacked, x):
    for s in range(stacked["w1"].shape[0]):
        x = stage_fn({k: v[s] for k, v in stacked.items()}, x)
    return x


def stage_mesh(devices):
    return DeviceMesh((pp.AXIS,), (len(devices),), devices)


def run(c, device, n_micro=N_MICRO, mesh_devices=None):
    """(y, grads) of the pipelined apply and loss, params on ``device``."""
    n = c["w1"].shape[0]
    mesh = stage_mesh(mesh_devices or [device] * n)
    stacked = {k: torch.tensor(c[k], device=device, requires_grad=True) for k in ("w1", "w2")}
    x, t = torch.tensor(c["x"], device=device), torch.tensor(c["target"], device=device)
    y = pp.make_pipeline_fn(stage_fn, mesh, n_micro)(stacked, x)
    loss = pp.pipeline_loss_fn(stage_fn, mesh, n_micro, loss_of)(stacked, x, t)
    loss.backward()
    return y.detach(), {k: v.grad for k, v in stacked.items()}


def reference(c):
    stacked = {k: torch.tensor(c[k], requires_grad=True) for k in ("w1", "w2")}
    y = ref_apply(stacked, torch.tensor(c["x"]))
    loss_of(y, torch.tensor(c["target"])).backward()
    return y.detach(), {k: v.grad for k, v in stacked.items()}


@pytest.mark.parametrize("n_stages", [1, 2, 4])
@pytest.mark.parametrize("n_micro", [1, 2, 8])
def test_pipeline_matches_sequential(n_stages, n_micro):
    c = case(n_stages=n_stages)
    y, g = run(c, "cpu", n_micro)
    y_ref, g_ref = reference(c)
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5)
    for k in g_ref:
        torch.testing.assert_close(g[k], g_ref[k], rtol=1e-4, atol=1e-5)


def test_output_on_x_device_and_errors():
    c = case()
    y, _ = run(c, "cpu")
    assert y.device.type == "cpu" and y.shape == (B, D)
    mesh = stage_mesh(["cpu"] * N_STAGES)
    stacked = {k: torch.tensor(c[k]) for k in ("w1", "w2")}
    with pytest.raises(ValueError, match="microbatches"):
        pp.make_pipeline_fn(stage_fn, mesh, 3)(stacked, torch.tensor(c["x"]))
    with pytest.raises(ValueError, match="stages"):
        pp.make_pipeline_fn(stage_fn, stage_mesh(["cpu"] * 2), 2)(stacked, torch.tensor(c["x"]))
    with pytest.raises(ValueError, match="'stage' axis"):
        pp.make_pipeline_fn(stage_fn, DeviceMesh(("data",), (4,), ["cpu"] * 4), 2)


JAX_SNIPPET = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.train import pipeline_parallel as pp

c = dict(np.load(sys.argv[1]))
n = c["w1"].shape[0]
mesh = Mesh(np.asarray(jax.devices()[:n]), (pp.AXIS,))

def stage_fn(params, x):
    return x + jnp.tanh(x @ params["w1"]) @ params["w2"]

def loss_of(y, t):
    return jnp.mean((y - t) ** 2)

stacked = jax.device_put({"w1": c["w1"], "w2": c["w2"]}, NamedSharding(mesh, P(pp.AXIS)))
y = jax.jit(pp.make_pipeline_fn(stage_fn, mesh, int(c["n_micro"])))(stacked, c["x"])
g = jax.jit(jax.grad(pp.pipeline_loss_fn(stage_fn, mesh, int(c["n_micro"]), loss_of)))(
    stacked, c["x"], c["target"])
np.savez(sys.argv[2], y=np.asarray(y), w1=np.asarray(g["w1"]), w2=np.asarray(g["w2"]))
"""


@pytest.mark.skipif(run_with_devices is None, reason="the JAX reference is not installed")
def test_pipeline_matches_jax_make_pipeline_fn(tmp_path):
    c = case(seed=1)
    np.savez(tmp_path / "in.npz", n_micro=N_MICRO, **c)
    run_with_devices(JAX_SNIPPET.replace("sys.argv[1]", repr(str(tmp_path / "in.npz")))
                     .replace("sys.argv[2]", repr(str(tmp_path / "out.npz"))), ndev=N_STAGES)
    want = np.load(tmp_path / "out.npz")
    y, g = run(c, "cpu")
    np.testing.assert_allclose(y.numpy(), want["y"], rtol=1e-5, atol=1e-5)
    for k in ("w1", "w2"):
        np.testing.assert_allclose(g[k].numpy(), want[k], rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_pipeline_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    c = case(seed=2)
    y, g = run(c, "cuda")
    y_cpu, g_cpu = run(c, "cpu")
    assert y.device.type == "cuda"
    torch.testing.assert_close(y.cpu(), y_cpu, rtol=1e-5, atol=1e-5)
    for k in g_cpu:
        torch.testing.assert_close(g[k].cpu(), g_cpu[k], rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_pipeline_across_cards_matches_the_cpu():
    """Stage s on card s % count: activations cross by peer copies, the
    backward through them, and the output comes back on x's card."""
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two or more CUDA cards")
    torch.backends.cuda.matmul.allow_tf32 = False
    c = case(seed=3)
    y, g = run(c, "cuda:0", mesh_devices=[f"cuda:{s % count}" for s in range(N_STAGES)])
    y_cpu, g_cpu = run(c, "cpu")
    assert y.device == torch.device("cuda", 0)
    torch.testing.assert_close(y.cpu(), y_cpu, rtol=1e-5, atol=1e-5)
    for k in g_cpu:
        torch.testing.assert_close(g[k].cpu(), g_cpu[k], rtol=1e-4, atol=1e-5)
