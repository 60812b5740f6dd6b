"""Tick ops of the PyTorch port vs the JAX package's Pallas tick kernels.

On the CPU the port's ops run the kernels' plain versions; the JAX ops run
their Pallas kernels in interpret mode, as ``tests/test_kernels.py`` does.
Tests marked ``gpu`` hold each CUDA kernel against its plain version and
skip without a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import gf, pipeline  # noqa: E402
from repro_torch.kernels.gf_encode import kernel, ops, ref  # noqa: E402

try:  # the reference; a machine with only the port installed runs the gpu tests
    import jax.numpy as jnp
    from repro.kernels.gf_encode import ops as jops
    from repro.kernels.gf_encode import ref as jref
except ImportError:
    jnp = None

C = 512   # lanes: one tile of the JAX kernels' default block


@pytest.fixture(autouse=True)
def _reference(request):
    if jnp is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference package is not installed")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def lanes(rng, shape):
    return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)


def t32(x: np.ndarray, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(device)


def u32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).view(np.uint32)


def rand_coeffs(rng, shape, l):
    return rng.integers(1, 1 << l, size=shape)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("max_b", [1, 2])
@pytest.mark.parametrize("l", [8, 16])
def test_chain_step_matches_jax(l, max_b, batched):
    rng = np.random.default_rng(3)
    O = 3 if batched else 1
    x_in = lanes(rng, (O, 1, C))
    local = lanes(rng, (O, max_b, C))
    psi, xi = rand_coeffs(rng, max_b, l), rand_coeffs(rng, max_b, l)
    bp_psi, bp_xi = gf.bitplane_table(psi, l), gf.bitplane_table(xi, l)
    if not batched:
        x_in, local = x_in[0], local[0]
    c, xo = ops.chain_step(t32(x_in), t32(local), t32(bp_psi), t32(bp_xi), l)
    jc, jxo = jops.chain_step(jnp.asarray(x_in), jnp.asarray(local),
                              jnp.asarray(bp_psi), jnp.asarray(bp_xi), l)
    np.testing.assert_array_equal(u32(c), u32(jc))
    np.testing.assert_array_equal(u32(xo), u32(jxo))
    for o in range(O):
        xs, ls = (x_in, local) if not batched else (x_in[o], local[o])
        rc, rxo = ref.chain_step_ref(t32(xs), t32(ls), psi, xi, l)
        jrc, jrxo = jref.chain_step_ref(jnp.asarray(xs), jnp.asarray(ls), psi, xi, l)
        np.testing.assert_array_equal(u32(rc), u32(jrc))
        np.testing.assert_array_equal(u32(rxo), u32(jrxo))
        np.testing.assert_array_equal(u32(c if not batched else c[o]), u32(rc))
        np.testing.assert_array_equal(u32(xo if not batched else xo[o]), u32(rxo))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("rows", [1, 4])
@pytest.mark.parametrize("l", [8, 16])
def test_repair_step_matches_jax(l, rows, batched):
    rng = np.random.default_rng(4)
    O = 2 if batched else 1
    x_in = lanes(rng, (O, rows, C))
    local = lanes(rng, (O, 1, C))
    coeffs = rand_coeffs(rng, rows, l)
    bp = gf.bitplane_table(coeffs, l)
    if not batched:
        x_in, local = x_in[0], local[0]
    got = ops.repair_step(t32(x_in), t32(local), t32(bp), l)
    want = jops.repair_step(jnp.asarray(x_in), jnp.asarray(local), jnp.asarray(bp), l)
    np.testing.assert_array_equal(u32(got), u32(want))
    for o in range(O):
        xs, ls = (x_in, local) if not batched else (x_in[o], local[o])
        r = ref.repair_step_ref(t32(xs), t32(ls[0]), coeffs, l)
        jr = jref.repair_step_ref(jnp.asarray(xs), jnp.asarray(ls[0]), coeffs, l)
        np.testing.assert_array_equal(u32(r), u32(jr))
        np.testing.assert_array_equal(u32(got if not batched else got[o]), u32(r))


def _chain_tick_case(rng, l, max_b, n=5, O=2, chunks=3, S=37, R=4):
    """A tick's operands: the objects' blocks ``src`` (O, R, S * chunks),
    read through ``slots`` (n, max_b), with a padded slot (-1) and a last
    node without psi."""
    wire_in = lanes(rng, (n + 1, O, S))
    src = lanes(rng, (O, R, S * chunks))
    slots = rng.integers(0, R, size=(n, max_b)).astype(np.int32)
    psi, xi = rand_coeffs(rng, (n, max_b), l), rand_coeffs(rng, (n, max_b), l)
    slots[n - 2, max_b - 1] = -1                       # a padded slot
    psi[n - 2, max_b - 1] = xi[n - 2, max_b - 1] = 0
    psi[n - 1] = 0                                     # a last node: no psi
    return wire_in, src, slots, psi, xi


def node_blocks(src, slots_i):
    """Node i's replica blocks (O, max_b, Bp) gathered on the host, zero
    where a slot holds no block: the JAX op's ``local``."""
    return np.where(slots_i[None, :, None] >= 0, src[:, slots_i.clip(0)], 0)


def tick_tables(psi, xi, l):
    return kernel.product_tables(gf.bitplane_table(psi, l), gf.bitplane_table(xi, l), l)


@pytest.mark.parametrize("t", [0, 3, 6])
@pytest.mark.parametrize("max_b", [1, 2])
@pytest.mark.parametrize("l", [8, 16])
def test_chain_tick_is_per_node_jax_chain_step(l, max_b, t):
    """One node-axis tick == the JAX chain step of every active node on its
    own chunk; inactive nodes and other chunks are untouched."""
    rng = np.random.default_rng(5)
    n, O, chunks, S = 5, 2, 3, 37
    wire_in, src, slots, psi, xi = _chain_tick_case(rng, l, max_b, n, O, chunks, S)
    bp_psi, bp_xi = gf.bitplane_table(psi, l), gf.bitplane_table(xi, l)
    out = torch.zeros((n, O, S * chunks), dtype=torch.int32)
    wire_out = torch.zeros((n + 1, O, S), dtype=torch.int32)
    lo, count = pipeline.active_nodes(t, n, chunks)
    ops.chain_tick(t32(wire_in), wire_out, t32(src), slots, out,
                   t32(tick_tables(psi, xi, l)), l, t, chunks, lo, count)
    want_out = np.zeros((n, O, S * chunks), np.uint32)
    want_wire = np.zeros((n + 1, O, S), np.uint32)
    for i in range(lo, lo + count):
        sl = slice((t - i) * S, (t - i + 1) * S)
        jc, jxo = jops.chain_step(jnp.asarray(wire_in[i][:, None]),
                                  jnp.asarray(node_blocks(src, slots[i])[:, :, sl]),
                                  jnp.asarray(bp_psi[i]), jnp.asarray(bp_xi[i]),
                                  l, block=S)
        want_out[i][:, sl] = np.asarray(jc)[:, 0]
        want_wire[i + 1] = np.asarray(jxo)[:, 0]
    np.testing.assert_array_equal(u32(out), want_out)
    np.testing.assert_array_equal(u32(wire_out), want_wire)


@pytest.mark.parametrize("t", [0, 3, 5])
@pytest.mark.parametrize("rows", [1, 4])
@pytest.mark.parametrize("l", [8, 16])
def test_repair_tick_is_per_node_jax_repair_step(l, rows, t):
    """One decode tick == the JAX repair step of every active node on the
    shard its row table names; the last node's sums land in the output
    chunk instead of the wire."""
    rng = np.random.default_rng(6)
    n, O, chunks, S = 4, 2, 3, 29
    wire_in = lanes(rng, (n, O, rows, S))
    shards = lanes(rng, (n + 1, O, S * chunks))
    shard_rows = np.array([2, 0, 4, 1], np.int32)
    bp = gf.bitplane_table(rand_coeffs(rng, (n, rows), l), l)
    out = torch.zeros((O, rows, S * chunks), dtype=torch.int32)
    wire_out = torch.zeros((n, O, rows, S), dtype=torch.int32)
    lo, count = pipeline.active_nodes(t, n, chunks)
    ops.repair_tick(t32(wire_in), wire_out, t32(shards), shard_rows, out,
                    t32(kernel.repair_tables(bp, l)), l, t, chunks, lo, count)
    want_out = np.zeros((O, rows, S * chunks), np.uint32)
    want_wire = np.zeros((n, O, rows, S), np.uint32)
    for i in range(lo, lo + count):
        sl = slice((t - i) * S, (t - i + 1) * S)
        acc = np.asarray(jops.repair_step(jnp.asarray(wire_in[i]),
                                          jnp.asarray(shards[shard_rows[i]][:, None, sl]),
                                          jnp.asarray(bp[i]), l, block=S))
        if i == n - 1:
            want_out[:, :, sl] = acc
        else:
            want_wire[i + 1] = acc
    np.testing.assert_array_equal(u32(out), want_out)
    np.testing.assert_array_equal(u32(wire_out), want_wire)


def test_ops_reject_bad_shapes():
    z = torch.zeros
    with pytest.raises(ValueError):
        ops.chain_step(z((2, C), dtype=torch.int32), z((1, C), dtype=torch.int32),
                       z((1, 8), dtype=torch.int32), z((1, 8), dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        ops.repair_step(z((2, C), dtype=torch.int32), z((1, C - 1), dtype=torch.int32),
                        z((2, 8), dtype=torch.int32), 8)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never compute on the CPU: they raise before building."""
    z = lambda *s: torch.zeros(s, dtype=torch.int32)
    before = kernel.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        kernel.chain_tick(z(2, 1, 4), z(3, 1, 4), z(1, 2, 8), np.array([[0], [1]]),
                          z(2, 1, 8), z(2, 1, 1, 256), 8, 0, 2, 0, 1)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.repair_tick(z(2, 1, 3, 4), z(2, 1, 3, 4), z(2, 1, 8), np.array([0, 1]),
                           z(1, 3, 8), z(2, 1, 1, 256), 8, 0, 2, 0, 1)
    assert kernel.launch_counts() == before


def test_library_path_is_keyed_on_the_sources():
    path = kernel.library_path()
    assert path.parent == kernel.BUILD_DIR and path.suffix == ".so"
    assert path == kernel.library_path()


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [3, 11])
@pytest.mark.parametrize("l", [8, 16])
def test_repair_tick_kernel_matches_plain(cuda, l, rows):
    rng = np.random.default_rng(8)
    n, O, chunks, S, t = 4, 2, 3, 1029, 4
    wire_in = t32(lanes(rng, (n, O, rows, S)), cuda)
    shards = t32(lanes(rng, (n, O, S * chunks)), cuda)
    shard_rows = np.array([3, 1, 0, 2], np.int32)
    bp = gf.bitplane_table(rand_coeffs(rng, (n, rows), l), l)
    tables = t32(kernel.repair_tables(bp, l), cuda)
    lo, count = pipeline.active_nodes(t, n, chunks)
    results = []
    for fn in (kernel.repair_tick, ref.repair_tick_ref):
        wire_out = torch.zeros_like(wire_in)
        out = torch.zeros((O, rows, S * chunks), dtype=torch.int32, device=cuda)
        fn(wire_in, wire_out, shards, shard_rows, out, tables, l, t, chunks, lo, count)
        results.append((wire_out, out))
    torch.cuda.synchronize()
    for got, want in zip(*results):
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("l", [8, 16])
def test_step_ops_on_cuda_launch_the_kernels(cuda, l):
    rng = np.random.default_rng(9)
    x_in, local = lanes(rng, (2, 1, C)), lanes(rng, (2, 2, C))
    bp_psi = gf.bitplane_table(rand_coeffs(rng, 2, l), l)
    bp_xi = gf.bitplane_table(rand_coeffs(rng, 2, l), l)
    before = kernel.launch_counts()
    c, xo = ops.chain_step(t32(x_in, cuda), t32(local, cuda), t32(bp_psi, cuda),
                           t32(bp_xi, cuda), l)
    cc, cxo = ops.chain_step(t32(x_in), t32(local), t32(bp_psi), t32(bp_xi), l)
    acc = ops.repair_step(t32(x_in[:, 0], cuda)[:, None], t32(local[:, :1], cuda),
                          t32(bp_xi[:1], cuda), l)
    cacc = ops.repair_step(t32(x_in[:, 0])[:, None], t32(local[:, :1]),
                           t32(bp_xi[:1]), l)
    after = kernel.launch_counts()
    assert after["chain_tick"] == before["chain_tick"] + 1
    assert after["repair_tick"] == before["repair_tick"] + 1
    assert torch.equal(c.cpu(), cc) and torch.equal(xo.cpu(), cxo)
    assert torch.equal(acc.cpu(), cacc)
