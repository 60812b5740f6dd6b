"""The tick kernels past their old size limits, and ``num_chunks=None``.

``chain_tick`` takes any slot count (max_b) and any number of active nodes
(a tick over more nodes than one launch takes is split into launches over
node sub-ranges); ``repair_tick`` takes any number of rows (held in
``test_torch_repair_tables.py``). The entry points take ``num_chunks=None``
as the JAX package's do, as the hand-tuned default. On the CPU the plain
versions are held against the JAX package; tests marked ``gpu`` hold the
kernels against their plain versions and skip without a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import gf, pipeline, rapidraid as rr  # noqa: E402
from repro_torch.kernels.gf_encode import kernel, ops, ref  # noqa: E402
from repro_torch.storage import chain, repair  # noqa: E402

try:  # the reference; a machine with only the port installed runs the gpu tests
    import jax.numpy as jnp
    from repro.kernels.gf_encode import ops as jops
except ImportError:
    jnp = None


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


def chain_case(rng, l, max_b, n, O, chunks, S, R=7):
    """Operands of a chain tick with max_b slots a node: the blocks read
    through slots, a padded slot (-1) and a last node without psi."""
    wire_in = lanes(rng, (n + 1, O, S))
    src = lanes(rng, (O, R, S * chunks))
    slots = rng.integers(0, R, size=(n, max_b)).astype(np.int32)
    psi = rng.integers(1, 1 << l, size=(n, max_b))
    xi = rng.integers(1, 1 << l, size=(n, max_b))
    slots[n // 2, max_b - 1] = -1
    psi[n // 2, max_b - 1] = xi[n // 2, max_b - 1] = 0
    psi[n - 1] = 0
    tables = kernel.product_tables(gf.bitplane_table(psi, l), gf.bitplane_table(xi, l), l)
    return wire_in, src, slots, tables


# ---------------------------------------------------------------------------
# num_chunks=None
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["encode", "decode", "repair"])
def test_num_chunks_none_is_the_default(entry, monkeypatch):
    """``num_chunks=None`` (every entry point's default, as in the JAX
    package) runs as ``DEFAULT_NUM_CHUNKS`` (8) chunks; bad counts still
    raise ValueError."""
    assert chain.DEFAULT_NUM_CHUNKS == 8
    code = rr.RapidRAIDCode.make(8, 4, l=16, seed=13)
    data = np.random.default_rng(2).integers(0, 1 << 16, size=(4, 8 * 2 * 6)).astype(np.uint16)
    cw = code.encode_np(data)
    lost = [0, 7]
    ids = [i for i in range(8) if i not in lost]
    run, want = {
        "encode": (lambda **kw: chain.pipelined_encode(code, data, device="cpu", **kw), cw),
        "decode": (lambda **kw: chain.pipelined_decode(code, ids, cw[ids], device="cpu", **kw),
                   data),
        "repair": (lambda **kw: repair.pipelined_repair(code, ids, cw[ids], lost, device="cpu",
                                                        **kw), cw[lost]),
    }[entry]
    seen = []
    real = pipeline.software_pipeline

    def spy(step, n, num_chunks, *args, **kwargs):
        seen.append(num_chunks)
        return real(step, n, num_chunks, *args, **kwargs)

    monkeypatch.setattr(pipeline, "software_pipeline", spy)
    for got in (run(num_chunks=None), run(num_chunks=8), run()):
        np.testing.assert_array_equal(got.numpy(), want)
    assert seen == [8, 8, 8]
    for bad in (0, -1, 5):
        with pytest.raises(ValueError):
            run(num_chunks=bad)


# ---------------------------------------------------------------------------
# chain_tick: any max_b, any node count
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("max_b", [3, 5])
@pytest.mark.parametrize("l", [8, 16])
def test_chain_step_any_max_b_matches_jax(l, max_b, batched):
    rng = np.random.default_rng(7 + max_b)
    O, C = (3 if batched else 1), 512
    x_in, local = lanes(rng, (O, 1, C)), lanes(rng, (O, max_b, C))
    bp_psi = gf.bitplane_table(rng.integers(1, 1 << l, size=max_b), l)
    bp_xi = gf.bitplane_table(rng.integers(1, 1 << l, size=max_b), l)
    if not batched:
        x_in, local = x_in[0], local[0]
    c, xo = ops.chain_step(t32(x_in), t32(local), t32(bp_psi), t32(bp_xi), l)
    jc, jxo = jops.chain_step(jnp.asarray(x_in), jnp.asarray(local), jnp.asarray(bp_psi),
                              jnp.asarray(bp_xi), l)
    np.testing.assert_array_equal(u32(c), np.asarray(jc))
    np.testing.assert_array_equal(u32(xo), np.asarray(jxo))


@pytest.mark.parametrize("max_b", [3, 5])
@pytest.mark.parametrize("l", [8, 16])
def test_chain_tick_any_max_b_is_per_node_jax_chain_step(l, max_b):
    """The plain tick at max_b slots a node == the JAX chain step of every
    active node on its gathered blocks."""
    rng = np.random.default_rng(11 + max_b)
    n, O, chunks, S, t = 5, 2, 3, 37, 3
    wire_in, src, slots, tables = chain_case(rng, l, max_b, n, O, chunks, S)
    out = torch.zeros((n, O, S * chunks), dtype=torch.int32)
    wire_out = torch.zeros((n + 1, O, S), dtype=torch.int32)
    lo, count = pipeline.active_nodes(t, n, chunks)
    ops.chain_tick(t32(wire_in), wire_out, t32(src), slots, out, t32(tables), l, t, chunks,
                   lo, count)
    bp_psi, bp_xi = ref.table_planes(t32(tables), l)
    for i in range(lo, lo + count):
        sl = slice((t - i) * S, (t - i + 1) * S)
        local = np.where(slots[i][None, :, None] >= 0, src[:, slots[i].clip(0), sl], 0)
        jc, jxo = jops.chain_step(jnp.asarray(wire_in[i][:, None]), jnp.asarray(local),
                                  jnp.asarray(bp_psi[i].numpy()), jnp.asarray(bp_xi[i].numpy()),
                                  l, block=S)
        np.testing.assert_array_equal(u32(out)[i][:, sl], np.asarray(jc)[:, 0])
        np.testing.assert_array_equal(u32(wire_out)[i + 1], np.asarray(jxo)[:, 0])


@pytest.mark.parametrize("node_lo,node_count,per,want", [
    (0, 1, 256, [(0, 1)]),
    (3, 256, 256, [(3, 256)]),
    (6, 300, 256, [(6, 256), (262, 44)]),
    (6, 300, 170, [(6, 170), (176, 130)]),     # max_b = 3: 512 // 3 nodes a launch
    (0, 300, 102, [(0, 102), (102, 102), (204, 96)]),   # max_b = 5
])
def test_launch_ranges_cover_the_tick(node_lo, node_count, per, want):
    assert kernel.launch_ranges(node_lo, node_count, per) == want


def test_a_tick_over_300_nodes_splits_into_launches():
    """The plain version of a tick over 300 active nodes (more than one
    launch of the kernel takes) == the same tick run over the kernel's
    launch sub-ranges, one after another."""
    rng = np.random.default_rng(13)
    n, O, chunks, S, l = 310, 1, 300, 2, 16
    t = 305
    lo, count = pipeline.active_nodes(t, n, chunks)
    assert count == 300
    wire_in, src, slots, tables = chain_case(rng, l, 2, n, O, chunks, S)
    outs = []
    for ranges in ([(lo, count)], kernel.launch_ranges(lo, count, 256)):
        out = torch.zeros((n, O, S * chunks), dtype=torch.int32)
        wire_out = torch.zeros((n, O, S), dtype=torch.int32)
        for a, c in ranges:
            ref.chain_tick_ref(t32(wire_in), wire_out, t32(src), slots, out, t32(tables), l,
                               t, chunks, a, c)
        outs.append((out, wire_out))
    for got, want in zip(*outs):
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("wire_rows", ["n", "n+1"])
@pytest.mark.parametrize("O", [1, 2])
@pytest.mark.parametrize("S", [37, 1000])
@pytest.mark.parametrize("l,max_b", [(8, 3), (8, 5), (8, 50), (16, 3), (16, 5), (16, 30)])
def test_chain_tick_kernel_any_max_b_matches_plain(cuda, l, max_b, S, O, wire_rows):
    """The run-time slot count instance == the plain version; 50 slots at
    GF(2^8) and 30 at GF(2^16) do not fit 48 KB of tables and are staged
    one group after another."""
    rng = np.random.default_rng(17 + max_b)
    n, chunks, t = 5, 3, 4
    wire_in, src, slots, tables = chain_case(rng, l, max_b, n, O, chunks, S)
    lo, count = pipeline.active_nodes(t, n, chunks)
    rows = n if wire_rows == "n" else n + 1
    results = []
    for fn in (kernel.chain_tick, ref.chain_tick_ref):
        out = torch.zeros((n, O, S * chunks), dtype=torch.int32, device=cuda)
        wire_out = torch.zeros((rows, O, S), dtype=torch.int32, device=cuda)
        fn(t32(wire_in, cuda), wire_out, t32(src, cuda), slots, out, t32(tables, cuda), l, t,
           chunks, lo, count)
        results.append((out, wire_out))
    torch.cuda.synchronize()
    for got, want in zip(*results):
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("max_b", [1, 2, 3])
def test_chain_tick_over_300_nodes_matches_plain(cuda, max_b):
    """A tick over 300 active nodes is ceil(300 / min(256, 512 // max_b))
    launches and == the plain version."""
    rng = np.random.default_rng(19)
    n, O, chunks, S, l, t = 310, 2, 300, 4, 8, 305
    lo, count = pipeline.active_nodes(t, n, chunks)
    wire_in, src, slots, tables = chain_case(rng, l, max_b, n, O, chunks, S)
    results = []
    for fn in (kernel.chain_tick, ref.chain_tick_ref):
        out = torch.zeros((n, O, S * chunks), dtype=torch.int32, device=cuda)
        wire_out = torch.zeros((n, O, S), dtype=torch.int32, device=cuda)
        before = kernel.chain_tick.launches
        fn(t32(wire_in, cuda), wire_out, t32(src, cuda), slots, out, t32(tables, cuda), l, t,
           chunks, lo, count)
        results.append((out, wire_out, kernel.chain_tick.launches - before))
    torch.cuda.synchronize()
    per = min(256, 512 // max_b)
    assert results[0][2] == -(-count // per) and results[1][2] == 0
    for got, want in zip(results[0][:2], results[1][:2]):
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_repair_tick_over_300_nodes_matches_plain(cuda):
    rng = np.random.default_rng(23)
    n, O, chunks, S, l, t, rows = 310, 1, 300, 8, 16, 309, 3
    lo, count = pipeline.active_nodes(t, n, chunks)
    assert count == 300
    wire_in = t32(lanes(rng, (n, O, rows, S)), cuda)
    shards = t32(lanes(rng, (n, O, S * chunks)), cuda)
    shard_rows = rng.permutation(n).astype(np.int32)
    bp = gf.bitplane_table(rng.integers(1, 1 << l, size=(n, rows)), l)
    tables = t32(kernel.repair_tables(bp, l), cuda)
    results = []
    for fn in (kernel.repair_tick, ref.repair_tick_ref):
        out = torch.zeros((O, rows, S * chunks), dtype=torch.int32, device=cuda)
        wire_out = torch.zeros_like(wire_in)
        before = kernel.repair_tick.launches
        fn(wire_in, wire_out, shards, shard_rows, out, tables, l, t, chunks, lo, count)
        results.append((out, wire_out, kernel.repair_tick.launches - before))
    torch.cuda.synchronize()
    assert results[0][2] == 2 and results[1][2] == 0
    for got, want in zip(results[0][:2], results[1][:2]):
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("max_b", [3, 5])
@pytest.mark.parametrize("l", [8, 16])
def test_chain_step_any_max_b_on_cuda_matches_cpu(cuda, l, max_b):
    rng = np.random.default_rng(29)
    x_in, local = lanes(rng, (2, 1, 1000)), lanes(rng, (2, max_b, 1000))
    bp_psi = gf.bitplane_table(rng.integers(1, 1 << l, size=max_b), l)
    bp_xi = gf.bitplane_table(rng.integers(1, 1 << l, size=max_b), l)
    got = ops.chain_step(t32(x_in, cuda), t32(local, cuda), t32(bp_psi, cuda),
                         t32(bp_xi, cuda), l)
    want = ops.chain_step(t32(x_in), t32(local), t32(bp_psi), t32(bp_xi), l)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
