"""The card's decode and repair chains against the JAX package's answers.

The JAX package does not run on a machine that has only the port, so its
answers on a fixed set of words are kept in ``data/repair_chain_jax.npz``
beside this file:

- for ``kernel.repair_chain`` itself, chains of shard words under a row
  table and a coefficient matrix D, with each object's sums D^T x shards
  from the JAX package's ``gf.gf_matmul_np``;
- for the entry points, three objects of RapidRAID codes over GF(2^8) and
  GF(2^16), their codewords (``encode_np``), a decodable loss of n - k
  nodes, the survivors' decode (``decode_np``) and the lost rows
  (``repair.repair_np``).

A CPU test recomputes every answer from the file's inputs with the JAX
package and holds it equal to the file; rebuild the file with
``PYTHONPATH=src python tests/test_torch_repair_chain_jax.py``. The port's
plain route (``ops.repair_chain`` and the entry points on the CPU) and, in
the ``gpu`` tests, ``kernel.repair_chain`` and the four unplaced entry points
on the card are held to the file word for word.
"""
import itertools
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import codes, gf, jitcache  # noqa: E402
from repro_torch.kernels.gf_encode import kernel, ops  # noqa: E402
from repro_torch.storage import chain, multi, repair  # noqa: E402

FILE = pathlib.Path(__file__).parent / "data" / "repair_chain_jax.npz"
CHUNKS = 3
# (l, rows, h, objects, lanes): lanes a multiple of 4 take the kernel's
# 16-byte lanes, the others its 4-byte ones
KERNEL_CASES = [(16, 11, 11, 1, 48), (16, 13, 16, 2, 39), (16, 1, 16, 3, 48),
                (8, 1, 11, 2, 39), (8, 12, 2, 1, 48), (8, 25, 5, 2, 48)]
CODE_CASES = [(8, 4, 8), (8, 4, 16), (16, 11, 16)]     # (n, k, l)
CODE_SEED, OBJECTS = 3, 3


def _kname(i):
    return "k{}_l{}_rows{}_h{}_obj{}_lanes{}".format(i, *KERNEL_CASES[i])


def _cname(n, k, l):
    return f"c_n{n}_k{k}_l{l}"


def make_inputs(seed: int = 29) -> dict:
    """The words the answers are computed on."""
    rng = np.random.default_rng(seed)
    arrays = {}
    for i, (l, rows, h, n_obj, lanes) in enumerate(KERNEL_CASES):
        R = h + 2
        arrays[_kname(i) + "_shards"] = rng.integers(
            0, 1 << l, size=(R, n_obj, gf.LANES[l] * lanes)).astype(gf.WORD_DTYPE[l])
        arrays[_kname(i) + "_rows"] = rng.choice(R, size=h, replace=False).astype(np.int32)
        D = rng.integers(1, 1 << l, size=(h, rows)).astype(np.int64)
        D[0, 0] = 0
        arrays[_kname(i) + "_D"] = D
    for n, k, l in CODE_CASES:
        B = gf.LANES[l] * CHUNKS * 8
        arrays[_cname(n, k, l) + "_data"] = rng.integers(
            0, 1 << l, size=(OBJECTS, k, B)).astype(gf.WORD_DTYPE[l])
    return arrays


def jax_answers(inputs: dict) -> dict:
    """The JAX package's answers on ``inputs``."""
    from repro.core import codes as jcodes
    from repro.core import gf as jgf
    from repro.storage import repair as jrepair

    arrays = {}
    for i, (l, *_rest) in enumerate(KERNEL_CASES):
        shards, rows_t, D = (inputs[_kname(i) + s] for s in ("_shards", "_rows", "_D"))
        arrays[_kname(i) + "_want"] = np.stack([
            jgf.gf_matmul_np(D.T, shards[rows_t, b], l) for b in range(shards.shape[1])])
    for n, k, l in CODE_CASES:
        name = _cname(n, k, l)
        jcode = jcodes.make("rapidraid", n, k, l=l, seed=CODE_SEED)
        lost = next(list(m) for m in itertools.combinations(range(n), n - k)
                    if jcode.decodable([i for i in range(n) if i not in m]))
        ids = [i for i in range(n) if i not in lost]
        cw = np.stack([jcode.encode_np(x) for x in inputs[name + "_data"]])
        arrays[name + "_lost"] = np.array(lost, dtype=np.int32)
        arrays[name + "_cw"] = cw
        arrays[name + "_decoded"] = np.stack([jcode.decode_np(ids, c[ids]) for c in cw])
        arrays[name + "_repaired"] = np.stack([jrepair.repair_np(jcode, lost, ids, c[ids])
                                               for c in cw])
    return arrays


@pytest.fixture(scope="module")
def saved():
    with np.load(FILE) as f:
        return {name: f[name] for name in f.files}


@pytest.fixture(autouse=True)
def _fresh_programs():
    jitcache.clear()
    yield
    jitcache.clear()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def kernel_operands(saved, i, device, batch):
    """(shards (R, n_obj, Bp) lanes, the row table, tables, rows, want) of
    kernel case i; ``batch`` lays the shards out (n_obj, R, Bp) and passes
    them transposed, as the multi-object entry points do."""
    l, rows = KERNEL_CASES[i][:2]
    lanes = gf.pack_u32(torch.from_numpy(saved[_kname(i) + "_shards"]), l)
    if batch:
        lanes = lanes.transpose(0, 1).contiguous().transpose(0, 1)
    D = saved[_kname(i) + "_D"]
    tables = torch.from_numpy(kernel.repair_tables(gf.bitplane_table(D, l), l).view(np.int32))
    return (lanes.to(device), saved[_kname(i) + "_rows"], tables.to(device), rows,
            saved[_kname(i) + "_want"])


def code_case(saved, n, k, l):
    name = _cname(n, k, l)
    lost = saved[name + "_lost"].tolist()
    return (codes.make("rapidraid", n, k, l=l, seed=CODE_SEED), lost,
            [i for i in range(n) if i not in lost], saved[name + "_cw"],
            saved[name + "_decoded"], saved[name + "_repaired"])


def entry_calls(code, lost, ids, cw, decoded, repaired, device):
    """The four unplaced decode and repair entry points: name -> (call, want)."""
    return {
        "pipelined_decode": (lambda: chain.pipelined_decode(
            code, ids, cw[0][ids], CHUNKS, device=device), decoded[0]),
        "pipelined_decode_many": (lambda: multi.pipelined_decode_many(
            code, ids, cw[:, ids], CHUNKS, 1, device=device), decoded),
        "pipelined_repair": (lambda: repair.pipelined_repair(
            code, ids, cw[0][ids], lost, CHUNKS, device=device), repaired[0]),
        "pipelined_repair_many": (lambda: repair.pipelined_repair_many(
            code, ids, cw[:, ids], lost, CHUNKS, 2, device=device), repaired),
    }


# ---------------------------------------------------------------------------
# the CPU
# ---------------------------------------------------------------------------


def test_the_file_holds_the_jax_package_answers(saved):
    pytest.importorskip("jax")
    inputs = {name: saved[name] for name in make_inputs()}
    answers = jax_answers(inputs)
    assert set(saved) == set(inputs) | set(answers)
    for name, want in answers.items():
        np.testing.assert_array_equal(saved[name], want, err_msg=name)
        assert saved[name].dtype == want.dtype, name


@pytest.mark.parametrize("i", range(len(KERNEL_CASES)), ids=_kname)
@pytest.mark.parametrize("batch", [False, True])
def test_plain_route_matches_the_jax_package(saved, i, batch):
    l = KERNEL_CASES[i][0]
    shards, rows_t, tables, rows, want = kernel_operands(saved, i, torch.device("cpu"), batch)
    out = torch.full((shards.shape[1], rows, shards.shape[2]), -1, dtype=torch.int32)
    ops.repair_chain(shards, rows_t, out, tables, l, CHUNKS, 1 if batch else 0)
    np.testing.assert_array_equal(gf.unpack_u32(out, l).numpy(), want)


@pytest.mark.parametrize("n,k,l", CODE_CASES)
def test_entry_points_on_the_cpu_match_the_jax_package(saved, n, k, l):
    for name, (call, want) in entry_calls(*code_case(saved, n, k, l), "cpu").items():
        np.testing.assert_array_equal(call().numpy(), want, err_msg=name)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("i", range(len(KERNEL_CASES)), ids=_kname)
@pytest.mark.parametrize("batch", [False, True])
def test_repair_chain_kernel_matches_the_jax_package(cuda, saved, i, batch):
    l = KERNEL_CASES[i][0]
    shards, rows_t, tables, rows, want = kernel_operands(saved, i, cuda, batch)
    out = torch.full((shards.shape[1], rows, shards.shape[2]), -1, dtype=torch.int32,
                     device=cuda)
    before = kernel.repair_chain.launches
    kernel.repair_chain(shards, rows_t, out, tables, l)
    torch.cuda.synchronize()
    assert kernel.repair_chain.launches == before + 1
    np.testing.assert_array_equal(gf.unpack_u32(out.cpu(), l).numpy(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,l", CODE_CASES)
def test_unplaced_entry_points_on_the_card_match_the_jax_package(cuda, saved, n, k, l):
    """Each of the four on the card, in one ``repair_chain`` launch and no
    tick, equals the JAX package's decode or repair of the same words."""
    for name, (call, want) in entry_calls(*code_case(saved, n, k, l), cuda).items():
        kernel.reset_launch_counts()
        got = call()
        torch.cuda.synchronize()
        assert got.device.type == "cuda", name
        assert kernel.launch_counts()["repair_chain"] == 1, name
        assert kernel.launch_counts()["repair_tick"] == 0, name
        np.testing.assert_array_equal(got.cpu().numpy(), want, err_msg=name)


if __name__ == "__main__":
    inputs = make_inputs()
    FILE.parent.mkdir(exist_ok=True)
    np.savez_compressed(FILE, **inputs, **jax_answers(inputs))
    print(f"wrote {FILE} ({FILE.stat().st_size} bytes)")
