"""The plain reference against hand-worked cases, and against the program's
own code objects at the configurations' sizes (the program is imported
here, in the test, and never by the reference)."""
import numpy as np
import pytest
import torch

from portbench.reference import rapidraid as ref


@pytest.mark.parametrize("l,a,b,want", [
    (8, 2, 0x80, 0x1D),          # x * x^7 = x^8 = x^4 + x^3 + x^2 + 1
    (8, 3, 3, 5),                # (x + 1)^2 = x^2 + 1
    (16, 2, 0x8000, 0x100B),     # x^16 = x^12 + x^3 + x + 1
    (16, 3, 3, 5),
    (16, 0, 0x1234, 0),
])
def test_products_hand_worked(l, a, b, want):
    F = ref.Field(l)
    assert F.mul(a, b) == want == F.mul(b, a)


@pytest.mark.parametrize("l", [8, 16])
def test_field_axioms_on_samples(l):
    F = ref.Field(l)
    rng = np.random.default_rng(1)
    for a, b, c in rng.integers(1, 1 << l, size=(200, 3)):
        a, b, c = int(a), int(b), int(c)
        assert F.mul(a, F.inv(a)) == 1
        assert F.mul(a, b ^ c) == F.mul(a, b) ^ F.mul(a, c)
        assert F.mul(F.mul(a, b), c) == F.mul(a, F.mul(b, c))


def test_decode_matrix_hand_worked():
    F = ref.Field(8)
    # [[1, 1], [1, 2]]^-1 over GF(2^8): det = 2 ^ 1 = 3, inv(3) = 0xF4,
    # the inverse is inv(3) * [[2, 1], [1, 1]]
    rank, inv = F.gauss(np.array([[1, 1], [1, 2]]))
    assert rank == 2 and F.inv(3) == 0xF4
    assert inv.tolist() == [[F.mul(0xF4, 2), 0xF4], [0xF4, 0xF4]]
    assert F.matmul(inv, [[1, 1], [1, 2]]).tolist() == [[1, 0], [0, 1]]
    assert F.gauss(np.array([[1, 2], [2, 4]]))[0] == 1


def test_generator_of_a_small_chain_by_hand():
    # (4, 3): node 0 holds block 0, node 1 blocks 1 and 0, node 2 blocks 2
    # and 1, node 3 block 2; slots in that order, the last node forwards nothing
    code = ref.Code(4, 3, 8, seed=0)
    assert code.place == [[0], [1, 0], [2, 1], [2]]
    p, x = code.psi, code.xi
    assert len(p) == 5 and len(x) == 6
    G = [[x[0], 0, 0],
         [p[0] ^ x[2], x[1], 0],
         [p[0] ^ p[2], p[1] ^ x[4], x[3]],
         [p[0] ^ p[2], p[1] ^ p[4], p[3] ^ x[5]]]
    assert code.G.tolist() == G


@pytest.mark.parametrize("n,k", [(16, 11), (8, 4)])
def test_generator_equals_the_programs(n, k):
    from repro_torch.core import codes
    prog = codes.make("rapidraid", n, k, l=16, seed=0)
    code = ref.Code(n, k, 16, seed=0)
    assert code.psi == list(prog.psi) and code.xi == list(prog.xi)
    assert (code.G == prog.G.astype(np.int64)).all()


def test_the_8_4_code_is_not_mds():
    code = ref.Code(8, 4, 16, seed=0)
    assert not code.decodable([0, 1, 4, 5])          # loss set {2, 3, 6, 7}
    assert code.decodable([0, 1, 2, 3])


@pytest.mark.parametrize("l", [8, 16])
def test_apply_against_scalar_products(l):
    F = ref.Field(l)
    code = ref.Code(8, 4, l, seed=3)
    X = torch.randint(0, 1 << l, (4, 37), dtype=torch.int32)
    out = ref.to_int32(code.apply(code.G, ref.to_words(X, l)), l)
    for i in range(8):
        for w in range(37):
            acc = 0
            for j in range(4):
                acc ^= F.mul(int(code.G[i, j]), int(X[j, w]))
            assert int(out[i, w]) == acc


def test_decode_and_repair_undo_the_encode():
    code = ref.Code(16, 11, 16, seed=0)
    data = ref.to_words(torch.randint(0, 1 << 16, (11, 64), dtype=torch.int32), 16)
    rows = code.encode(data)
    ids = [0, 1, 2, 3, 4, 9, 10, 11, 12, 13, 15]
    back = code.apply(code.decode_matrix(ids), rows[ids])
    assert torch.equal(back.view(torch.int16), data.view(torch.int16))
    helpers, R = code.repair_matrix([7], [i for i in range(16) if i != 7])
    rebuilt = code.apply(R, rows[helpers])
    assert torch.equal(rebuilt.view(torch.int16), rows[7:8].view(torch.int16))


def test_the_control_differs():
    code = ref.Code(16, 11, 16, seed=0)
    data = ref.to_words(torch.randint(0, 1 << 16, (11, 256), dtype=torch.int32), 16)
    want = code.encode(data).view(torch.int16)
    got = code.apply_narrow(code.G, data).view(torch.int16)
    assert (want != got).float().mean() > 0.9


def test_decode_from_too_few_or_dependent_survivors_raises():
    code = ref.Code(8, 4, 16, seed=0)
    with pytest.raises(ValueError):
        code.decode_matrix([0, 1, 2])
    with pytest.raises(ValueError):
        code.decode_matrix([0, 1, 4, 5])
