"""PyTorch port's RapidRAID codes vs the JAX package's (host numpy math)."""
import dataclasses
import itertools

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import gf as jgf  # noqa: E402
from repro.core import rapidraid as jrr  # noqa: E402
from repro.core.codes import CodeSpec as JCodeSpec  # noqa: E402
from repro_torch.core import rapidraid as rr  # noqa: E402
from repro_torch.core.codes import CodeSpec  # noqa: E402

GEOMETRIES = [(8, 4), (6, 4), (16, 11)]


@pytest.mark.parametrize("l", [8, 16])
@pytest.mark.parametrize("n,k", GEOMETRIES)
def test_code_and_schedule_match(n, k, l):
    got = rr.RapidRAIDCode.make(n, k, l=l, seed=13)
    want = jrr.RapidRAIDCode.make(n, k, l=l, seed=13)
    assert (got.psi, got.xi) == (want.psi, want.xi)
    np.testing.assert_array_equal(got.G, want.G)
    assert got.G.dtype == want.G.dtype
    for field in ("local_blocks", "block_valid", "psi", "xi"):
        np.testing.assert_array_equal(getattr(got.chain, field),
                                      getattr(want.chain, field))
    assert got.chain.max_blocks == want.chain.max_blocks
    assert got.spec.to_manifest() == want.spec.to_manifest()
    assert got.place == want.place
    assert rr.coeff_slots(n, k) == jrr.coeff_slots(n, k)


@pytest.mark.parametrize("n,k,l", [(8, 4, 8), (16, 11, 16), (6, 4, 16)])
def test_code_from_reference_reproduces_jax_code(n, k, l):
    ref = jrr.RapidRAIDCode.make(n, k, l=l, seed=21)
    got = rr.code_from_reference(dataclasses.asdict(ref))
    assert got == rr.RapidRAIDCode.make(n, k, l=l, seed=21)
    np.testing.assert_array_equal(got.G, ref.G)
    assert got.cache_key == got.spec          # canonical draw: keyed by spec
    # hand-picked coefficients carry over too, and key caches by themselves
    hand = jrr.RapidRAIDCode(n=n, k=k, l=l, psi=tuple(range(1, len(ref.psi) + 1)),
                             xi=ref.xi, seed=21)
    got_hand = rr.code_from_reference(dataclasses.asdict(hand))
    np.testing.assert_array_equal(got_hand.G, hand.G)
    assert got_hand.cache_key is got_hand


def test_code_from_reference_rejects_bad_records():
    good = dataclasses.asdict(jrr.RapidRAIDCode.make(8, 4, l=8, seed=0))
    with pytest.raises(ValueError):
        rr.code_from_reference({**good, "psi": good["psi"][:-1]})
    with pytest.raises(ValueError):
        rr.code_from_reference({**good, "xi": (0,) + tuple(good["xi"][1:])})
    with pytest.raises(ValueError):
        rr.code_from_reference({**good, "l": 12})
    with pytest.raises(ValueError):
        rr.placement(9, 4)


def test_spec_manifest_round_trip():
    spec = rr.RapidRAIDCode.make(16, 11, l=16, seed=3).spec
    assert CodeSpec.from_manifest(spec.to_manifest()) == spec
    legacy = {"n": 8, "k": 4, "l": 8}
    assert (CodeSpec.from_manifest(legacy).to_manifest()
            == JCodeSpec.from_manifest(legacy).to_manifest())


def _undecodable_set(code):
    for ids in itertools.combinations(range(code.n), code.k):
        if not code.decodable(ids):
            return list(ids)
    raise AssertionError("every k-subset decodes")


@pytest.mark.parametrize("n,k,l", [(8, 4, 16), (16, 11, 8)])
def test_decode_matrix_and_decodability_match(n, k, l):
    got = rr.RapidRAIDCode.make(n, k, l=l, seed=13)
    want = jrr.RapidRAIDCode.make(n, k, l=l, seed=13)
    ids = [0, 2, 3, 6, 7] if n == 8 else [0, 1, 2, 3, 4, 6, 8, 10, 12, 14, 15]
    np.testing.assert_array_equal(got.decode_matrix(ids), want.decode_matrix(ids))
    bad = _undecodable_set(want)
    with pytest.raises(ValueError):
        got.decode_matrix(bad)
    assert not got.decodable(bad)
    rng = np.random.default_rng(0)
    data = rng.integers(0, 1 << l, size=(k, 64)).astype(jgf.WORD_DTYPE[l])
    cw = got.encode_np(data)
    np.testing.assert_array_equal(cw, want.encode_np(data))
    np.testing.assert_array_equal(got.decode_np(ids, cw[ids]), data)


@pytest.mark.parametrize("n,k", [(8, 4), (6, 4)])
def test_decodable_and_max_losses_match(n, k):
    got = rr.RapidRAIDCode.make(n, k, l=8, seed=13)
    want = jrr.RapidRAIDCode.make(n, k, l=8, seed=13)
    for ids in itertools.combinations(range(n), k):
        assert got.decodable(ids) == want.decodable(ids), ids
    assert got.max_tolerated_losses() == want.max_tolerated_losses()


@pytest.mark.parametrize("num_chunks,stagger", [(4, 1), (4, 3), (2, 2)])
def test_tick_oracle_matches_jax(num_chunks, stagger):
    got_code = rr.RapidRAIDCode.make(6, 4, l=16, seed=13)
    want_code = jrr.RapidRAIDCode.make(6, 4, l=16, seed=13)
    rng = np.random.default_rng(1)
    objs = rng.integers(0, 1 << 16, size=(3, 4, 8 * num_chunks)).astype(np.uint16)
    got, ticks = rr.pipeline_encode_local_many(got_code, objs, num_chunks, stagger)
    want, want_ticks = jrr.pipeline_encode_local_many(want_code, objs,
                                                       num_chunks, stagger)
    np.testing.assert_array_equal(got, want)
    assert ticks == want_ticks
    one, one_ticks = rr.pipeline_encode_local(got_code, objs[0], num_chunks)
    np.testing.assert_array_equal(one, got_code.encode_np(objs[0]))
    assert one_ticks == num_chunks + 6 - 1
