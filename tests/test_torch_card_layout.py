"""A batch archived where the nodes hold it: ``chain.CardLayout`` and
``multi.pipelined_encode_many(..., layout=)``.

On the CPU every card of a layout is the one CPU device, so the grouped
ticks and the hops between cards run as they do across cards, each hop a
copy on the device's stream. The rows are held bit for bit against the
unplaced call and against the benchmark's plain reference
(``portbench/reference/rapidraid.py``), and the hops' counter against the
bytes a batch's wire carries across the card boundaries. ``gpu`` tests run
the layout on four cards of a host (peer copies ordered by events) and on
one card shared by four groups.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import codes, gf, pipeline  # noqa: E402
from repro_torch.kernels.gf_encode import kernel, ops  # noqa: E402
from repro_torch.storage import chain, multi  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from portbench.reference import rapidraid as plain  # noqa: E402

CODES = [(16, 11, 16), (8, 4, 16), (8, 4, 8)]
WORDS = 256           # words a block in the CPU tests


def code_of(n, k, l):
    return codes.make("rapidraid", n, k, l=l, seed=0)


def batch(rng, B_obj, k, l, words=WORDS):
    return torch.from_numpy(rng.integers(0, 1 << l, size=(B_obj, k, words))
                            .astype(gf.WORD_DTYPE[l]))


def resident(layout, data):
    """``data`` (B_obj, k, B) as the cards hold it: card c's blocks, in order."""
    return [data[:, list(b)].contiguous().to(d) for b, d in zip(layout.blocks, layout.cards)]


def reference_rows(n, k, l, data):
    """(B_obj, n, B) codeword rows of the plain reference, on the CPU."""
    ref = plain.Code(n, k, l, 0)
    return torch.stack([ref.encode(x) for x in data.cpu()])


@pytest.mark.parametrize("n,k,cards,want", [
    (16, 11, 4, [(0, 1, 2, 3), (0, 1, 2, 4, 5, 6, 7), (3, 4, 5, 6, 8, 9, 10), (7, 8, 9, 10)]),
    (8, 4, 4, [(0, 1), (2, 3), (0, 1), (2, 3)]),
    (16, 11, 2, [(0, 1, 2, 3, 4, 5, 6, 7), (3, 4, 5, 6, 7, 8, 9, 10)]),
])
def test_layout_blocks_once_a_card(n, k, cards, want):
    code = code_of(n, k, 16)
    layout = chain.CardLayout(code, ["cpu"] * cards)
    assert [tuple(b) for b in layout.blocks] == want
    slots = chain.placement_slots(code)
    for c, g in enumerate(layout.groups):
        assert (g.first, g.count) == (c * n // cards, n // cards)
        local = layout.slots[c]
        assert not local.flags.writeable and local.shape == (g.count, slots.shape[1])
        # renumbered on the card: the same blocks, each held once
        back = np.where(local >= 0, np.asarray(layout.blocks[c])[local.clip(0)], -1)
        np.testing.assert_array_equal(back, slots[g.first:g.first + g.count])
        assert len(set(layout.blocks[c])) == len(layout.blocks[c])


@pytest.mark.parametrize("num_chunks", [2, 8])
@pytest.mark.parametrize("stagger", [1, 2])
@pytest.mark.parametrize("cards", [2, 4])
@pytest.mark.parametrize("n,k,l", CODES)
def test_resident_encode_matches_unplaced_and_reference(n, k, l, cards, stagger, num_chunks):
    code = code_of(n, k, l)
    rng = np.random.default_rng([n, k, l, cards, stagger, num_chunks])
    B_obj = 5
    data = batch(rng, B_obj, k, l)
    layout = chain.CardLayout(code, ["cpu"] * cards)
    want = multi.pipelined_encode_many(code, data, num_chunks=num_chunks, stagger=stagger,
                                       device="cpu")
    np.testing.assert_array_equal(want.numpy(), reference_rows(n, k, l, data).numpy())
    pipeline.reset_stats()
    got = multi.pipelined_encode_many(code, resident(layout, data), num_chunks=num_chunks,
                                      stagger=stagger, layout=layout)
    hopped = pipeline.stats()["wire_bytes_hopped"]
    assert len(got) == cards
    for g, rows in zip(layout.groups, got):
        assert rows.shape == (B_obj, g.count, WORDS) and rows.dtype == gf.TORCH_WORD_DTYPE[l]
        np.testing.assert_array_equal(rows.numpy(), want[:, g.first:g.first + g.count].numpy())
    assert hopped == (cards - 1) * B_obj * WORDS * l // 8


def test_one_launch_a_card_a_tick(monkeypatch):
    code = code_of(16, 11, 16)
    layout = chain.CardLayout(code, ["cpu"] * 4)
    B_obj, C, s = 4, 4, 1
    launches = []
    real = ops.chain_tick

    def spy(wire_in, wire_out, src, slots, out, tables, l, t, num_chunks, lo, count, stagger):
        # a card's launch: its four nodes' operands, local nodes and tick
        assert out.shape[0] == slots.shape[0] == tables.shape[0] == 4 and lo + count <= 4
        assert src.shape[1] in {len(b) for b in layout.blocks}
        launches.append((t, lo, count))
        return real(wire_in, wire_out, src, slots, out, tables, l, t, num_chunks, lo, count,
                    stagger)
    monkeypatch.setattr(ops, "chain_tick", spy)
    data = batch(np.random.default_rng(0), B_obj, 11, 16)
    multi.pipelined_encode_many(code, resident(layout, data), num_chunks=C, stagger=s,
                                layout=layout)
    want = 0
    for t in range(pipeline.num_ticks_many(C, 16, B_obj, s)):
        lo, count = pipeline.active_nodes_many(t, 16, C, B_obj, s)
        want += sum(max(lo, g.first) < min(lo + count, g.first + g.count)
                    for g in layout.groups)
    assert len(launches) == want


@pytest.mark.parametrize("first,count,W,want", [
    (0, 4, 4, [(0, 4)]), (5, 3, 4, [(1, 3)]), (6, 4, 8, [(6, 2), (0, 2)]), (3, 0, 4, []),
])
def test_slot_runs(first, count, W, want):
    assert pipeline.slot_runs(first, count, W) == want


def test_active_objects_are_the_ones_with_a_chunk():
    C, B_obj, s = 5, 7, 2
    for t in range(pipeline.num_ticks_many(C, 6, B_obj, s)):
        for i in range(6):
            lo, count = pipeline.active_objects(t, i, C, B_obj, s)
            want = [b for b in range(B_obj) if 0 <= t - i - b * s < C]
            assert list(range(lo, lo + count)) == want


def test_layout_rejects_what_it_cannot_run():
    code = code_of(16, 11, 16)
    with pytest.raises(ValueError, match="split evenly"):
        chain.CardLayout(code, ["cpu"] * 3)
    layout = chain.CardLayout(code, ["cpu"] * 4)
    xs = resident(layout, batch(np.random.default_rng(1), 2, 11, 16))
    with pytest.raises(ValueError, match="superchunk_words"):
        multi.pipelined_encode_many(code, xs, superchunk_words=64, layout=layout)
    with pytest.raises(ValueError, match="device"):
        multi.pipelined_encode_many(code, xs, device="cpu", layout=layout)
    wrong = list(xs)
    wrong[1] = wrong[1][:, :6]
    with pytest.raises(ValueError, match="card 1"):
        multi.pipelined_encode_many(code, wrong, layout=layout)
    wrong = list(xs)
    wrong[2] = wrong[2][:1]
    with pytest.raises(ValueError, match="card 2"):
        multi.pipelined_encode_many(code, wrong, layout=layout)
    with pytest.raises(ValueError, match="one tensor a card"):
        multi.pipelined_encode_many(code, xs[0], layout=layout)
    with pytest.raises(ValueError, match="another code"):
        multi.pipelined_encode_many(code_of(8, 4, 16), xs, layout=layout)


def test_copy_async_takes_cuda_tensors_only():
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.copy_async(torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
                          None)


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["four cards", "one card"])
def test_resident_encode_on_the_cards(where):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if where == "four cards" and torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    cards = ([torch.device("cuda", c) for c in range(4)] if where == "four cards"
             else [torch.device("cuda", 0)] * 4)
    n, k, l = 16, 11, 16
    code = code_of(n, k, l)
    layout = chain.CardLayout(code, cards)
    B_obj, words = 6, 1 << 16
    data = batch(np.random.default_rng(7), B_obj, k, l, words)
    want = reference_rows(n, k, l, data)
    for stagger, num_chunks in ((1, 8), (2, 4), (1, 1)):
        pipeline.reset_stats()
        got = multi.pipelined_encode_many(code, resident(layout, data), num_chunks=num_chunks,
                                          stagger=stagger, layout=layout)
        for d in set(cards):
            torch.cuda.synchronize(d)
        assert pipeline.stats()["wire_bytes_hopped"] == 3 * B_obj * words * l // 8
        for g, rows, d in zip(layout.groups, got, cards):
            assert rows.device == d
            np.testing.assert_array_equal(rows.cpu().numpy(),
                                          want[:, g.first:g.first + g.count].numpy())
    unplaced = multi.pipelined_encode_many(code, data.to(cards[0]), device=cards[0])
    np.testing.assert_array_equal(unplaced.cpu().numpy(), want.numpy())


@pytest.mark.gpu
def test_copy_async_between_cards():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    other = torch.device("cuda", min(1, torch.cuda.device_count() - 1))
    src = torch.arange(1 << 20, dtype=torch.int32, device="cuda:0")
    dst = torch.zeros(1 << 20, dtype=torch.int32, device=other)
    stream = torch.cuda.current_stream(other)
    stream.wait_stream(torch.cuda.current_stream(src.device))
    kernel.copy_async(dst, src, stream)
    torch.cuda.synchronize(other)
    assert torch.equal(dst.cpu(), src.cpu())
