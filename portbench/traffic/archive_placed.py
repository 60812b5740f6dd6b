"""A batch of ``batch`` objects a call archived in place, on the cards whose
nodes hold them, through ``storage.multi.pipelined_encode_many(...,
layout=)``: the paper's deployment (§IV) over its Fig. 4 batches.

The configuration's n nodes sit ``n / cards`` to a card in chain order on
the cell's cards (on the CPU, where the tests run, every card is the one
device). The pool holds ``pool_objects`` objects as the nodes hold them:
card c keeps, for each object, every block that one of its nodes holds,
once, in ascending order (``node_blocks``: the reference's ``placement(n,
k)`` split evenly over the cards), as one (objects, blocks, block_words)
tensor. Each block is drawn once, on the card of its first replica with
that card's generator, and copied to the card of its other replica, so the
two replicas agree. Call i archives the ``batch`` consecutive objects that
start at a seeded cycle of offsets (as ``archive_many``), views of each
card's pool read in place, and returns one (batch, n / cards, block_words)
tensor of codeword rows a card, on that card.

The check takes each object's k blocks from the pool by the reference's
placement and split, not by the program's layout, encodes them with the
plain reference on the first card, and compares each card's rows with the
reference's rows of that card's nodes, word for word.
"""
from __future__ import annotations

import torch

from portbench.driver import WORD_DTYPE, differing


def node_blocks(reference, n: int, k: int, cards: int) -> list[list[int]]:
    """The ascending object blocks that card c's nodes hold: the reference's
    placement, nodes c * n / cards onward on card c."""
    if n % cards:
        raise ValueError(f"{n} nodes do not split evenly over {cards} cards")
    place, m = reference.placement(n, k), n // cards
    return [sorted({b for i in range(c * m, (c + 1) * m) for b in place[i]})
            for c in range(cards)]


class Driver:
    def __init__(self, cell):
        from portbench.harness import SetupError
        from repro_torch.storage import chain, multi
        if not hasattr(chain, "CardLayout"):
            raise SetupError("the program has no card layout to archive resident batches "
                             "(repro_torch.storage.chain.CardLayout)")
        self.cell, self.entry = cell, multi.pipelined_encode_many
        self.code, self.ref = cell.program_code(), cell.reference_code()
        n_cards = int(cell.cfg["cards"])
        self.cards = [cell.devices[c % len(cell.devices)] for c in range(n_cards)]
        self.layout = chain.CardLayout(self.code, self.cards)
        self.blocks = node_blocks(cell.reference, cell.n, cell.k, n_cards)
        self.m = cell.n // n_cards
        # the card of each block's first replica: the first node holding it
        place = cell.reference.placement(cell.n, cell.k)
        self.homes = [next(i for i, held in enumerate(place) if j in held) // self.m
                      for j in range(cell.k)]
        self.objects = int(cell.params["batch"])
        # per object k data blocks in, n codeword blocks out; the caller asked for the k
        self.needed_blocks = self.objects * (cell.k + cell.n)
        self.useful_blocks = self.objects * cell.k
        self.pools = self._pool(int(cell.params["pool_objects"]))
        self.cycle = cell.order(range(self.pools[0].shape[0] - self.objects + 1))

    def _pool(self, objects: int) -> list[torch.Tensor]:
        """Each card's (objects, blocks, block_words) words: every block drawn
        once on its first replica's card, an object at a time, then copied
        to the other cards that hold it."""
        cell = self.cell
        pools = [torch.empty((objects, len(b), cell.words), dtype=WORD_DTYPE[cell.l], device=d)
                 for b, d in zip(self.blocks, self.cards)]
        homes = self.homes
        for c, d in enumerate(self.cards):
            rows = [self.blocks[c].index(j) for j in range(cell.k) if homes[j] == c]
            for o in range(objects if rows else 0):
                for r, words in zip(rows, cell.random_words(len(rows), device=d)):
                    pools[c][o, r].copy_(words)
        for j, h in enumerate(homes):
            for c in range(len(self.cards)):
                if c != h and j in self.blocks[c]:
                    dst, src = self.blocks[c].index(j), self.blocks[h].index(j)
                    for o in range(objects):
                        pools[c][o, dst].copy_(pools[h][o, src])
        return pools

    def start(self, i: int) -> int:
        return self.cycle[i % len(self.cycle)]

    def call(self, i: int):
        s = self.start(i)
        return self.entry(self.code, [p[s:s + self.objects] for p in self.pools],
                          layout=self.layout)

    def data(self, o: int) -> torch.Tensor:
        """Object o's k blocks on the first card, each from its first
        replica's card by the reference's placement and split."""
        return torch.stack([self.pools[h][o, self.blocks[h].index(j)].to(self.cell.device)
                            for j, h in enumerate(self.homes)])

    def _per_card(self, i: int, rows) -> list[torch.Tensor]:
        """One (batch, n / cards, block_words) tensor a card, object b's from
        ``rows(object b's data)`` (n, block_words) on the first card."""
        s, m = self.start(i), self.m
        outs = [torch.empty((self.objects, m, self.cell.words), dtype=p.dtype, device=d)
                for p, d in zip(self.pools, self.cards)]
        for b in range(self.objects):
            full = rows(self.data(s + b))
            for c, out in enumerate(outs):
                out[b] = full[c * m:(c + 1) * m].to(out.device)
        return outs

    def control(self, i: int):
        return self._per_card(i, lambda x: self.ref.apply_narrow(self.ref.G, x))

    def check(self, i: int, out) -> tuple[int, int]:
        """Rows missing, or on another card than their node's, count wrong."""
        s, m = self.start(i), self.m
        wrong = words = 0
        for b in range(self.objects):
            want = self.ref.encode(self.data(s + b))
            for c, card in enumerate(self.cards):
                got = out[c] if c < len(out) else None
                words += m * want.shape[1]
                if got is None or got.device != card:
                    wrong += m * want.shape[1]
                else:
                    wrong += differing(got[b].to(want.device), want[c * m:(c + 1) * m],
                                       self.cell.l)
        return wrong, words


def prepare(cell) -> Driver:
    return Driver(cell)
