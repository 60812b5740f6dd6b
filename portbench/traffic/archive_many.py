"""A batch of ``batch`` objects a call archived concurrently through
``storage.multi.pipelined_encode_many`` (the paper's Fig. 4).

The pool holds ``pool_objects`` objects on the card as one (objects, k,
block_words) tensor; call i archives the ``batch`` consecutive objects that
start at a seeded cycle of offsets, a view of the pool read in place, and
returns their (batch, n, block_words) codeword rows.
"""
from __future__ import annotations

import torch

from portbench.driver import differing


class Driver:
    def __init__(self, cell):
        from repro_torch.storage import multi
        self.cell, self.entry = cell, multi.pipelined_encode_many
        self.code, self.ref = cell.program_code(), cell.reference_code()
        self.objects = int(cell.params["batch"])
        # per object k data blocks in, n codeword blocks out; the caller asked for the k
        self.needed_blocks = self.objects * (cell.k + cell.n)
        self.useful_blocks = self.objects * cell.k
        self.pool = cell.random_words(int(cell.params["pool_objects"]), cell.k)
        self.cycle = cell.order(range(self.pool.shape[0] - self.objects + 1))

    def batch(self, i: int):
        start = self.cycle[i % len(self.cycle)]
        return self.pool[start:start + self.objects]

    def call(self, i: int):
        return self.entry(self.code, self.batch(i), device=self.cell.device)

    def control(self, i: int):
        out = torch.empty((self.objects, self.cell.n, self.cell.words),
                          dtype=self.pool.dtype, device=self.pool.device)
        for b, x in enumerate(self.batch(i)):
            out[b] = self.ref.apply_narrow(self.ref.G, x)
        return out

    def check(self, i: int, out) -> tuple[int, int]:
        wrong = words = 0
        for b, x in enumerate(self.batch(i)):
            want = self.ref.encode(x)
            wrong += differing(out[b], want, self.cell.l)
            words += want.numel()
        return wrong, words


def prepare(cell) -> Driver:
    return Driver(cell)
