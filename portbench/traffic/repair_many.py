"""A batch of ``batch`` objects a call repaired through
``storage.repair.pipelined_repair_many``: the row of ``lost`` failed nodes
rebuilt for every object archived on that node set.

The lost nodes are drawn from the seed and hold for the whole run. The pool
holds ``pool_objects`` objects' survivor shards on the card, (objects,
n - lost, block_words), and the rows they lost, both made from seeded data
by the plain reference's encoder, not by the program; the data itself is
not kept. Call i repairs the ``batch`` consecutive objects that start at a
seeded cycle of offsets, a view of the pool read in place, and returns
their (batch, lost, block_words) rebuilt rows.
"""
from __future__ import annotations

import torch

from portbench.driver import SIGNED, WORD_DTYPE, differing


class Driver:
    def __init__(self, cell):
        from repro_torch.storage import repair
        self.cell, self.entry = cell, repair.pipelined_repair_many
        self.code, self.ref = cell.program_code(), cell.reference_code()
        n, k = cell.n, cell.k
        self.lost = int(cell.params["lost"])
        self.objects = int(cell.params["batch"])
        # per object k helper shards in (any k survivors determine the code),
        # the lost rows out; the caller asked for the lost rows
        self.needed_blocks = self.objects * (k + self.lost)
        self.useful_blocks = self.objects * self.lost
        self.missing = sorted(cell.rng.sample(range(n), self.lost))
        self.ids = [i for i in range(n) if i not in self.missing]
        P = int(cell.params["pool_objects"])
        W = cell.words
        self.shards = torch.empty((P, len(self.ids), W), dtype=WORD_DTYPE[cell.l],
                                  device=cell.device)
        self.rows = torch.empty((P, self.lost, W), dtype=self.shards.dtype, device=cell.device)
        for o in range(P):
            data = cell.random_words(k)
            self.ref.encode(data, rows=self.ids, out=self.shards[o])
            self.ref.encode(data, rows=self.missing, out=self.rows[o])
            del data
        self.cycle = cell.order(range(P - self.objects + 1))

    def start(self, i: int) -> int:
        return self.cycle[i % len(self.cycle)]

    def call(self, i: int):
        s = self.start(i)
        return self.entry(self.code, self.ids, self.shards[s:s + self.objects], self.missing,
                          device=self.cell.device)

    def control(self, i: int):
        helpers, R = self.ref.repair_matrix(self.missing, self.ids)
        take = torch.tensor([self.ids.index(h) for h in helpers], device=self.shards.device)
        s = self.start(i)
        out = torch.empty((self.objects, self.lost, self.cell.words),
                          dtype=self.shards.dtype, device=self.shards.device)
        for b in range(self.objects):
            helper_shards = self.shards[s + b].view(SIGNED[self.cell.l]).index_select(0, take)
            out[b] = self.ref.apply_narrow(R, helper_shards.view(self.shards.dtype))
        return out

    def check(self, i: int, out) -> tuple[int, int]:
        s = self.start(i)
        want = self.rows[s:s + self.objects]
        return differing(out, want, self.cell.l), want.numel()


def prepare(cell) -> Driver:
    return Driver(cell)
