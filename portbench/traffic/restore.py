"""One object a call read back through ``storage.chain.pipelined_decode``
from the k survivors of ``lost`` failed nodes: a degraded read at the most
losses the code survives.

The loss set is drawn from the seed among the decodable sets of ``lost``
nodes and holds for the whole run: a failure takes the same rows from every
object on that node set. The pool holds ``pool_objects`` objects' survivor
shards on the card, (objects, k, block_words), made from seeded data by the
plain reference's encoder, not by the program. Call i reads one object of a
seeded cycle and returns its (k, block_words) data blocks, which must equal
the data it was made from.
"""
from __future__ import annotations

import torch

from portbench.driver import differing


class Driver:
    def __init__(self, cell):
        from repro_torch.storage import chain
        self.cell, self.entry = cell, chain.pipelined_decode
        self.code, self.ref = cell.program_code(), cell.reference_code()
        n, k = cell.n, cell.k
        # k survivor shards in, k data blocks out; the caller asked for the k
        self.needed_blocks, self.useful_blocks = k + k, k
        lost = int(cell.params["lost"])
        if n - lost != k:
            raise ValueError(f"a restore cell reads from exactly k={k} survivors")
        while True:        # a seeded draw among the decodable loss sets
            gone = set(cell.rng.sample(range(n), lost))
            self.ids = [i for i in range(n) if i not in gone]
            if self.ref.decodable(self.ids):
                break
        P = int(cell.params["pool_objects"])
        self.data = cell.random_words(P, k)
        self.shards = torch.empty_like(self.data)
        for o in range(P):
            self.ref.encode(self.data[o], rows=self.ids, out=self.shards[o])
        self.cycle = cell.order(range(P))

    def obj(self, i: int) -> int:
        return self.cycle[i % len(self.cycle)]

    def call(self, i: int):
        return self.entry(self.code, self.ids, self.shards[self.obj(i)], device=self.cell.device)

    def control(self, i: int):
        return self.ref.apply_narrow(self.ref.decode_matrix(self.ids), self.shards[self.obj(i)])

    def check(self, i: int, out) -> tuple[int, int]:
        want = self.data[self.obj(i)]
        return differing(out, want, self.cell.l), want.numel()


def prepare(cell) -> Driver:
    return Driver(cell)
