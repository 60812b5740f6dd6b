"""What every traffic driver shares: the cell it serves, its seeded draws and
its data, made on the card.

A traffic driver (``traffic/<op>.py``) exposes ``prepare(cell) -> Driver``.
Its driver lays out the cell's pool of objects once, as the nodes would
hold it, and then serves calls:

- ``call(i)`` is call i's entry-point call into the program: no gather or
  copy of inputs, no synchronise (the harness times and synchronises);
- ``control(i)`` is the same answer worked out by the plain reference in
  the narrower field (the control of ``correct``, never run by the
  benchmark's own runs);
- ``check(i, out)`` compares call i's answer with the plain reference, word
  by word, and returns (words that differ, words compared).

and counts a call's work beside the operation it defines, in blocks of the
configuration: ``needed_blocks``, the blocks its result must read and write
whatever implements it (``kernel_roofline``'s yardstick, ``portbench.work``),
and ``useful_blocks``, the blocks the caller asked for (``goodput_GBps``).

Which objects call i serves is a seeded permutation of the pool that the
calls cycle through: every seed gives the same sizes, in another order.
"""
from __future__ import annotations

import random

import torch

WORD_DTYPE = {8: torch.uint8, 16: torch.uint16}
SIGNED = {8: torch.int8, 16: torch.int16}


class Cell:
    """A cell as a driver sees it: its configuration and workload files, the
    seed, the device, the plain reference module and the seeded draws."""

    def __init__(self, cfg: dict, params: dict, seed: int, device: torch.device, reference):
        self.cfg, self.params, self.seed, self.device = cfg, params, int(seed), device
        self.reference = reference
        self.n, self.k, self.l = int(cfg["n"]), int(cfg["k"]), int(cfg["l"])
        self.words = int(cfg["block_words"])
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(self.seed)
        self.rng = random.Random(f"portbench:{self.seed}")

    def program_code(self):
        """The program's code object for the configuration."""
        from repro_torch.core import codes
        return codes.make(self.cfg["family"], self.n, self.k, l=self.l,
                          seed=int(self.cfg["code_seed"]))

    def reference_code(self):
        """The plain reference's code for the configuration."""
        return self.reference.Code(self.n, self.k, self.l, int(self.cfg["code_seed"]),
                                   device=self.device)

    def random_words(self, *lead: int) -> torch.Tensor:
        """(*lead, block_words) words drawn from the seed on the device, in one call."""
        out = torch.empty(tuple(lead) + (self.words,), dtype=WORD_DTYPE[self.l],
                          device=self.device)
        if out.numel() * out.element_size() % 8:
            raise ValueError(f"blocks of {self.words} words do not fill 64-bit draws")
        out.view(torch.int64).random_(-(1 << 63), None, generator=self.gen)
        return out

    def order(self, items) -> list:
        """A seeded permutation of ``items``."""
        items = list(items)
        self.rng.shuffle(items)
        return items


def differing(a: torch.Tensor, b: torch.Tensor, l: int) -> int:
    """Words that differ between two word tensors of one shape."""
    if tuple(a.shape) != tuple(b.shape):
        raise ValueError(f"answer {tuple(a.shape)} against {tuple(b.shape)} expected")
    return int((a.view(SIGNED[l]) != b.view(SIGNED[l])).sum().item())
