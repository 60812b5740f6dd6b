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

A cell of several cards (``chips`` > 1) runs on ``cuda:0`` … ``cuda:{chips-1}``
(``Cell.devices``). Its call leaves its work ordered on each card's current
stream, as a PyTorch op does, with any side stream it uses joined back to
that card's current stream before it returns: the harness times a call to
the end of the work on every card's current stream, and synchronises every
card after it.

Which objects call i serves is a seeded permutation of the pool that the
calls cycle through: every seed gives the same sizes, in another order.
"""
from __future__ import annotations

import random

import torch

WORD_DTYPE = {8: torch.uint8, 16: torch.uint16}
SIGNED = {8: torch.int8, 16: torch.int16}


def cards(devices) -> list[torch.device]:
    """``devices`` as a list: one device, or a cell's cards in order."""
    return [devices] if isinstance(devices, torch.device) else list(devices)


class Cell:
    """A cell as a driver sees it: its configuration and workload files, the
    seed, its devices (``device`` is the first), the plain reference module
    and the seeded draws."""

    def __init__(self, cfg: dict, params: dict, seed: int, devices, reference):
        self.cfg, self.params, self.seed = cfg, params, int(seed)
        self.devices = cards(devices)
        self.device = self.devices[0]
        self.reference = reference
        self.n, self.k, self.l = int(cfg["n"]), int(cfg["k"]), int(cfg["l"])
        self.words = int(cfg["block_words"])
        # a generator a device: the first draws from the seed itself, as a
        # one-card cell always has; device c from the seed and c (seeds stay
        # below 2**40, so no two of them meet)
        self.gens = []
        for c, d in enumerate(self.devices):
            g = torch.Generator(device=d)
            g.manual_seed(self.seed + (c << 40))
            self.gens.append(g)
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

    def random_words(self, *lead: int, device: torch.device | None = None) -> torch.Tensor:
        """(*lead, block_words) words drawn from the seed on ``device`` (one of
        the cell's, the first by default) with that device's generator, in
        one call."""
        c = 0 if device is None else self.devices.index(torch.device(device))
        out = torch.empty(tuple(lead) + (self.words,), dtype=WORD_DTYPE[self.l],
                          device=self.devices[c])
        if out.numel() * out.element_size() % 8:
            raise ValueError(f"blocks of {self.words} words do not fill 64-bit draws")
        out.view(torch.int64).random_(-(1 << 63), None, generator=self.gens[c])
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
