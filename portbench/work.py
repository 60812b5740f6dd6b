"""The work a call needs, and the card's peak: the yardstick of ``kernel_roofline``.

A call's least time on the card is the bytes its result needs over the
card's memory bandwidth: each input block read once and each output block
written once. On several cards it stays the bytes over one card's
bandwidth, card-seconds, as the kernels' times it is compared with are
summed over the cards (``tracing.reduce``'s ``kernel_s``). Nothing else is
counted:

- not the bytes the kernels move today (the chain's wires, the partial sums
  of a decode, tables re-read per tick), so a change that fuses, swaps or
  drops kernels, or that stops moving the wires, leaves the count valid and
  the share can never pass 100%;
- no operations term: no published peak prices a GF(2^l) product, and any
  price per product would be one implementation's own.

Each traffic driver counts its own call's blocks beside the operation it
defines (``needed_blocks``: blocks its result must read and write;
``useful_blocks``: blocks the caller asked for, the numerator of
``goodput_GBps``). This module turns blocks into bytes and bytes into the
least time; a block is ``block_words`` words of ``l`` bits.
"""
from __future__ import annotations

#: published peaks by ``torch.cuda.get_device_name()``: HBM bytes per second.
#: NVIDIA H100 SXM5 data sheet: 80 GB HBM3 at 3.35 TB/s (at its 700 W limit).
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def block_bytes(cfg: dict) -> int:
    return int(cfg["block_words"]) * int(cfg["l"]) // 8


def least_seconds(nbytes: int, device_name: str) -> float | None:
    """The bytes over the card's peak bandwidth; None for a card not listed."""
    peak = HBM_BYTES_PER_S.get(device_name)
    return None if peak is None else nbytes / peak
