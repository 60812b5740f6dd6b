"""The yardstick of kernel_roofline and goodput_GBps: the blocks a call's
result needs and the blocks its caller asked for, as each traffic driver
counts them, in bytes at the cells' own 64 MiB blocks."""
import json

import pytest
import torch
from conftest import ROOT

from portbench import harness, work

H100 = "NVIDIA H100 80GB HBM3"
BLOCK = 67_108_864


def counted(cell):
    """The cell's driver at blocks of 1024 words (the counts are in blocks,
    whatever their size) and the configuration at its own size."""
    spec = harness.Spec(cell, overrides={"block_words": 1024})
    harness.import_program()
    drv = harness.prepare(spec, 2**31 + 17, torch.device("cpu"))
    full = json.loads((ROOT / "portbench" / "configs" / f"{spec.entry['config']}.json").read_text())
    return drv, full


@pytest.mark.parametrize("cell,blocks,nbytes,ms,useful", [
    ("rr16-archive-16", 16 * (11 + 16), 28_991_029_248, 8.654, 16 * 11),
    ("rr16-restore-1", 11 + 11, 1_476_395_008, 0.441, 11),
    ("rr16-repair-16", 16 * (11 + 1), 12_884_901_888, 3.846, 16),
])
def test_bytes_of_each_cell(cell, blocks, nbytes, ms, useful):
    drv, full = counted(cell)
    assert work.block_bytes(full) == BLOCK
    assert drv.needed_blocks == blocks and drv.needed_blocks * BLOCK == nbytes
    assert round(work.least_seconds(nbytes, H100) * 1e3, 3) == ms
    assert drv.useful_blocks == useful


def test_unknown_card():
    assert work.least_seconds(1, "a card not listed") is None
