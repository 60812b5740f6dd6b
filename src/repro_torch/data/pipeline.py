"""Deterministic data pipeline with O(1) resume.

The JAX package's ``repro.data.pipeline`` on torch tensors. Two sources
behind one interface:

* ``SyntheticSource`` — step-indexed random tokens: step ``s`` draws from a
  ``torch.Generator`` seeded from ``(seed, s)``, so resuming after a crash
  is setting the step counter, with no iterator state to checkpoint. The
  reference draws from ``jax.random`` (threefry, ``fold_in(seed, step)``);
  the port cannot reproduce that stream, so its tokens are its own (equally
  deterministic per step).
* ``TokenFileSource`` — a binary token corpus (``np.memmap``). Each (step,
  row) addresses one window through the same affine shuffle as the
  reference, so the port and the JAX package read the same tokens, bit for
  bit.

``batch_for`` adds the per-architecture extras (M-RoPE position ids, the
encoder-decoder's stub frames, drawn like the synthetic tokens) and puts the
batch on the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.model import ModelConfig, resolve_device

FRAMES_SALT = 0x5EED   # the reference's seed offset for the encoder frames


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq: int
    global_batch: int
    seed: int = 0
    path: str | None = None       # None -> synthetic
    token_dtype: str = "uint16"


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step) alone."""
    state = np.random.SeedSequence((int(seed), int(step))).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 32 | int(state[1]))


class SyntheticSource:
    def __init__(self, dcfg: DataConfig, device=None):
        self.dcfg = dcfg
        self.device = resolve_device(device)

    def tokens_at(self, step: int) -> torch.Tensor:
        """(global_batch, seq+1) int32 tokens for this step, on the device."""
        d = self.dcfg
        gen = step_generator(d.seed, step, self.device)
        return torch.randint(0, d.vocab, (d.global_batch, d.seq + 1), generator=gen,
                             device=self.device, dtype=torch.int32)


class TokenFileSource:
    """Flat binary token file; window (step, row) -> [offset, offset+seq+1)."""

    def __init__(self, dcfg: DataConfig, device=None):
        assert dcfg.path is not None
        self.dcfg = dcfg
        self.device = resolve_device(device)
        self.data = np.memmap(dcfg.path, dtype=np.dtype(dcfg.token_dtype), mode="r")
        self.n_windows = (len(self.data) - 1) // (dcfg.seq + 1)
        if self.n_windows <= 0:
            raise ValueError(f"corpus too small: {len(self.data)} tokens for seq {dcfg.seq}")

    def tokens_at(self, step: int) -> torch.Tensor:
        d = self.dcfg
        # affine window shuffle: a coprime stride walks all windows before repeating
        stride = _coprime_stride(self.n_windows, d.seed)
        rows = step * d.global_batch + np.arange(d.global_batch)
        idx = (rows * stride + d.seed) % self.n_windows
        span = d.seq + 1
        out = np.stack([self.data[i * span:(i + 1) * span] for i in idx])
        return torch.from_numpy(out.astype(np.int32)).to(self.device)


def _coprime_stride(n: int, seed: int) -> int:
    s = (seed * 2654435761 + 1) % n or 1
    while np.gcd(s, n) != 1:
        s = (s + 1) % n or 1
    return s


def make_source(dcfg: DataConfig, device=None):
    return (TokenFileSource if dcfg.path else SyntheticSource)(dcfg, device)


def write_corpus(path: str, tokens: np.ndarray, token_dtype: str = "uint16") -> None:
    np.asarray(tokens, dtype=np.dtype(token_dtype)).tofile(path)


# ---------------------------------------------------------------------------
# model-ready batches
# ---------------------------------------------------------------------------


def batch_for(cfg: ModelConfig, source, step: int) -> dict[str, torch.Tensor]:
    """Next-token LM batch + per-family extras, all step-deterministic, on
    the source's device."""
    raw = source.tokens_at(step)
    batch = {"tokens": raw[:, :-1], "labels": raw[:, 1:]}
    B, S = batch["tokens"].shape
    dev = raw.device
    if cfg.mrope_sections is not None:
        batch["mrope_pos"] = torch.arange(S, dtype=torch.int32, device=dev)[None, None] \
            .expand(3, B, S)
    if cfg.family == "encdec":
        gen = step_generator(source.dcfg.seed ^ FRAMES_SALT, step, dev)
        batch["enc_frames"] = torch.randn((B, cfg.enc_ctx, cfg.d_model), generator=gen,
                                          device=dev, dtype=torch.bfloat16)
    return batch
