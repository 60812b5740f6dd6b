"""Serving driver: batched prefill + greedy decode with a KV cache.

    python -m repro_torch.launch.serve --arch qwen3-1.7b [--smoke]
        [--batch 4] [--prompt-len 32] [--max-new 32] [--device cuda]

The JAX package's ``repro.launch.serve`` on the port: prefill builds the
cache, decode extends it token by token. The weights are cast to the
compute dtype once per ``generate`` (an eager decode loop would otherwise
copy the whole model at every token); random weights and prompts come from
explicit ``torch.Generator`` s on the device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import model as model_lib
from repro_torch.train import steps


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(cfg, params, prompts: torch.Tensor, max_new: int,
             enc_frames=None) -> tuple[np.ndarray, dict]:
    """prompts (B, S_prompt) int32 -> (B, S_prompt + max_new) tokens, greedy,
    on the prompts' device."""
    B, S = prompts.shape
    dev = prompts.device
    horizon = S + max_new
    pf_kwargs = {}
    if cfg.mrope_sections is not None:
        pf_kwargs["mrope_pos"] = torch.arange(S, dtype=torch.int32, device=dev)[
            None, None].expand(3, B, S)
    if cfg.family == "encdec":
        pf_kwargs["enc_frames"] = enc_frames

    params = model_lib.cast_params(params, cfg)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model_lib.prefill(params, cfg, prompts, **pf_kwargs)
    cache = model_lib.extend_cache(cache, horizon)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    serve_step = steps.build_serve_step(cfg)
    token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    out = [token]
    t0 = time.perf_counter()
    for i in range(max_new - 1):
        token, _, cache = serve_step(params, cache, token, S + i)
        out.append(token)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    gen = torch.cat([prompts.to(torch.int32)] + out, dim=1).cpu().numpy()
    stats = {"prefill_s": t_prefill, "decode_s": t_decode,
             "decode_tok_per_s": B * (max_new - 1) / max(t_decode, 1e-9)}
    return gen, stats


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=args.smoke)
    dev = model_lib.resolve_device(args.device)
    params = model_lib.init(0, cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), generator=gen,
                            device=dev, dtype=torch.int32)
    out, stats = generate(cfg, params, prompts, args.max_new)
    print(f"generated {out.shape} tokens; prefill {stats['prefill_s']:.2f}s, "
          f"decode {stats['decode_tok_per_s']:.1f} tok/s")


if __name__ == "__main__":
    main()
