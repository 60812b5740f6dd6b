"""prefill_step / serve_step builders: the JAX package's
``repro.train.steps`` serving builders as plain functions over torch
tensors. (``build_train_step`` and ``build_eval_step`` come with
``loss_fn`` in the training slice.)
"""
from __future__ import annotations

import torch

from repro_torch.models import model as model_lib


def build_prefill_step(cfg: model_lib.ModelConfig):
    def prefill_step(params, inputs):
        return model_lib.prefill(params, cfg, inputs["tokens"],
                                 mrope_pos=inputs.get("mrope_pos"),
                                 enc_frames=inputs.get("enc_frames"))

    return prefill_step


def build_serve_step(cfg: model_lib.ModelConfig):
    def serve_step(params, cache, token, pos):
        logits, cache = model_lib.decode_step(params, cfg, cache, token, pos)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_token, logits, cache

    return serve_step
