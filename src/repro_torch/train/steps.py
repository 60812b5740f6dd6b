"""train_step / eval_step / prefill_step / serve_step builders: the JAX
package's ``repro.train.steps`` as plain functions over torch tensors.

The train step differentiates ``loss_fn`` with autograd over the plain torch
model (no kernel on this path needs a backward of its own) and hands the
gradients to ``adamw.apply_update``, which updates the parameters and the
optimizer state in place.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as model_lib
from repro_torch.optim import adamw


def build_train_step(cfg: model_lib.ModelConfig, ocfg: adamw.OptConfig):
    def train_step(params, opt_state, batch):
        leaves = model_lib._leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        _, metrics = model_lib.loss_fn(params, cfg, batch)
        flat = torch.autograd.grad(metrics["loss"], leaves)
        it = iter(flat)
        grads = model_lib._map(lambda _: next(it), params)
        params, opt_state, om = adamw.apply_update(params, grads, opt_state, ocfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(om)
        return params, opt_state, metrics

    return train_step


def build_eval_step(cfg: model_lib.ModelConfig):
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = model_lib.loss_fn(params, cfg, batch)
        return metrics

    return eval_step


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
