"""Step builders shared by the trainer and the server: the torch
counterpart of ``repro.launch.steps``.

``make_train_step`` is :func:`repro_torch.core.coded_step.make_train_step`
(functional: ``grad_transform`` needs new trees) over the model's
``loss_fn`` with the reference's AdamW; the prefill and serve steps wrap
``prefill`` and ``decode_step``.  ``dp_shards`` is 1 on one card and is
passed through to the model (the MoE dispatch's shards).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import coded_step
from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizers import adamw

__all__ = ["make_train_step", "make_prefill_step", "make_serve_step",
           "make_optimizer"]


def make_optimizer(cfg: ModelConfig, lr: float = 3e-4):
    return adamw(lr=lr, b1=0.9, b2=0.95, weight_decay=0.1,
                 state_dtype=getattr(torch, cfg.opt_state_dtype))


def make_train_step(cfg: ModelConfig, dp_shards: int = 1, *,
                    lr: float = 3e-4, clip: float = 1.0,
                    grad_transform: Optional[Callable] = None) -> tuple:
    """Returns ``(step, optimizer)``; ``step(params, opt_state, batch) ->
    (params, opt_state, {"loss", "grad_norm"})``: the gradient of the
    model's loss, clipped to a global norm of ``clip`` (none at 0), passed
    through ``grad_transform`` (e.g. a ``repro_torch.compress``
    compressor carried by ``ErrorFeedback``), then AdamW."""
    opt = make_optimizer(cfg, lr)

    def loss_fn(params, batch):
        return tfm.loss_fn(params, batch, cfg, dp_shards=dp_shards)

    return coded_step.make_train_step(loss_fn, opt, clip_norm=clip,
                                      grad_transform=grad_transform), opt


def make_prefill_step(cfg: ModelConfig, dp_shards: int = 1) -> Callable:
    """``step(params, batch) -> (last_logits, caches)``."""
    def step(params, batch):
        logits, caches, pos = tfm.prefill(params, batch, cfg,
                                          dp_shards=dp_shards)
        return logits, caches
    return step


def make_serve_step(cfg: ModelConfig, dp_shards: int = 1) -> Callable:
    """``step(params, tokens, caches, pos) -> (logits, caches)``."""
    def step(params, tokens, caches, pos):
        return tfm.decode_step(params, tokens, caches, pos, cfg,
                               dp_shards=dp_shards)
    return step
