"""The paper's experiment model: small classifier (MNIST/CIFAR-scale).

The torch counterpart of ``repro.models.mlp``, in the reference's
parameter layout: a list of ``{"w": (in, out), "b": (out,)}`` float32
tensors, one dict per layer.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["init_mlp", "mlp_logits", "mlp_loss", "per_slot_mlp_loss",
           "mlp_accuracy", "params_from_numpy"]


def init_mlp(generator: Optional[torch.Generator] = None,
             dims=(784, 256, 128, 10), device="cuda") -> list:
    """He-normal weights, zero biases.  ``jax.random`` cannot be
    reproduced here: to start from the reference's weights, use
    :func:`params_from_numpy`."""
    params = []
    for a, b in zip(dims[:-1], dims[1:]):
        w = torch.randn((a, b), generator=generator, dtype=torch.float32)
        params.append({"w": (w * (2.0 / a) ** 0.5).to(device),
                       "b": torch.zeros((b,), dtype=torch.float32,
                                        device=device)})
    return params


def params_from_numpy(params, device="cuda") -> list:
    """The reference's parameters (a list of ``{"w", "b"}`` arrays, e.g.
    ``jax.tree.map(np.asarray, init_mlp(key))``) as float32 tensors on
    ``device``, value for value."""
    return [{k: torch.from_numpy(np.array(v, np.float32)).to(device)
             for k, v in layer.items()} for layer in params]


def mlp_logits(params, x: torch.Tensor) -> torch.Tensor:
    h = x
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def mlp_loss(params, batch) -> torch.Tensor:
    """Mean CE over a flat batch {'x': (N, D), 'y': (N,) int32}."""
    ll = torch.log_softmax(mlp_logits(params, batch["x"]), dim=-1)
    y = batch["y"].long()              # torch.gather indexes with int64
    return -torch.mean(torch.gather(ll, 1, y[:, None]))


def per_slot_mlp_loss(params, slot_batch) -> torch.Tensor:
    """slot_batch: {'x': (M, S, n, D), 'y': (M, S, n)} -> (M, S) mean CE
    of each slot (the loss interface of ``make_coded_train_step``)."""
    x, y = slot_batch["x"], slot_batch["y"]
    M, S, n, D = x.shape
    ll = torch.log_softmax(mlp_logits(params, x.reshape(M * S * n, D)),
                           dim=-1)
    ce = -torch.gather(ll, 1, y.reshape(-1, 1).long())[:, 0]
    return ce.reshape(M, S, n).mean(-1)


def mlp_accuracy(params, batch) -> torch.Tensor:
    logits = mlp_logits(params, batch["x"])
    return torch.mean((torch.argmax(logits, -1) == batch["y"]).float())
