"""Batch construction shared by the smoke tests and the drivers.

The torch counterpart of ``repro.data.batches``: ``batch_shapes`` is the
one source of model input signatures (name -> (shape, torch dtype)), and
``synthetic_batch`` draws a batch of them from numpy's ``default_rng(seed)``
in the reference's order, so every array equals the reference's bit for
bit (floating inputs are rounded to the compute type as the reference
rounds them).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["batch_shapes", "synthetic_batch"]


def batch_shapes(cfg: ModelConfig, B: int, S: int, kind: str) -> dict:
    """name -> (shape, dtype) for the given step kind (train|prefill)."""
    f = getattr(torch, cfg.compute_dtype)
    shapes = {}
    if cfg.frontend == "audio":
        shapes["frames"] = ((B, S, cfg.d_model), f)
    elif cfg.frontend == "vision":
        P = cfg.n_patches
        shapes["patches"] = ((B, P, cfg.d_model), f)
        shapes["tokens"] = ((B, S - P), torch.int32)
    else:
        shapes["tokens"] = ((B, S), torch.int32)
    if kind == "train":
        shapes["labels"] = ((B, S), torch.int32)
        shapes["weights"] = ((B, S), torch.float32)
    return shapes


def synthetic_batch(cfg: ModelConfig, B: int, S: int, kind: str,
                    seed: int = 0, device="cuda") -> dict:
    """Deterministic inputs of ``batch_shapes`` on ``device``: tokens and
    labels uniform over the vocabulary, weights uniform (zero on a vision
    config's patch positions) summing to 1, frames and patches N(0, 0.02²)."""
    rng = np.random.default_rng(seed)
    batch = {}
    for name, (shape, dtype) in batch_shapes(cfg, B, S, kind).items():
        if dtype == torch.int32:
            x = torch.from_numpy(
                rng.integers(0, cfg.vocab, size=shape).astype(np.int32))
        elif name == "weights":
            w = np.ones(shape, np.float32)
            if cfg.frontend == "vision":
                w[:, :cfg.n_patches] = 0.0      # ignore patch positions
                w = w / w.sum()
            else:
                w = w / w.size
            x = torch.from_numpy(w)
        else:
            x = torch.from_numpy(
                (rng.standard_normal(shape) * 0.02).astype(np.float32)
            ).to(dtype)
        batch[name] = x.to(device)
    return batch
