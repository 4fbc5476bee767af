"""Plain PyTorch version of the RG-LRU scan kernel: the sequential
recurrence (the reference's ``repro.kernels.rglru_scan.ref.rglru_ref``)."""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["rglru_ref"]


def rglru_ref(a: torch.Tensor, b: torch.Tensor,
              h0: Optional[torch.Tensor] = None) -> tuple:
    """h_t = a_t ⊙ h_{t-1} + b_t, one step at a time in float32.

    a, b: (B, S, D); h0: (B, D) or None (zeros).  Returns ``(h (B, S, D)
    in a's type, h_last (B, D) float32)``.  Differentiable.
    """
    B, S, D = a.shape
    h = (torch.zeros((B, D), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    out = []
    for t in range(S):
        h = a[:, t].float() * h + b[:, t].float()
        out.append(h)
    return torch.stack(out, dim=1).to(a.dtype), h
