"""Attention for the transformer's training path.

The torch counterpart of ``repro.models.attention.flash_attention``, in
the reference's public layout: q (B, S, KVH, G, D), GQA groups folded next
to the kv heads; k, v (B, S, KVH, D).  It is differentiable through the
flash-attention ``autograd.Function`` of ``repro_torch.kernels``: on a
CUDA tensor its forward and backward are the hand-written kernels, on a
CPU tensor the plain versions, which follow the reference's tiles and its
custom backward (``_fa_bwd``: a dq pass, then a dk/dv pass, over the kv
band of each chunk).  ``decode_attention`` waits for the serving slice
(ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import \
    flash_attention as _flash_attention

__all__ = ["flash_attention"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_chunk: int = 1024, kv_chunk: int = 1024
                    ) -> torch.Tensor:
    """Exact attention with ``scale = D**-0.5``.

    Args:
      q: (B, S, KVH, G, D); k, v: (B, S, KVH, D), one type.
      causal: causal mask; window > 0 adds a sliding window.
      q_chunk, kv_chunk: the plain version's tiles (capped at S), as the
        reference's; the kernel tiles by 64 x 64 whatever they are.
    Returns: (B, S, KVH, G, D) in q's type.
    """
    S = q.shape[1]
    return _flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=causal, window=window,
                            q_chunk=min(q_chunk, S),
                            kv_chunk=min(kv_chunk, S))
