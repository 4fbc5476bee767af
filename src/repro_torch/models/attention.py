"""Attention for the transformer: training/prefill and decode.

The torch counterpart of ``repro.models.attention.flash_attention``, in
the reference's public layout: q (B, S, KVH, G, D), GQA groups folded next
to the kv heads; k, v (B, S, KVH, D).  It is differentiable through the
flash-attention ``autograd.Function`` of ``repro_torch.kernels``: on a
CUDA tensor its forward and backward are the hand-written kernels, on a
CPU tensor the plain versions, which follow the reference's tiles and its
custom backward (``_fa_bwd``: a dq pass, then a dk/dv pass, over the kv
band of each chunk).  ``decode_attention`` is plain PyTorch, as the
reference's is plain jnp (no Pallas kernel); a split-K decode kernel is
later work (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import \
    flash_attention as _flash_attention

__all__ = ["decode_attention", "flash_attention"]

_NEG_INF = -1e30


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


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid: torch.Tensor, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention over a k/v cache, in float32.

    q: (B, 1, KVH, G, D); caches: (B, S, KVH, D); valid: (B, S) bool mask
    of live cache slots.  Returns (B, 1, KVH, G, D) in q's type.
    """
    D = q.shape[-1]
    scale = scale if scale is not None else D ** -0.5
    qf = q.float() * scale
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k_cache.float())
    s = torch.where(valid[:, None, None, None, :], s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgqs,bskd->bkgqd", p / torch.clamp(denom, min=1e-30),
                       v_cache.float())
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)         # (B,1,KV,G,D)
