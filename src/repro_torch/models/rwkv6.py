"""RWKV-6 "Finch" time-mix (WKV) with data-dependent decay.

The torch counterpart of ``repro.models.rwkv6``.  Recurrence per head
(a K x V matrix state S):

    out_t = r_t · (S_{t-1} + (u ⊙ k_t) ⊗ v_t)
    S_t   = diag(w_t) S_{t-1} + k_t ⊗ v_t

with data-dependent per-channel decay w_t = exp(-exp(w0 + lora(x_t))).

Two functions here:
  * ``wkv_step``       — one decode step;
  * ``wkv_sequential`` — the recurrence step by step, the oracle, and the
    plain version of the WKV kernel (``repro_torch.kernels.rwkv6_wkv``).

The reference's ``wkv_chunked`` is not ported.  Its intra-chunk scores are
factored as ``exp(la[t-1]) · exp(min(-la[s], 30))`` over the cumulative
log-decay ``la``; once ``la`` falls below -30 inside one chunk that stops
equalling ``exp(la[t-1] - la[s])`` and the output is wrong (at rwkv6-1.6b's
initial decay w = e^-1 and chunk 64 the output is off by up to 56.8).  The
port runs the recurrence exactly instead.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["wkv_sequential", "wkv_step"]


def wkv_step(r_t, k_t, v_t, w_t, u, S):
    """One decode step.  r/k/w: (B, H, K); v: (B, H, V); u: (H, K);
    S: (B, H, K, V).  Returns ``(out (B, H, V), S_new)``."""
    kv = k_t[..., :, None] * v_t[..., None, :]              # (B,H,K,V)
    out = torch.einsum("bhk,bhkv->bhv", r_t, S + u[None, :, :, None] * kv)
    S_new = w_t[..., :, None] * S + kv
    return out, S_new


def wkv_sequential(r, k, v, w, u, S0: Optional[torch.Tensor] = None):
    """The oracle.  r/k/w: (B, H, S, K); v: (B, H, S, V); u: (H, K); S0:
    (B, H, K, V) or None (zeros).  Float32 arithmetic; returns
    ``(out (B, H, S, V) in r's type, S_last (B, H, K, V) float32)``."""
    B, H, T, K = r.shape
    V = v.shape[-1]
    S = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
         if S0 is None else S0.float())
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()
    outs = []
    for t in range(T):
        out, S = wkv_step(rf[:, :, t], kf[:, :, t], vf[:, :, t],
                          wf[:, :, t], uf, S)
        outs.append(out)
    return torch.stack(outs, dim=2).to(r.dtype), S
