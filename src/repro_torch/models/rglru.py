"""RG-LRU recurrent block (RecurrentGemma / Griffin).

The torch counterpart of ``repro.models.rglru``.  Recurrence (per
channel, block-diagonal gate projections per head):

    r_t = sigmoid(x_t · W_a + b_a)          recurrence gate
    i_t = sigmoid(x_t · W_x + b_x)          input gate
    log a_t = -c * softplus(Λ) * r_t        (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

The gates are plain PyTorch in float32, as the reference's; the scan is
``repro_torch.kernels.rglru_scan``: the CUDA kernels on the card (its
backward a reverse scan), the plain sequential recurrence and its
written-out backward on the CPU.  The reference scans with
``jax.lax.associative_scan`` (log depth, another summation order), and
takes the input scale sqrt(1 - a²) in forms that cancel where a is near 1
(:func:`_input_scale`), so the two agree to float32 rounding except in
such channels.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan import rglru_scan as _scan

__all__ = ["rglru_scan", "rglru_step", "causal_conv1d", "conv1d_step"]

_C = 8.0


def _gates(x: torch.Tensor, p: dict) -> tuple:
    """x: (B, S, Hr, Dr) float32 -> ``(i, log_a)``, each (B, S, Hr, Dr)
    float32; block-diagonal per rnn-head gate projections.  The weights
    are promoted to float32 as jnp promotes them; ``softplus(Λ)`` is
    taken in Λ's own type, as the reference takes it."""
    r = torch.sigmoid(torch.einsum("bshd,hde->bshe", x, p["w_a"].float())
                      + p["b_a"].float())
    i = torch.sigmoid(torch.einsum("bshd,hde->bshe", x, p["w_x"].float())
                      + p["b_x"].float())
    log_a = (-_C * F.softplus(p["lam"])) * r
    return i, log_a


def rglru_scan(x: torch.Tensor, p: dict,
               h0: Optional[torch.Tensor] = None) -> tuple:
    """Full-sequence RG-LRU.  x: (B, S, Hr, Dr); h0: (B, Hr, Dr) or None.
    Returns ``(y (B, S, Hr, Dr) in x's type, h_last (B, Hr, Dr) float32)``.
    """
    B, S, Hr, Dr = x.shape
    xf = x.float()
    i, log_a = _gates(xf, p)
    a = torch.exp(log_a)
    b = _input_scale(log_a) * (i * xf)
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    h, h_last = _scan(a.reshape(B, S, Hr * Dr).contiguous(),
                      b.reshape(B, S, Hr * Dr).contiguous())
    return h.reshape(B, S, Hr, Dr).to(x.dtype), h_last.reshape(B, Hr, Dr)


def _input_scale(log_a: torch.Tensor) -> torch.Tensor:
    """sqrt(1 - a²) from log a, as ``sqrt(-expm1(2 log a))``.  The
    reference writes ``1 - exp(2 log a)`` (its scan) and ``1 - a·a`` (its
    step), which cancel where the gate r is near 0: a is then within a few
    float32 ulps of 1, so the difference is a multiple of 6e-8 and a
    one-ulp change of log a (another summation order of the gate's
    product) moves the scale by up to 240x.  ``expm1`` keeps its relative
    precision there, so a decode step continues the prefill's scan."""
    return torch.sqrt(torch.clamp(-torch.expm1(2.0 * log_a), min=1e-12))


def rglru_step(x_t: torch.Tensor, h: torch.Tensor, p: dict) -> tuple:
    """Single decode step.  x_t: (B, Hr, Dr), h: (B, Hr, Dr) float32.
    Returns ``(y in x_t's type, h_new float32)``.  Its input scale is the
    scan's (:func:`_input_scale`)."""
    xf = x_t.float()[:, None]                              # (B,1,Hr,Dr)
    i, log_a = _gates(xf, p)
    h_new = torch.exp(log_a[:, 0]) * h + _input_scale(log_a[:, 0]) \
        * (i[:, 0] * xf[:, 0])
    return h_new.to(x_t.dtype), h_new


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width = w.shape[0].  x: (B, S, D)."""
    W = w.shape[0]
    S = x.shape[1]
    out = x * w[-1] + b
    for j in range(1, W):
        shifted = F.pad(x, (0, 0, j, 0))[:, :S]
        out = out + shifted * w[W - 1 - j]
    return out


def conv1d_step(x_t: torch.Tensor, state: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> tuple:
    """Decode-step conv.  x_t: (B, D); state: (B, W-1, D) past inputs.
    Returns ``(out (B, D), new state (B, W-1, D))``."""
    window = torch.cat([state, x_t[:, None]], dim=1)       # (B, W, D)
    out = torch.einsum("bwd,wd->bd", window, w) + b
    return out, window[:, 1:]
