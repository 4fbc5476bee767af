"""Plain PyTorch versions of the RG-LRU scan kernels: the sequential
recurrence (the reference's ``repro.kernels.rglru_scan.ref.rglru_ref``)
and its written-out backward, the reverse scan."""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["rglru_bwd_ref", "rglru_ref"]


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


def rglru_bwd_ref(a: torch.Tensor, b: torch.Tensor, dout: torch.Tensor,
                  dh_last: Optional[torch.Tensor] = None,
                  h: Optional[torch.Tensor] = None) -> tuple:
    """The gradients ``(da, db)`` of :func:`rglru_ref` from a zero state, in
    a's type, given those of its two outputs: ``dout`` (B, S, D) and
    ``dh_last`` (B, D) or None (zero).  ``h`` (B, S, D) float32 holds the
    forward's states, or None to recompute them.  The reverse scan, in
    float32, each product and sum rounded in this order:

        g_t = dout_t + a_{t+1} ⊙ g_{t+1}   (g_{S-1} = dout_{S-1} + dh_last)
        da_t = g_t ⊙ h_{t-1}   (h_{-1} = 0),   db_t = g_t
    """
    B, S, D = a.shape
    if h is None:
        h = rglru_ref(a.float(), b.float())[0]
    af, do = a.float(), dout.float()
    g = (torch.zeros((B, D), dtype=torch.float32, device=a.device)
         if dh_last is None else dh_last.float())
    a_next = torch.ones_like(g)
    da = torch.empty((B, S, D), dtype=torch.float32, device=a.device)
    db = torch.empty_like(da)
    for t in range(S - 1, -1, -1):
        g = do[:, t] + a_next * g
        db[:, t] = g
        da[:, t] = g * h[:, t - 1] if t else 0.0
        a_next = af[:, t]
    return da.to(a.dtype), db.to(a.dtype)
