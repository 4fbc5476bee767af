"""Plain PyTorch versions of the RWKV6 WKV kernel.

``wkv_ref`` is the sequential recurrence (as ``repro.kernels.rwkv6_wkv.ref``
is the reference's ``wkv_sequential``): what the kernel is held to, and what
``wkv`` computes for a CPU tensor.

``wkv_chunked_exact`` is the kernel's own algorithm written out in plain
torch, so that its numerics can be checked on the CPU: tests use it, the
main path never does.  Per chunk of ``chunk`` steps, from the carried state
S (K x V), with the decay of steps i..j written ``w[i:j] = Π_{i<=m<j} w_m``
(1 for an empty interval):

    out_t = (r_t ⊙ w[0:t]) · S                         the inter-chunk product
          + Σ_{s<t} A[t,s] v_s,   A[t,s] = Σ_k r_tk k_sk w[s+1:t]_k
          + (Σ_k r_tk u_k k_tk) v_t                    the bonus, A's diagonal
    S    <- diag(w[0:n]) S + Σ_s (k_s ⊙ w[s+1:n]) ⊗ v_s

Every factor is the product of w over an interval between s and t, never a
ratio of two prefix products: each lies in [0, 1], a zero in w gives an
exact 0 past it, and nothing overflows.  It is the same quantity as the
interval exponent exp(la[t-1] - la[s]) over the cumulative log-decay la,
evaluated by multiplying instead of by exp and log, so it needs no floor
under log w.  The reference's chunked form instead factors it as
exp(la[t-1]) · exp(min(-la[s], 30)), which is wrong once la passes -30.
"""
from __future__ import annotations

import torch

from repro_torch.models.rwkv6 import wkv_sequential as wkv_ref

__all__ = ["wkv_chunked_exact", "wkv_ref"]


def wkv_chunked_exact(r, k, v, w, u, chunk: int = 16):
    """r, k, w: (B, H, S, K); v: (B, H, S, V); u: (H, K).  Float32
    arithmetic, from a zero state.  Returns ``(out (B, H, S, V) in r's
    type, S_last (B, H, K, V) float32)``, equal to :func:`wkv_ref` up to
    float32 summation order."""
    B, H, T, K = r.shape
    V = v.shape[-1]
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, None, :]                       # (1, H, 1, K)
    S = torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
    outs = []
    for t0 in range(0, T, chunk):
        rc, kc, vc, wc = (t[:, :, t0:t0 + chunk] for t in (rf, kf, vf, wf))
        n = rc.shape[2]
        ones = torch.ones_like(wc[:, :, :1])
        # prefix w[0:t] and suffix w[s+1:n], each a running product
        pre = torch.cumprod(torch.cat([ones, wc[:, :, :-1]], 2), 2)
        suf = torch.cumprod(torch.cat([wc[:, :, 1:], ones], 2).flip(2),
                            2).flip(2)
        total = pre[:, :, -1] * wc[:, :, -1]                # w[0:n]
        # A[t, s] for t > s: w[s+1:t] as a running product over t
        A = torch.zeros((B, H, n, n), dtype=torch.float32, device=r.device)
        for s in range(n - 1):
            decay = torch.cumprod(torch.cat([ones, wc[:, :, s + 1:n - 1]],
                                            2), 2)
            A[:, :, s + 1:, s] = (rc[:, :, s + 1:] * kc[:, :, s:s + 1]
                                  * decay).sum(-1)
        A = A + torch.diag_embed((rc * uf * kc).sum(-1))    # the bonus
        outs.append(torch.einsum("bhtk,bhkv->bhtv", rc * pre, S)
                    + A @ vc)
        S = total[..., None] * S + torch.einsum("bhsk,bhsv->bhkv",
                                                kc * suf, vc)
    return torch.cat(outs, 2).to(r.dtype), S
