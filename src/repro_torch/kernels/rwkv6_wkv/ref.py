"""Plain PyTorch versions of the RWKV6 WKV kernels.

``wkv_ref`` is the sequential recurrence (as ``repro.kernels.rwkv6_wkv.ref``
is the reference's ``wkv_sequential``): what the kernel is held to, and what
``wkv`` computes for a CPU tensor; ``wkv_bwd_ref`` is its written-out
backward, what the backward kernel is held to and what ``wkv``'s backward
computes for a CPU tensor.

``wkv_chunked_exact`` and ``wkv_bwd_chunked_exact`` are the kernels' own
algorithms written out in plain torch, so that their numerics can be
checked on the CPU: tests use them, the main path never does.  The
forward, per chunk of ``chunk`` steps, from the carried state S (K x V),
with the decay of steps i..j written ``w[i:j] = Π_{i<=m<j} w_m`` (1 for an
empty interval):

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

__all__ = ["wkv_bwd_chunked_exact", "wkv_bwd_ref", "wkv_chunked_exact",
           "wkv_ref"]


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


def wkv_bwd_ref(r, k, v, w, u, dout, ds_last=None):
    """The gradients ``(dr, dk, dv, dw, du)`` of :func:`wkv_ref` from a
    zero state, given those of its outputs: ``dout`` (B, H, S, V) and
    ``ds_last`` (B, H, K, V) or None (zero).  Float32 arithmetic; dw comes
    back float32, the others in their inputs' types.  The states S_{t-1}
    are taken forward first; then a reverse sweep carries dS (K x V),
    seeded by ``ds_last``, and takes at each step what autograd of the
    step takes, with G = r_t ⊗ do_t and kv = k_t ⊗ v_t:

        dr_t = (S_{t-1} + u ⊙ kv)·do_t
        gkv  = u ⊙ G + dS_t
        dk_t = gkv·v_t,   dv_t = gkvᵀ·k_t
        dw_t = Σ_j dS_t ⊙ S_{t-1}
        du  += Σ_batch Σ_j G ⊙ kv
        dS_{t-1} = diag(w_t) dS_t + G
    """
    B, H, T, K = r.shape
    V = v.shape[-1]
    rf, kf, vf, wf, dof = (t.float() for t in (r, k, v, w, dout))
    uf = u.float()[None, :, :, None]                       # (1, H, K, 1)
    S = torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
    states = []
    for t in range(T):
        states.append(S)
        S = wf[:, :, t, :, None] * S + kf[:, :, t, :, None] * \
            vf[:, :, t, None, :]
    dS = (torch.zeros_like(S) if ds_last is None else
          ds_last.float().clone())
    dr, dk, dw = (torch.empty((B, H, T, K), dtype=torch.float32,
                              device=r.device) for _ in range(3))
    dv = torch.empty((B, H, T, V), dtype=torch.float32, device=r.device)
    du = torch.zeros((H, K), dtype=torch.float32, device=r.device)
    for t in range(T - 1, -1, -1):
        r_t, k_t, v_t, w_t, do_t = (x[:, :, t] for x in (rf, kf, vf, wf, dof))
        kv = k_t[..., :, None] * v_t[..., None, :]
        G = r_t[..., :, None] * do_t[..., None, :]
        dr[:, :, t] = torch.einsum("bhkv,bhv->bhk", states[t] + uf * kv,
                                   do_t)
        gkv = uf * G + dS
        dk[:, :, t] = torch.einsum("bhkv,bhv->bhk", gkv, v_t)
        dv[:, :, t] = torch.einsum("bhkv,bhk->bhv", gkv, k_t)
        dw[:, :, t] = (dS * states[t]).sum(-1)
        du += (G * kv).sum((0, 3))
        dS = w_t[..., None] * dS + G
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw,
            du.to(u.dtype))


def _decays(wc):
    """Interval products of one chunk's decays wc (B, H, n, K): ``M[t, s]
    = w[s+1:t]`` for s < t (0 elsewhere), the prefix ``w[0:t]``, the
    suffix ``w[t+1:n]`` and the total ``w[0:n]``, each a running product
    of w, never a ratio."""
    B, H, n, K = wc.shape
    M = wc.new_zeros((B, H, n, n, K))
    for s in range(n - 1):
        m = torch.ones_like(wc[:, :, 0])
        for t in range(s + 1, n):
            M[:, :, t, s] = m
            m = m * wc[:, :, t]
    ones = torch.ones_like(wc[:, :, :1])
    pre = torch.cumprod(torch.cat([ones, wc[:, :, :-1]], 2), 2)
    suf = torch.cumprod(torch.cat([wc[:, :, 1:], ones], 2).flip(2),
                        2).flip(2)
    return M, pre, suf, pre[:, :, -1] * wc[:, :, -1]


def wkv_bwd_chunked_exact(r, k, v, w, u, dout, ds_last=None,
                          chunk: int = 16, v_tile=None):
    """The gradients ``(dr, dk, dv, dw, du)`` of :func:`wkv_ref`, as
    :func:`wkv_bwd_ref` returns them, by the backward kernel's chunked
    algorithm.  Float32 arithmetic.

    A chunked state pass keeps the state S_in before each chunk.  Then,
    chunk by chunk from the last, from S_in and the gradient dS_out carried
    in from the later chunks (seeded by ``ds_last``), with M[t, s] =
    w[s+1:t], P = do·vᵀ, Z = do·S_inᵀ, Y = v·dS_outᵀ and C = Σ_j dS_out ⊙
    S_in (the products over V):

        dr_t  = w[0:t] ⊙ Z_t + Σ_{s<t} P[t,s] M[t,s] ⊙ k_s + u ⊙ k_t P[t,t]
        dk_s  = w[s+1:n] ⊙ Y_s + Σ_{t>s} P[t,s] M[t,s] ⊙ r_t + u ⊙ r_s P[s,s]
        dv    = (k ⊙ w[s+1:n])·dS_out + Aᵀ·do,  A[t,s] = Σ_k r_t M[t,s] k_s
                (s < t), A[t,t] = Σ_k r_t u k_t
        dS_in = w[0:n] ⊙ dS_out + (r ⊙ w[0:t])ᵀ·do
        du   += Σ_t r_t ⊙ k_t P[t,t]
        dw_t  = w[0:t] w[t+1:n] ⊙ C + w[t+1:n] ⊙ Σ_{s<t} M[t,s] k_s ⊙ Y_s
              + w[0:t] ⊙ Σ_{τ>t} M[τ,t] r_τ ⊙ Z_τ
              + Σ_{s<t<τ} M[t,s] M[τ,t] k_s ⊙ r_τ P[τ,s]

    dw is Σ_j dS_t ⊙ S_{t-1} with both factors written over the chunk's
    intervals: the four terms are the products of their two parts each,
    and no term divides by w.  ``v_tile`` splits V into tiles of that many
    columns (S and dS have independent columns): each tile takes its own
    P, Z, Y and C, and the tiles' partial dr, dk, dw and du are summed in
    tile order; dv and dS are the tile's own.  du is summed over the chunks
    from the last, then over the batch in order."""
    B, H, T, K = r.shape
    V = v.shape[-1]
    VT = V if v_tile is None else v_tile
    if V % VT:
        raise ValueError(f"v_tile {VT} does not divide V = {V}")
    rf, kf, vf, wf, dof = (t.float() for t in (r, k, v, w, dout))
    uf = u.float()[None, :, None, :]                       # (1, H, 1, K)
    starts = list(range(0, T, chunk))
    # the chunked state pass: the state before each chunk
    S = torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
    s_in = []
    for t0 in starts:
        s_in.append(S)
        kc, vc, wc = (x[:, :, t0:t0 + chunk] for x in (kf, vf, wf))
        _, _, suf, total = _decays(wc)
        S = total[..., None] * S + torch.einsum("bhsk,bhsv->bhkv",
                                                kc * suf, vc)
    dS = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
          if ds_last is None else ds_last.float().clone())
    dr, dk, dw = (torch.empty((B, H, T, K), dtype=torch.float32,
                              device=r.device) for _ in range(3))
    dv = torch.empty((B, H, T, V), dtype=torch.float32, device=r.device)
    du_b = torch.zeros((B, H, K), dtype=torch.float32, device=r.device)
    for c in range(len(starts) - 1, -1, -1):
        t0 = starts[c]
        rc, kc, vc, wc, doc = (x[:, :, t0:t0 + chunk]
                               for x in (rf, kf, vf, wf, dof))
        n = rc.shape[2]
        M, pre, suf, total = _decays(wc)
        alpha = M * kc[:, :, None, :, :]                  # M[t,s] k_s
        beta = M * rc[:, :, :, None, :]                   # M[t,s] r_t
        eye = torch.eye(n, dtype=torch.float32, device=r.device)
        A = (rc[:, :, :, None, :] * alpha).sum(-1) + \
            torch.diag_embed((rc * uf * kc).sum(-1))       # (B, H, t, s)
        sums = [torch.zeros_like(rc) for _ in range(3)]   # dr, dk, dw
        du_c = torch.zeros_like(du_b)
        dS_in = torch.empty_like(dS)
        for j0 in range(0, V, VT):
            cols = slice(j0, j0 + VT)
            vt, dot = vc[..., cols], doc[..., cols]
            si, dso = s_in[c][..., cols], dS[..., cols]
            P = dot @ vt.transpose(-1, -2)                # (B, H, t, s)
            Z = dot @ si.transpose(-1, -2)                # (B, H, t, K)
            Y = vt @ dso.transpose(-1, -2)                # (B, H, s, K)
            C = (dso * si).sum(-1)[:, :, None]            # (B, H, 1, K)
            diag = (P * eye)[..., None]                   # P[t,t] on t = s
            pd = diag.sum(3)                              # (B, H, t, 1)
            part_r = pre * Z + (P[..., None] * alpha).sum(3) + \
                uf * kc * pd
            part_k = suf * Y + (P[..., None] * beta).sum(2) + uf * rc * pd
            # Σ_{τ>t} M[τ,t] r_τ P[τ,s], for each (t, s)
            g = torch.einsum("bhtuk,bhts->bhusk", beta, P)
            part_w = pre * suf * C + \
                suf * (alpha * Y[:, :, None]).sum(3) + \
                pre * (beta * Z[:, :, :, None]).sum(2) + \
                (alpha * g).sum(3)
            for acc, part in zip(sums, (part_r, part_k, part_w)):
                acc += part
            du_c += (rc * kc * pd).sum(2)
            dv[:, :, t0:t0 + n, cols] = (kc * suf) @ dso + \
                A.transpose(-1, -2) @ dot
            dS_in[..., cols] = total[..., None] * dso + \
                (rc * pre).transpose(-1, -2) @ dot
        dr[:, :, t0:t0 + n], dk[:, :, t0:t0 + n], dw[:, :, t0:t0 + n] = sums
        du_b += du_c
        dS = dS_in
    du = du_b[0].clone()
    for b in range(1, B):
        du += du_b[b]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw,
            du.to(u.dtype))
