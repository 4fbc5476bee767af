"""Plain PyTorch versions of the flash-attention kernel, forward and backward.

They compute what the reference's custom-VJP attention computes
(``repro.models.attention``: ``_fa_tiles``/``_fa_fwd_impl`` forward,
``_fa_bwd`` backward), tile for tile: online softmax over each q chunk's kv
band, masked scores set to -1e30, ``lse = m + log(max(l, 1e-30))`` saved
for the backward, then a dq pass and a dk/dv pass that recompute the
tiles.  The CPU tests run them; on the card ``chip_smoke.py`` holds the
CUDA kernel against them.  A ragged last chunk (S not a multiple of the
chunk) is allowed: its slices are simply shorter.

Layouts (the reference's): q, out, do (B, S, KV, G, D); k, v (B, S, KV, D);
lse (B, KV, G, S) float32.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["NEG_INF", "flash_attention_fwd_ref", "flash_attention_bwd_ref",
           "kv_band"]

NEG_INF = -1e30


def kv_band(qi: int, q_chunk: int, kv_chunk: int, S: int, causal: bool,
            window: int) -> Tuple[int, int]:
    """The reference's ``_kv_band``: kv-chunk range ``[j0, j1)`` that query
    chunk ``qi`` touches (the end clamped to S for a ragged last chunk)."""
    q_pos0 = qi * q_chunk
    kv_end = min(q_pos0 + q_chunk, S) if causal else S
    kv_start = 0
    if window:
        kv_start = max(0, q_pos0 - ((window + kv_chunk - 1) // kv_chunk)
                       * kv_chunk)
    return kv_start // kv_chunk, (kv_end + kv_chunk - 1) // kv_chunk


def _mask(q_pos0, n_q, k_pos0, n_k, causal, window, device):
    qp = q_pos0 + torch.arange(n_q, device=device)
    kp = k_pos0 + torch.arange(n_k, device=device)
    ok = torch.ones((n_q, n_k), dtype=torch.bool, device=device)
    if causal:
        ok &= qp[:, None] >= kp[None, :]
    if window:
        ok &= (qp[:, None] - kp[None, :]) < window
    return ok


def _chunks(S: int, q_chunk: int, kv_chunk: int):
    q_chunk, kv_chunk = min(q_chunk, S), min(kv_chunk, S)
    return (q_chunk, kv_chunk, (S + q_chunk - 1) // q_chunk,
            (S + kv_chunk - 1) // kv_chunk)


def flash_attention_fwd_ref(q, k, v, *, causal: bool = True,
                            window: int = 0, q_chunk: int = 1024,
                            kv_chunk: int = 1024):
    """``(out (B,S,KV,G,D) in q's type, lse (B,KV,G,S) float32)``."""
    B, S, KV, G, D = q.shape
    scale = D ** -0.5
    q_chunk, kv_chunk, nq, _ = _chunks(S, q_chunk, kv_chunk)
    qf = (q.float() * scale).permute(0, 2, 3, 1, 4)          # B,KV,G,S,D
    kf, vf = k.float(), v.float()
    outs, lses = [], []
    for qi in range(nq):
        q0 = qi * q_chunk
        q_t = qf[:, :, :, q0:q0 + q_chunk]
        n_q = q_t.shape[3]
        j0, j1 = kv_band(qi, q_chunk, kv_chunk, S, causal, window)
        m = torch.full((B, KV, G, n_q), NEG_INF, device=q.device)
        l = torch.zeros((B, KV, G, n_q), device=q.device)
        acc = torch.zeros((B, KV, G, n_q, D), device=q.device)
        for j in range(j0, j1):
            k0 = j * kv_chunk
            k_t, v_t = kf[:, k0:k0 + kv_chunk], vf[:, k0:k0 + kv_chunk]
            s = torch.einsum("bkgqd,bskd->bkgqs", q_t, k_t)
            if causal or window:
                ok = _mask(q0, n_q, k0, k_t.shape[1], causal, window,
                           q.device)
                s = torch.where(ok, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, v_t)
            m = m_new
        lc = torch.clamp(l, min=1e-30)
        outs.append(acc / lc[..., None])
        lses.append(m + torch.log(lc))
    out = torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4)
    return out.to(q.dtype).contiguous(), torch.cat(lses, dim=3).contiguous()


def flash_attention_bwd_ref(q, k, v, out, lse, do, *, causal: bool = True,
                            window: int = 0, q_chunk: int = 1024,
                            kv_chunk: int = 1024):
    """``(dq, dk, dv)`` in the inputs' types, as ``_fa_bwd``: ``Dvec =
    rowsum(do ⊙ out)``, a dq pass per q chunk over its kv band, then a
    dk/dv pass per kv chunk over the q chunks whose band holds it, summed
    over the G query heads of each kv head."""
    B, S, KV, G, D = q.shape
    scale = D ** -0.5
    q_chunk, kv_chunk, nq, nk = _chunks(S, q_chunk, kv_chunk)
    qf = q.float().permute(0, 2, 3, 1, 4)                    # B,KV,G,S,D
    dof = do.float().permute(0, 2, 3, 1, 4)
    outf = out.float().permute(0, 2, 3, 1, 4)
    kf, vf = k.float(), v.float()
    Dvec = torch.sum(dof * outf, dim=-1)

    def tile_grads(qi, j):
        q0, k0 = qi * q_chunk, j * kv_chunk
        q_t = qf[:, :, :, q0:q0 + q_chunk]
        do_t = dof[:, :, :, q0:q0 + q_chunk]
        k_t, v_t = kf[:, k0:k0 + kv_chunk], vf[:, k0:k0 + kv_chunk]
        s = torch.einsum("bkgqd,bskd->bkgqs", q_t * scale, k_t)
        if causal or window:
            ok = _mask(q0, q_t.shape[3], k0, k_t.shape[1], causal, window,
                       q.device)
            s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        p = torch.exp(s - lse[:, :, :, q0:q0 + q_chunk, None])
        dp = torch.einsum("bkgqd,bskd->bkgqs", do_t, v_t)
        ds = p * (dp - Dvec[:, :, :, q0:q0 + q_chunk, None])
        return p, ds, k_t, q_t, do_t

    dq_chunks = []
    for qi in range(nq):
        j0, j1 = kv_band(qi, q_chunk, kv_chunk, S, causal, window)
        n_q = min(q_chunk, S - qi * q_chunk)
        dq_acc = torch.zeros((B, KV, G, n_q, D), device=q.device)
        for j in range(j0, j1):
            _, ds, k_t, _, _ = tile_grads(qi, j)
            dq_acc = dq_acc + torch.einsum("bkgqs,bskd->bkgqd", ds,
                                           k_t) * scale
        dq_chunks.append(dq_acc)
    dq = torch.cat(dq_chunks, dim=3).permute(0, 3, 1, 2, 4)

    dk_chunks, dv_chunks = [], []
    for j in range(nk):
        n_k = min(kv_chunk, S - j * kv_chunk)
        dk_acc = torch.zeros((B, n_k, KV, D), device=q.device)
        dv_acc = torch.zeros((B, n_k, KV, D), device=q.device)
        for qi in range(nq):
            j0, j1 = kv_band(qi, q_chunk, kv_chunk, S, causal, window)
            if not j0 <= j < j1:
                continue
            p, ds, _, q_t, do_t = tile_grads(qi, j)
            dv_acc = dv_acc + torch.einsum("bkgqs,bkgqd->bskd", p, do_t)
            dk_acc = dk_acc + torch.einsum("bkgqs,bkgqd->bskd", ds,
                                           q_t) * scale
        dk_chunks.append(dk_acc)
        dv_chunks.append(dv_acc)
    dk = torch.cat(dk_chunks, dim=1)
    dv = torch.cat(dv_chunks, dim=1)
    return (dq.to(q.dtype).contiguous(), dk.to(k.dtype).contiguous(),
            dv.to(v.dtype).contiguous())
