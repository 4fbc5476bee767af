"""Mixture-of-Experts FFN with grouped (per-data-shard) gather dispatch.

The torch counterpart of ``repro.models.moe``.  Tokens are reshaped to
(dp_shards, T_local, d) and each shard routes its own tokens: a softmax
over the router logits in float32, the top-k experts of each token, the
combine weights renormalised over the chosen experts, a stable sort of the
(token, choice) assignments by expert id, and per shard a capacity of C
slots an expert.  An expert's slots take its assignments in token order;
the ones past C are dropped and contribute nothing (the residual keeps the
token alive).  The Switch balance loss ``E·mean_shard Σ_e f_e·p_e`` is
returned beside the output.

What differs from the reference, and why:

* Top-k is the first k of a stable descending sort of the probabilities,
  so that among equal values the lower expert id comes first, as
  ``jax.lax.top_k`` puts it (``torch.topk`` promises no order).
* The combine is a gather, not a scatter-add: each token sums its expert
  outputs in ascending expert order, the order of the reference's slots,
  starting from zero in the output's type.  ``index_add_`` on a card adds
  with atomics, whose order changes from run to run.
  :class:`DispatchPlan` carries the map it needs (``token_slot``: each
  (token, choice)'s slot, -1 where dropped) beside the reference's four
  fields.
* The expert products run a block of experts at a time, each block's
  weights cast to the activations' type just before its products: the
  caller leaves the expert stacks as stored, so a float32 pass over
  bfloat16 weights never holds a float32 copy of all of them (llama4's
  128 experts are 16.1 B parameters a layer).
* ``constrain_moe_buffer`` (a sharding constraint) has no counterpart:
  on one card it does nothing.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["DispatchPlan", "moe_capacity", "moe_dispatch_indices",
           "moe_ffn"]

#: Bytes of cast expert weights one block of the expert products may
#: hold (the weights' own type needs no cast and runs in one block).
_CAST_BLOCK_BYTES = 1 << 30


class DispatchPlan(NamedTuple):
    slot_token: torch.Tensor   # (Sh, E, C) int64 token index per slot
    slot_valid: torch.Tensor   # (Sh, E, C) bool
    slot_weight: torch.Tensor  # (Sh, E, C) float32 combine weight
    aux_loss: torch.Tensor     # () load-balancing loss
    token_slot: torch.Tensor   # (Sh, T, k) int64 slot e·C + c, -1: dropped


def moe_capacity(T_local: int, top_k: int, n_experts: int,
                 capacity_factor: float) -> int:
    """Slots an expert takes per shard: the reference's expression, at
    least 8, rounded up to a multiple of 8."""
    capacity = max(int(T_local * top_k / n_experts * capacity_factor), 8)
    return ((capacity + 7) // 8) * 8


def moe_dispatch_indices(logits: torch.Tensor, top_k: int,
                         capacity: int) -> DispatchPlan:
    """The gather dispatch of router ``logits`` (Sh, T, E)."""
    Sh, T, E = logits.shape
    N = T * top_k
    dev = logits.device
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :top_k], top_e[..., :top_k]     # (Sh, T, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(Sh, N)
    flat_p = top_p.reshape(Sh, N)
    flat_t = torch.arange(T, device=dev).repeat_interleave(top_k)   # (N,)
    # a stable sort by expert id keeps token order (deterministic drops)
    _, order = torch.sort(flat_e, dim=-1, stable=True)
    sorted_t = flat_t[order]
    sorted_p = torch.gather(flat_p, 1, order)

    counts = torch.zeros((Sh, E), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, dim=-1) - counts              # (Sh, E)

    # slot (e, c) <- sorted position offsets[e] + c
    slots = torch.arange(capacity, device=dev)
    pos = (offsets[:, :, None] + slots).clamp(0, N - 1).reshape(Sh, -1)
    slot_token = torch.gather(sorted_t, 1, pos).reshape(Sh, E, capacity)
    slot_weight = torch.gather(sorted_p, 1, pos).reshape(Sh, E, capacity)
    slot_valid = slots < counts[:, :, None]

    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    frac = counts.float() / N
    aux = E * torch.mean(torch.sum(frac * probs.mean(dim=1), dim=-1))

    # each (token, choice)'s slot, the choices in ascending expert order
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(N, device=dev).expand(Sh, N))
    e_asc, j_asc = torch.sort(top_e, dim=-1)
    n_asc = (torch.arange(T, device=dev)[:, None] * top_k + j_asc).reshape(
        Sh, N)
    c = (torch.gather(rank, 1, n_asc)
         - torch.gather(offsets, 1, e_asc.reshape(Sh, N))).reshape(
        Sh, T, top_k)
    token_slot = torch.where(c < capacity, e_asc * capacity + c, -1)
    return DispatchPlan(slot_token, slot_valid, slot_weight, aux, token_slot)


def _expert_products(xin: torch.Tensor, p: dict, act: Callable
                     ) -> torch.Tensor:
    """``act(xin @ wg) * (xin @ wu) @ wd`` for each expert: xin (E, n, d)
    -> (E, n, d), the weights cast to xin's type a block at a time."""
    wg, wu, wd = p["wg"], p["wu"], p["wd"]
    E = xin.shape[0]
    block = E
    if wg.dtype != xin.dtype:
        per_expert = 3 * wg[0].numel() * xin.element_size()
        block = max(1, min(E, _CAST_BLOCK_BYTES // per_expert))
    out = []
    for e0 in range(0, E, block):
        x_b = xin[e0:e0 + block]
        g, u, dn = (w[e0:e0 + block].to(xin.dtype) for w in (wg, wu, wd))
        out.append(torch.bmm(act(torch.bmm(x_b, g)) * torch.bmm(x_b, u),
                             dn))
    return out[0] if len(out) == 1 else torch.cat(out)


def moe_ffn(x: torch.Tensor, p: dict, *, top_k: int,
            capacity_factor: float, act: Callable, dp_shards: int = 1
            ) -> tuple:
    """MoE feed-forward.

    Args:
      x: (B, S, d) activations.
      p: ``router`` (d, E), ``wg``, ``wu`` (E, d, f), ``wd`` (E, f, d); the
        expert stacks in any floating type (cast to x's a block at a time).
    Returns: ``(out (B, S, d) in x's type, aux_loss ())``.
    """
    B, S, d = x.shape
    E = p["router"].shape[1]
    T = B * S
    if T % dp_shards:
        raise ValueError(f"{T} tokens do not split into {dp_shards} shards")
    Sh, T_local = dp_shards, T // dp_shards
    xs = x.reshape(Sh, T_local, d)
    # the reference's preferred_element_type=float32: products of the
    # compute-type values, summed in float32
    logits = xs.float() @ p["router"].float()
    C = moe_capacity(T_local, top_k, E, capacity_factor)
    plan = moe_dispatch_indices(logits, top_k, C)

    # gather each slot's token, zero where the slot is empty
    xin = torch.gather(xs, 1, plan.slot_token.reshape(Sh, E * C, 1)
                       .expand(-1, -1, d))
    xin = xin * plan.slot_valid.reshape(Sh, E * C, 1).to(xin.dtype)
    xin = xin.reshape(Sh, E, C, d).transpose(0, 1).reshape(E, Sh * C, d)
    y = _expert_products(xin, p, act)
    y = y.reshape(E, Sh, C, d).transpose(0, 1)                # (Sh,E,C,d)
    y = y * (plan.slot_weight * plan.slot_valid)[..., None].to(y.dtype)
    y = y.reshape(Sh, E * C, d)

    # combine: each token's expert outputs in ascending expert order
    out = torch.zeros((Sh, T_local, d), dtype=y.dtype, device=y.device)
    for j in range(top_k):
        s = plan.token_slot[..., j]
        got = torch.gather(y, 1, s.clamp(min=0)[..., None].expand(-1, -1, d))
        out = out + torch.where((s >= 0)[..., None], got, 0.0)
    return out.reshape(B, S, d), plan.aux_loss
