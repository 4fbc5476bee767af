"""Coded gradient train step: the paper's pipeline as one ordinary step.

The torch counterpart of ``repro.core.coded_step``:

  encode  = a weighting of the per-slot losses (gradient linearity: one
            backward over coefficient-weighted losses IS the coded partial
            gradient Σ_k B[m,k]·g_k)
  decode  = each worker's losses further scaled by its decode weight a_m:
            ∇ Σ_m a_m Σ_s c_{m,s} ℓ(slot_{m,s})  =  Σ_m a_m ĝ_m  =  Σ_k g_k

so one backward gives the exact full-batch gradient, and the straggler
pattern enters as data (the weights).  The host-side ``TwoStageRuntime``
builds the slot assignment (``SlotPlan``) and the per-slot weights
``a_m·B[m,k]`` each epoch; the training bridge reads the epoch's coding
matrix and decode weights back off them.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.optim.optimizers import (clip_by_global_norm, tree_leaves,
                                          tree_map, tree_unflatten)

__all__ = ["SlotPlan", "build_slot_plan", "slot_weights", "slot_batch",
           "make_train_step", "make_coded_train_step"]


@dataclasses.dataclass(frozen=True)
class SlotPlan:
    """Static-shape slot layout for one epoch.

    slot_partition[m, s] — global partition id computed in worker m's slot s
    (-1 = unused slot); slot_coeff[m, s] — coding coefficient B[m, k].
    """
    slot_partition: np.ndarray      # (M, n_slots) int
    slot_coeff: np.ndarray          # (M, n_slots) float
    M: int
    n_slots: int


def build_slot_plan(schemes: list, M: int, n_slots: Optional[int] = None
                    ) -> SlotPlan:
    """Pack one or more coding schemes (stage-1 rows + stage-2 rows) into the
    per-worker slot layout.  Rows of each scheme map to global worker ids via
    ``scheme.workers``; columns to global partitions via ``scheme.partitions``.
    """
    assign: list = [[] for _ in range(M)]
    for scheme in schemes:
        B = scheme.B
        for r, w in enumerate(np.asarray(scheme.workers)):
            for c in np.flatnonzero(B[r] != 0.0):
                assign[int(w)].append((int(scheme.partitions[c]),
                                       float(B[r, c])))
    width = max((len(a) for a in assign), default=1)
    n_slots = n_slots or max(width, 1)
    if width > n_slots:
        raise ValueError(f"need {width} slots, layout has {n_slots}")
    part = -np.ones((M, n_slots), np.int64)
    coef = np.zeros((M, n_slots), np.float64)
    for m, a in enumerate(assign):
        for s, (k, b) in enumerate(a):
            part[m, s] = k
            coef[m, s] = b
    return SlotPlan(slot_partition=part, slot_coeff=coef, M=M,
                    n_slots=n_slots)


def slot_weights(plan: SlotPlan, decode_w: np.ndarray) -> np.ndarray:
    """(M, n_slots) per-slot loss weights  a_m · B[m,k]  (0 for unused)."""
    w = plan.slot_coeff * decode_w[:, None]
    w[plan.slot_partition < 0] = 0.0
    return w


def slot_batch(dataset, epoch: int, plan: SlotPlan, device,
               phase: Optional[Callable] = None) -> dict:
    """``{key: (M, n_slots, ...)}`` on ``device``: slot (m, s) holds
    partition ``plan.slot_partition[m, s]`` of ``dataset`` at ``epoch``
    (each partition drawn once), an unused slot zeros.  The slots are
    stacked where the dataset lives and copied to ``device`` once.
    ``phase(name)``, when given, is a context-manager factory wrapped
    around ``draw``, ``stack`` and ``copy``."""
    phase = phase or (lambda name: contextlib.nullcontext())
    with phase("draw"):
        used = sorted({0} | {int(k) for k in plan.slot_partition.flat
                             if k >= 0})
        parts = {k: dataset.partition(epoch, k) for k in used}
        zeros = {key: torch.zeros_like(v) for key, v in parts[0].items()}
    with phase("stack"):
        slots = [parts[int(k)] if k >= 0 else zeros
                 for k in plan.slot_partition.flat]
        stacked = {key: torch.stack([src[key] for src in slots]).reshape(
            (plan.M, plan.n_slots) + tuple(zeros[key].shape))
            for key in zeros}
    with phase("copy"):
        return {key: v.to(device) for key, v in stacked.items()}


# --------------------------------------------------------------------- #
def _value_and_grad(loss_fn: Callable) -> Callable:
    """``(params, *args) -> (loss, grads)`` by autograd, leaving the
    caller's tensors untouched.  A leaf the loss does not use gets a zero
    gradient, as under ``jax.grad`` (an audio config never reads its
    token embedding)."""
    def fn(params, *args):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(live, *args)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), tree_unflatten(live, grads)
    return fn


def make_train_step(loss_fn: Callable, optimizer, *,
                    grad_transform: Optional[Callable] = None,
                    clip_norm: float = 0.0) -> Callable:
    """Standard step: ``(params, opt_state, batch) -> (params, opt_state,
    aux)``.

    ``loss_fn(params, batch) -> scalar``; ``aux`` holds ``loss`` and
    ``grad_norm`` (the global norm before clipping, 0 without
    ``clip_norm``).  ``grad_transform(grads) -> grads`` hooks in gradient
    compression.
    """
    grad = _value_and_grad(loss_fn)

    def step(params, opt_state, batch):
        loss, grads = grad(params, batch)
        gn = torch.zeros((), device=loss.device)
        if clip_norm:
            grads, gn = clip_by_global_norm(grads, clip_norm)
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": gn}

    return step


def make_coded_train_step(per_slot_loss_fn: Callable,
                          optimizer) -> Callable:
    """Coded step over slotted batches: ``(params, opt_state, slot_batch,
    weights) -> (params, opt_state, {"loss"})``.

    ``per_slot_loss_fn(params, slot_batch) -> (M, n_slots)`` per-slot mean
    losses.  The step contracts them with the runtime's weight matrix
    (a_m·B[m,k]) and takes one backward: by linearity its gradient is the
    exact decoded full gradient.
    """
    grad = _value_and_grad(
        lambda p, slot_batch, weights: torch.sum(
            per_slot_loss_fn(p, slot_batch) * weights))

    def step(params, opt_state, slot_batch, weights):
        loss, grads = grad(params, slot_batch, weights)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss}

    return step
