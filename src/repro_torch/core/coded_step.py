"""Slot layout of a coded epoch: which partition each worker computes in
each slot, with which coding coefficient.

The numpy half of ``repro.core.coded_step`` (``SlotPlan``,
``build_slot_plan``, ``slot_weights``), copied so that the port never
imports the JAX package.  The host-side ``TwoStageRuntime`` builds the slot
assignment and the per-slot weights ``a_m·B[m,k]`` each epoch; the
training bridge reads the epoch's coding matrix and decode weights back
off them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["SlotPlan", "build_slot_plan", "slot_weights"]


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
