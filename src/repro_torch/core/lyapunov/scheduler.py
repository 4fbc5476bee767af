"""Drift-plus-penalty scheduler — closed-form P4–P7 decisions (paper §4.3).

The torch counterpart of ``repro.core.lyapunov.scheduler.schedule_slot``.
Each slot, given observed arrivals/channel state and the queue backlogs
Θ(t) = (H, Q, E, R, R_server), we minimize the Lemma-4 upper bound of the
one-slot drift-plus-penalty Δ_V(t).  The bound separates into four
independent subproblems with closed forms:

  P4  auxiliary variable  : y*_m = clip(V/(H_m ln2) − 1, 0, D_m)
  P5  admission           : d*_m = D_m · 1[Q_m < H_m]
  P6  energy intake       : e*_store = E^H_m · 1[E_m < θ_m]   (perturbed)
  P7  transmission time   : continuous knapsack over ΣL(t) sub-channel time,
                            marginal utility per unit time
                              w_m = Q_m·r_m + (E_m−θ_m)·p_m − R_server·ξ_m·r_m,
                            per-worker cap min(T, Q_m/r_m, E_m/p_m)
  (+) worker compute      : f*_m = min(f_max, R_m) work-conserving when the
                            battery covers e_com (drift term −R_m f_m).

P6/P7 use the perturbed energy weight (E_m − θ_m) with θ = E_cap/2 by
default, as the reference does.  Every operation is elementwise float32
on the caller's device except the P7 sort, which is stable so that ties
(every idle worker has w = 0) order by index as ``jnp.argsort`` does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .queues import QueueState, SystemParams, step_queues

__all__ = ["Observation", "Decisions", "jain_index", "schedule_slot"]

_LN2 = 0.6931471805599453


class Observation(NamedTuple):
    D: torch.Tensor           # (M,) arrival data this slot (from backprop)
    r: torch.Tensor           # (M,) channel capacity (bytes / unit time)
    E_H: torch.Tensor         # (M,) harvestable energy this slot
    L: torch.Tensor           # ()   available sub-channels
    new_cycles: torch.Tensor  # (M,) new compute work arriving at workers


class Decisions(NamedTuple):
    y: torch.Tensor
    d: torch.Tensor
    nu: torch.Tensor          # (M,) transmission time
    c: torch.Tensor           # (M,) transmitted data
    e_store: torch.Tensor
    e_up: torch.Tensor
    e_com: torch.Tensor
    f: torch.Tensor


def _p4_auxiliary(H: torch.Tensor, D: torch.Tensor,
                  V: torch.Tensor) -> torch.Tensor:
    """P4: maximize V·log2(1+y) − H·y over y ∈ [0, D] (concave in y).

    Stationary point y* = V/(H·ln2) − 1; gate: y* > 0 ⟺ V/ln2 > H.
    """
    unconstrained = V / (torch.clamp(H, min=1e-12) * _LN2) - 1.0
    y = torch.minimum(torch.clamp(unconstrained, min=0.0), D)
    return torch.where(V / _LN2 - H <= 0.0, torch.zeros_like(y), y)


def _p5_admission(Q: torch.Tensor, H: torch.Tensor,
                  D: torch.Tensor) -> torch.Tensor:
    """P5: minimize (Q−H)·d over d ∈ [0, D]."""
    return torch.where(Q < H, D, torch.zeros_like(D))


def _p6_energy(E: torch.Tensor, E_H: torch.Tensor,
               theta: torch.Tensor) -> torch.Tensor:
    """P6 (perturbed): store harvested energy when battery below θ."""
    return torch.where(E < theta, E_H, torch.zeros_like(E_H))


def _p7_knapsack(Q: torch.Tensor, E: torch.Tensor, R_server: torch.Tensor,
                 r: torch.Tensor, L: torch.Tensor, params: SystemParams,
                 theta: torch.Tensor) -> torch.Tensor:
    """P7: allocate transmission time ν over Σν ≤ T·L (continuous knapsack).

    Greedy: sort by marginal utility (stable, so ties keep index order),
    prefix-sum the caps, give each worker the clipped remainder.
    """
    T = params.T
    w = Q * r + (E - theta) * params.p - R_server * params.xi * r
    cap = torch.minimum(torch.minimum(T.expand_as(r),
                                      Q / torch.clamp(r, min=1e-12)),
                        E / torch.clamp(params.p, min=1e-12))
    cap = torch.where((w > 0.0) & (Q > 0.0), torch.clamp(cap, min=0.0),
                      torch.zeros_like(cap))
    order = torch.argsort(-w, stable=True)
    cap_sorted = cap[order]
    budget = T * L
    before = torch.cumsum(cap_sorted, 0) - cap_sorted
    alloc_sorted = torch.minimum(torch.clamp(budget - before, min=0.0),
                                 cap_sorted)
    nu = torch.zeros_like(cap)
    nu[order] = alloc_sorted
    return nu


def schedule_slot(state: QueueState, params: SystemParams, obs: Observation,
                  *, theta: Optional[torch.Tensor] = None
                  ) -> tuple[QueueState, Decisions]:
    """One slot: closed-form P4–P7 decisions, then queue evolution."""
    if theta is None:
        theta = 0.5 * params.E_cap
    y = _p4_auxiliary(state.H, obs.D, params.V)
    d = _p5_admission(state.Q, state.H, obs.D)
    e_store = _p6_energy(state.E, obs.E_H, theta)
    nu = _p7_knapsack(state.Q, state.E, state.R_server, obs.r, obs.L,
                      params, theta)
    c = torch.minimum(state.Q, obs.r * nu)                     # Eq. (6)
    e_up = params.p * nu                                       # Eq. (9)
    # work-conserving compute, capped by energy the battery can cover
    f_energy_cap = torch.clamp(state.E - e_up, min=0.0) / torch.clamp(
        params.delta, min=1e-12)
    f = torch.minimum(torch.minimum(params.f_max, state.R), f_energy_cap)
    e_com = f * params.delta                                   # Eq. (10)
    new_state = step_queues(state, params, d=d, c=c, y=y, e_store=e_store,
                            e_up=e_up, e_com=e_com, f=f,
                            new_cycles=obs.new_cycles)
    return new_state, Decisions(y=y, d=d, nu=nu, c=c, e_store=e_store,
                                e_up=e_up, e_com=e_com, f=f)


def jain_index(x) -> float:
    """Jain's fairness index ``(Σx)² / (n·Σx²)`` of a non-negative share
    vector (a sequence, numpy array or tensor), on the host in float64.

    The reference's conventions (``repro.telemetry.metrics.jain_index``):
    the value lies in ``(0, 1]`` when some share is positive, the all-zero
    or empty allocation gives 1.0, negative shares raise.  Unlike the
    reference, the shares are divided by the largest one before squaring,
    so shares whose squares underflow still give the right value (the
    reference returns NaN for ``[1e-200]``).
    """
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x, np.float64).ravel()
    if x.size and (x < 0).any():
        raise ValueError("jain_index wants non-negative shares")
    top = x.max() if x.size else 0.0
    if top <= 0.0:
        return 1.0
    y = x / top
    return float(y.sum() ** 2 / (x.size * np.square(y).sum()))
