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
on the caller's device except three along the worker axis: the P7 sort,
which is stable so that ties (every idle worker has w = 0) order by
index as ``jnp.argsort`` does, the P7 prefix sum, which adds in float32
strictly from left to right, and the server queue's sum, a chain of
fused multiply-adds — each rounding as the reference's compiled code
does (:func:`~repro_torch.core.lyapunov.queues.prefix_sum_last`,
:func:`~repro_torch.core.lyapunov.queues.dot_last`).  So the decisions
equal the reference's bit for bit, and they do not depend on the shape
of the call or on the device.

:func:`schedule_slot` is generic over leading axes: the event-driven
oracle calls it with one cluster's ``(M,)`` rows and 0-d per-cluster
scalars (``T``, ``F``, ``V``, ``L``, ``R_server``); the batched fleet
engine calls it with ``(S, M)`` rows and ``(S,)`` per-lane scalars
(:func:`~repro_torch.core.lyapunov.queues.stack_system_params`).  A
per-lane scalar is unsqueezed where it meets an ``(…, M)`` row, so each
lane of the batched call computes exactly what the ``(M,)`` call does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .queues import QueueState, SystemParams, prefix_sum_last, step_queues

__all__ = ["Observation", "Decisions", "schedule_slot",
           "batched_schedule_slot", "batched_schedule_slot_theta",
           "run_horizon", "jain_index"]

_LN2 = 0.6931471805599453


class Observation(NamedTuple):
    D: torch.Tensor           # (…, M) arrival data this slot (from backprop)
    r: torch.Tensor           # (…, M) channel capacity (bytes / unit time)
    E_H: torch.Tensor         # (…, M) harvestable energy this slot
    L: torch.Tensor           # (…)    available sub-channels
    new_cycles: torch.Tensor  # (…, M) new compute work arriving at workers


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
    ``V`` is a per-lane scalar, ``H`` and ``D`` are rows.
    """
    V = V.unsqueeze(-1)
    unconstrained = V / (torch.clamp(H, min=1e-12) * _LN2) - 1.0
    y = torch.minimum(torch.clamp(unconstrained, min=0.0), D)
    return torch.where(V / _LN2 - H <= 0.0, 0.0, y)


def _p5_admission(Q: torch.Tensor, H: torch.Tensor,
                  D: torch.Tensor) -> torch.Tensor:
    """P5: minimize (Q−H)·d over d ∈ [0, D]."""
    return torch.where(Q < H, D, 0.0)


def _p6_energy(E: torch.Tensor, E_H: torch.Tensor,
               theta: torch.Tensor) -> torch.Tensor:
    """P6 (perturbed): store harvested energy when battery below θ."""
    return torch.where(E < theta, E_H, 0.0)


def _p7_knapsack(Q: torch.Tensor, E: torch.Tensor, R_server: torch.Tensor,
                 r: torch.Tensor, L: torch.Tensor, params: SystemParams,
                 theta: torch.Tensor) -> torch.Tensor:
    """P7: allocate transmission time ν over Σν ≤ T·L (continuous knapsack).

    Greedy: sort by marginal utility (stable, so ties keep index order),
    prefix-sum the caps, give each worker the clipped remainder.  ``R_server``
    and ``L`` are per-lane scalars; the sort, the prefix sum and the
    scatter run along the last (worker) axis.
    """
    T = params.T.unsqueeze(-1)
    w = Q * r + (E - theta) * params.p - R_server.unsqueeze(-1) \
        * params.xi * r
    cap = torch.minimum(torch.minimum(T, Q / torch.clamp(r, min=1e-12)),
                        E / torch.clamp(params.p, min=1e-12))
    cap = torch.where((w > 0.0) & (Q > 0.0), torch.clamp(cap, min=0.0),
                      0.0)
    order = torch.argsort(-w, dim=-1, stable=True)
    cap_sorted = torch.gather(cap, -1, order)
    budget = (params.T * L).unsqueeze(-1)
    before = prefix_sum_last(cap_sorted) - cap_sorted
    alloc_sorted = torch.minimum(torch.clamp(budget - before, min=0.0),
                                 cap_sorted)
    return torch.zeros_like(cap).scatter(-1, order, alloc_sorted)


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


#: ``schedule_slot`` over a fleet axis: state rows are (S, M) and
#: ``R_server`` is (S,), observation rows are (S, M) and ``L`` is (S,),
#: and the physics arrive as per-lane parameter rows
#: (:func:`~repro_torch.core.lyapunov.queues.stack_system_params`: ``T``,
#: ``F``, ``V`` (S,), the rest (S, M)).  :func:`schedule_slot` is generic
#: over leading axes, so this is the same function: each lane computes
#: exactly what an ``(M,)`` call computes.  The per-slot step of the
#: batched fleet engine (``repro_torch.sim.batched``).
batched_schedule_slot = schedule_slot


def batched_schedule_slot_theta(state: QueueState, params: SystemParams,
                                obs: Observation, theta: torch.Tensor
                                ) -> tuple[QueueState, Decisions]:
    """:func:`batched_schedule_slot` with the P6/P7 energy perturbation θ
    as a fourth positional (S, M) input, as the reference's vmapped
    wrapper takes it; ``theta = 0.5 * E_cap`` rows give the default."""
    return schedule_slot(state, params, obs, theta=theta)


def run_horizon(state: QueueState, params: SystemParams,
                obs_seq: Observation) -> tuple[QueueState, Decisions]:
    """Step the scheduler over a ``(T_slots, …)`` observation sequence:
    the final state and the decisions stacked along a leading slot axis
    (the reference's ``lax.scan``)."""
    decs = []
    for k in range(obs_seq.D.shape[0]):
        state, dec = schedule_slot(state, params, Observation(
            *(x[k] for x in obs_seq)))
        decs.append(dec)
    if not decs:
        raise ValueError("run_horizon needs at least one slot")
    return state, Decisions(*(torch.stack(xs) for xs in zip(*decs)))


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
