"""Queue dynamics for the fairness transmission layer (paper Eqs. 5–13).

The torch counterpart of ``repro.core.lyapunov.queues``.  State per worker
m (vectorized over workers, float32 tensors on the caller's device):

  Q_m  — data backlog (gradient bytes waiting to be uploaded), Eq. 7
  H_m  — virtual admission queue for the auxiliary variable y, §4.3
  E_m  — battery/energy budget backlog, Eq. 11
  R_m  — worker CPU-cycle backlog, Eq. 12
plus the scalar
  R_server — server CPU-cycle backlog, Eq. 13.

Everything is float32, as in the reference (which runs with x64 off): the
scalar physics ``T``, ``F`` and ``V`` are 0-d float32 tensors, never
Python floats, so expressions such as ``V / ln2`` round in float32 as the
reference's do.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

__all__ = ["QueueState", "SystemParams", "init_queues", "make_system_params",
           "step_queues"]


class QueueState(NamedTuple):
    Q: torch.Tensor          # (M,) data backlog
    H: torch.Tensor          # (M,) virtual admission queue
    E: torch.Tensor          # (M,) energy backlog
    R: torch.Tensor          # (M,) worker cycle backlog
    R_server: torch.Tensor   # ()   server cycle backlog


@dataclasses.dataclass(frozen=True)
class SystemParams:
    """Static per-worker physics (paper §III.3 symbols)."""
    T: torch.Tensor          # ()   slot length
    p: torch.Tensor          # (M,) transmit power p_m
    delta: torch.Tensor      # (M,) energy per CPU cycle δ_m
    xi: torch.Tensor         # (M,) server cycles per bit ξ_m
    f_max: torch.Tensor      # (M,) max worker CPU cycles per slot
    F: torch.Tensor          # ()   server cycles per slot F(t)
    E_cap: torch.Tensor      # (M,) battery capacity
    V: torch.Tensor          # ()   Lyapunov trade-off knob
    lam: torch.Tensor        # (M,) fairness weights λ_m


def make_system_params(M: int, *, T: float, p: float, delta: float,
                       xi: float, f_max: float, F: float, E_cap: float,
                       V: float, device="cuda") -> SystemParams:
    """Float32 :class:`SystemParams` with per-worker fields filled from
    scalars (the reference's ``jnp.full``/``jnp.asarray`` constants)."""
    def full(x):
        return torch.full((M,), x, dtype=torch.float32, device=device)

    def scalar(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    return SystemParams(T=scalar(T), p=full(p), delta=full(delta),
                        xi=full(xi), f_max=full(f_max), F=scalar(F),
                        E_cap=full(E_cap), V=scalar(V), lam=full(1.0))


def init_queues(M: int, *, E0: float = 0.0, device="cuda") -> QueueState:
    z = torch.zeros((M,), dtype=torch.float32, device=device)
    return QueueState(Q=z, H=z, E=torch.full((M,), E0, dtype=torch.float32,
                                             device=device),
                      R=z, R_server=torch.zeros((), dtype=torch.float32,
                                                device=device))


def step_queues(state: QueueState, params: SystemParams, *,
                d: torch.Tensor, c: torch.Tensor, y: torch.Tensor,
                e_store: torch.Tensor, e_up: torch.Tensor,
                e_com: torch.Tensor, f: torch.Tensor,
                new_cycles: torch.Tensor) -> QueueState:
    """One-slot queue evolution, Eqs. 7 / (virtual H) / 11 / 12 / 13.

    Args:
      d: admitted data, c: transmitted data, y: auxiliary target,
      e_store: harvested energy stored, e_up/e_com: spent energy,
      f: worker cycles executed, new_cycles: new work arriving at workers.
    """
    Q = torch.clamp(state.Q + d - c, min=0.0)
    H = torch.clamp(state.H + y - d, min=0.0)
    E = torch.minimum(torch.clamp(state.E - e_up - e_com + e_store, min=0.0),
                      params.E_cap)
    R = torch.clamp(state.R - f, min=0.0) + new_cycles
    R_server = (torch.clamp(state.R_server - params.F, min=0.0)
                + torch.sum(c * params.xi))
    return QueueState(Q=Q, H=H, E=E, R=R, R_server=R_server)
