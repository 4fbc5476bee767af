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
reference's do.  Every function here is generic over leading axes: one
cluster's state is ``(M,)`` rows and a 0-d ``R_server``; a fleet's is
``(S, M)`` rows and an ``(S,)`` ``R_server``.

Reductions along the worker axis are written out so that they round as
the reference's compiled code does, whatever the shape or the device:
:func:`prefix_sum_last` adds in float32 strictly from left to right (the
reference's ``jnp.cumsum``), and :func:`dot_last` is the server queue's
``jnp.sum(c * xi)``, which XLA's CPU backend compiles into a chain of
fused multiply-adds, ``acc = fma(c_j, xi_j, acc)`` from left to right.
``torch.sum``/``torch.cumsum`` accumulate float32 in double on the CPU,
and on the card they may pair addends differently for an ``(M,)`` and an
``(S, M)`` tensor; either would break the bit-equality between the
engines and with the reference.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

__all__ = ["QueueState", "SystemParams", "dot_last", "init_queues",
           "make_system_params", "prefix_sum_last", "stack_system_params",
           "step_queues"]


def _fma_f32_from_double(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``p + c`` rounded once to float32 — a fused multiply-add — for a
    float64 ``p`` that holds an exact product of two float32 values and a
    float32 ``c``.

    The sum is rounded to float64 and then made *odd* where it was inexact
    (round to odd, from the exact error of the sum), so that the final
    rounding to float32 gives the correctly rounded result (53 ≥ 24 + 2
    bits).
    """
    c64 = c.double()
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    # err · inf is ±inf: the direction of the exact sum from s
    s = torch.where((err != 0) & even,
                    torch.nextafter(s, err * float("inf")), s)
    return s.float()


def dot_last(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``Σ_j a_j·b_j`` over the last axis as a left-to-right chain of
    float32 fused multiply-adds: ``acc = a_0·b_0``, then ``acc =
    fma(a_j, b_j, acc)`` — what XLA's CPU backend makes of
    ``jnp.sum(a * b)``."""
    n = a.shape[-1]
    if n == 0:
        return torch.zeros(a.shape[:-1], dtype=a.dtype, device=a.device)
    acc = a[..., 0] * b[..., 0]
    if n > 1:
        prods = a.double() * b.double()        # exact, every j at once
        for j in range(1, n):
            acc = _fma_f32_from_double(prods[..., j], acc)
    return acc


def prefix_sum_last(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis, in ``x``'s dtype, each
    entry added strictly from left to right: ``((x0 + x1) + x2) + …``."""
    n = x.shape[-1]
    if n == 0:
        return x.clone()
    acc = x[..., 0]
    out = [acc]
    for j in range(1, n):
        acc = acc + x[..., j]
        out.append(acc)
    return torch.stack(out, dim=-1)


class QueueState(NamedTuple):
    Q: torch.Tensor          # (…, M) data backlog
    H: torch.Tensor          # (…, M) virtual admission queue
    E: torch.Tensor          # (…, M) energy backlog
    R: torch.Tensor          # (…, M) worker cycle backlog
    R_server: torch.Tensor   # (…)    server cycle backlog


@dataclasses.dataclass(frozen=True)
class SystemParams:
    """Static per-worker physics (paper §III.3 symbols); a fleet's rows
    carry a leading (S,) lane axis (:func:`stack_system_params`)."""
    T: torch.Tensor          # (…)    slot length
    p: torch.Tensor          # (…, M) transmit power p_m
    delta: torch.Tensor      # (…, M) energy per CPU cycle δ_m
    xi: torch.Tensor         # (…, M) server cycles per bit ξ_m
    f_max: torch.Tensor      # (…, M) max worker CPU cycles per slot
    F: torch.Tensor          # (…)    server cycles per slot F(t)
    E_cap: torch.Tensor      # (…, M) battery capacity
    V: torch.Tensor          # (…)    Lyapunov trade-off knob
    lam: torch.Tensor        # (…, M) fairness weights λ_m


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


def stack_system_params(params: Sequence[SystemParams], *,
                        device=None) -> SystemParams:
    """Stack per-lane :class:`SystemParams` along a leading (S,) axis.

    Scalar fields (``T``, ``F``, ``V``) become (S,) and (M,) fields
    (S, M), so each lane of :func:`~repro_torch.core.lyapunov.scheduler.
    batched_schedule_slot` sees exactly its own physics.  Lanes may differ
    in any value but must share the worker count M.  The stack is built on
    the host and each field makes one copy to ``device`` (default: the
    device of the first lane's fields); the values are float32 throughout,
    so nothing is rounded.  Lanes that share one ``SystemParams`` object
    (the clusters of one physics do) are read from their device once.
    """
    params = list(params)
    if not params:
        raise ValueError("stack_system_params needs at least one lane")
    dev = params[0].T.device if device is None else torch.device(device)
    fields = [f.name for f in dataclasses.fields(SystemParams)]
    host = {}
    for sp in params:
        if id(sp) not in host:
            host[id(sp)] = {name: getattr(sp, name).detach().to(
                "cpu", torch.float32).numpy() for name in fields}
    return SystemParams(**{
        name: torch.from_numpy(np.stack([host[id(sp)][name]
                                         for sp in params])).to(dev)
        for name in fields})


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
                + dot_last(c, params.xi))
    return QueueState(Q=Q, H=H, E=E, R=R, R_server=R_server)
