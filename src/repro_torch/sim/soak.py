"""Steady-state Lyapunov soak harness, in torch.

The torch port of ``repro.sim.soak``.  Runs the P4–P7 drift-plus-penalty
scheduler *alone* — no coded compute phase, no epoch boundaries — for
many slots per lane, so the paper's steady-state claims (queue stability,
O(V) backlog, throughput–fairness trade-off) become measurable.

  lanes
      A :class:`SoakLane` is a :class:`~repro_torch.sim.spec.ScenarioSpec`
      plus the admission knobs the policy layer sweeps — the energy
      perturbation fraction ``theta_frac`` (θ = frac · E_cap) and the
      arrival scale ``D_scale`` on top of a ``load`` factor.  Lane physics
      resolve through :func:`~repro_torch.sim.spec.build_cluster`, so a
      soaked scenario is exactly the scenario the fleets run.

  open-loop offered load
      Arrivals are drawn per slot as ``D_m = D_scale · load · r̄_m·T·L/M ·
      U(0.5, 1.5)``: the mean offered load is a ``load`` multiple of the
      lane's fair-share uplink capacity.

  chunked loop with a compact moments carry
      ``run_soak`` runs ``chunk`` slots per host step on the lanes'
      device.  The carry is the float32
      :class:`~repro_torch.core.lyapunov.queues.QueueState`, the
      Gilbert–Elliott ``good`` mask where the scenario needs one, and
      float64 running moments (per-queue sums and maxima, admission and
      delivery totals, the drift moments ``Σ qtot`` and ``Σ t·qtot``).
      Memory is O(S·M) whatever the horizon.

  counter-based randomness
      Every slot's uniforms are the reference's ``jax.random.uniform(
      fold_in(PRNGKey(seed), k), (3, M), float32)`` on the absolute slot
      index, computed bit for bit on the host by
      :mod:`repro_torch.sim.threefry` and shared by all lanes (common
      random numbers: a scenario's V-grid cells are paired comparisons).
      A chunk's draws, arrivals, harvest and (table family) channel rates
      are computed on the host in one vectorised pass and cross to the
      device in one copy; they depend only on ``k``, never on the chunk
      split, and the carry is strictly sequential, so the soak is bitwise
      chunk-invariant.

Exactness against the reference (``tests/test_torch_soak.py``): the
float32 state is bit-equal.  The reference computes the harvest draw
``h_lo + h_span·u`` inside its jitted scan, where XLA's CPU code fuses it
into one multiply-add; the port takes the same correctly rounded fused
multiply-add (:func:`_harvest`).  ``D_base · (0.5 + u)`` is not fused
there.  The float64 moments are held at rtol 1e-12: XLA may contract
``s + t·qtot`` too, and eager torch has no cheap exact float64 fused
multiply-add.

Lanes group by :func:`soak_compat_key` — worker count plus channel
*family* (``"table"`` for static/trace, run as a padded per-lane rate
table; ``"ge"`` for Gilbert–Elliott, whose state rides the carry).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.lyapunov import (Observation, QueueState,
                                       batched_schedule_slot_theta,
                                       init_queues, stack_system_params)
from repro_torch.core.lyapunov.queues import _fma_f32_from_double
from repro_torch.sim.batched import _to_device
from repro_torch.sim.channel import (GilbertElliottChannel, StaticChannel,
                                     TraceChannel)
from repro_torch.sim.spec import ScenarioSpec, build_cluster
from repro_torch.sim.threefry import slot_uniforms
from repro_torch.telemetry.metrics import jain_index, slope_from_moments

__all__ = ["SoakLane", "SoakResult", "soak_compat_key", "run_soak",
           "soak_observations", "initial_state", "lane_theta",
           "lane_capacity", "DEFAULT_CHUNK"]

#: Default chunk length (slots per host step), the reference's.
DEFAULT_CHUNK = 10_000


@dataclasses.dataclass(frozen=True)
class SoakLane:
    """One soak lane: a scenario plus the swept admission knobs.

    The Lyapunov ``V`` is read from ``scenario.comm.V`` — sweep it with
    ``spec.with_overrides(V=...)``.  ``theta_frac`` sets the P6/P7
    energy perturbation θ = frac · E_cap; ``load`` and ``D_scale`` scale
    the offered arrival mean.
    """
    scenario: ScenarioSpec
    theta_frac: float = 0.5
    D_scale: float = 1.0
    load: float = 1.2

    def __post_init__(self):
        if not isinstance(self.scenario, ScenarioSpec):
            raise TypeError(f"SoakLane.scenario wants a ScenarioSpec, got "
                            f"{type(self.scenario).__name__}")
        if not 0.0 <= self.theta_frac <= 1.0:
            raise ValueError(f"theta_frac must be in [0, 1], got "
                             f"{self.theta_frac}")
        if self.D_scale <= 0.0 or self.load <= 0.0:
            raise ValueError("D_scale and load must be positive")

    @property
    def V(self) -> float:
        return float(self.scenario.comm.V)


def soak_compat_key(lane: SoakLane) -> Tuple:
    """Structural signature: lanes with equal keys run in one stacked
    loop.  Static and trace channels share the ``"table"`` family (a
    static channel is a 1-row table; tables pad to the group maximum)."""
    kind = "ge" if lane.scenario.channel.kind == "gilbert-elliott" \
        else "table"
    return (lane.scenario.M, kind)


@dataclasses.dataclass(frozen=True)
class SoakResult:
    """Per-lane steady-state estimates (post-warmup unless noted).

    Arrays are numpy, lane-major: (S,) or (S, M).  ``throughput`` is
    delivered bytes per slot summed over workers; ``jain`` is the Jain
    index of per-worker delivered bytes; ``drift_ratio`` is
    ``|slope| · n / (mean_qtot + 1)`` (≈ 0 for a stable queue system).
    ``final`` (the port's addition) holds the float32 state after the
    last slot: ``Q``, ``H``, ``E``, ``R`` (S, M), ``R_server`` (S,) and,
    for the Gilbert–Elliott family, ``good`` (S, M).
    """
    lanes: Tuple[SoakLane, ...]
    n_slots: int
    warmup: int
    chunk: int
    mean_Q: np.ndarray          # (S, M) time-averaged data backlog
    max_Q: np.ndarray           # (S, M) peak data backlog
    mean_H: np.ndarray          # (S, M) time-averaged virtual queue
    mean_E: np.ndarray          # (S, M) time-averaged battery level
    admitted: np.ndarray        # (S, M) total bytes admitted
    delivered: np.ndarray       # (S, M) total bytes delivered
    mean_y: np.ndarray          # (S, M) time-averaged auxiliary rate
    drift_slope: np.ndarray     # (S,) backlog LS slope, bytes/slot
    drift_ratio: np.ndarray     # (S,) |slope|·n / (mean backlog + 1)
    throughput: np.ndarray      # (S,) delivered bytes/slot (all workers)
    jain: np.ndarray            # (S,) fairness of per-worker delivery
    utility: np.ndarray         # (S,) Σ_m log(1 + ȳ_m), the P4 objective
    final: Optional[dict] = None

    @property
    def mean_qtot(self) -> np.ndarray:
        return self.mean_Q.sum(axis=1)


# --------------------------------------------------------------------- #
# lane physics -> stacked group arrays
# --------------------------------------------------------------------- #
def _lane_physics(lane: SoakLane) -> dict:
    """Host-side numpy physics of one lane, via the co-sim's own
    ``build_cluster`` (so soak physics == fleet physics)."""
    spec = lane.scenario
    cl = build_cluster(spec, "uncoded", seed=0, device="cpu")
    ch, cp, M = cl.channel, cl.comm, spec.M
    r_nom = ch.nominal_rates()
    if r_nom is None:                       # custom model: flat fallback
        r_nom = np.ones(M)
    # a non-looping trace holds its last row forever, so the long-run
    # service rate is that row
    if isinstance(ch, TraceChannel) and not ch.loop:
        r_nom = ch.trace[-1]
    # hard throughput envelope: Σ_m ν_m·r_m ≤ T·L·max r — the *peak* rate
    if isinstance(ch, GilbertElliottChannel):
        peak = max(float(ch.rate_good.max()), float(ch.rate_bad.max()))
    elif isinstance(ch, TraceChannel):
        peak = float(ch.trace.max())
    else:
        peak = float(np.max(r_nom))
    T, L = float(cp.slot_T), float(cp.n_subchannels)
    jit_h = float(cp.harvest_jitter)
    lo = max(1.0 - jit_h, 0.0)
    out = {
        "sys": cl.sys_params,
        "L": L,
        "E0": float(cp.E0),
        "theta": lane.theta_frac * float(cp.E_cap) * np.ones(M),
        "D_base": (lane.load * lane.D_scale * np.asarray(r_nom, np.float64)
                   * T * L / M),
        "h_lo": float(cp.harvest_mean) * lo * np.ones(M),
        "h_span": float(cp.harvest_mean) * ((1.0 + jit_h) - lo) * np.ones(M),
        "capacity": peak * T * L,          # bytes/slot hard envelope
    }
    if isinstance(ch, GilbertElliottChannel):
        out.update(kind="ge", rate_good=ch.rate_good, rate_bad=ch.rate_bad,
                   p_gb=ch.p_gb, p_bg=ch.p_bg, start_good=ch._start_good)
    elif isinstance(ch, (StaticChannel, TraceChannel)):
        if isinstance(ch, StaticChannel):
            table, loop = ch.rates_for_slots(np.arange(1)), True
        else:
            table, loop = ch.trace, ch.loop
        out.update(kind="table", table=np.asarray(table, np.float64),
                   loop=loop)
    else:
        raise ValueError(f"soak supports static/trace/gilbert-elliott "
                         f"channels, got {type(ch).__name__}")
    return out


def _stack_group(lanes: Sequence[SoakLane], device) -> dict:
    """Stack per-lane physics into the (S, …) rows one loop consumes: the
    scheduler's inputs on ``device``, the draw-side rows (float32) on the
    host.  All lanes must share :func:`soak_compat_key`."""
    phys = [_lane_physics(ln) for ln in lanes]
    kinds = {p["kind"] for p in phys}
    Ms = {ln.scenario.M for ln in lanes}
    if len(kinds) != 1 or len(Ms) != 1:
        raise ValueError(f"soak group mixes structures: kinds={kinds}, "
                         f"M={Ms}; group lanes by soak_compat_key first")
    kind, (M,) = kinds.pop(), Ms
    dev = torch.device(device)

    def f32(rows):
        return np.asarray(np.stack(rows), np.float32)

    g = {
        "kind": kind, "S": len(lanes), "M": M, "device": dev,
        "params": stack_system_params([p["sys"] for p in phys], device=dev),
        "L": _to_device(f32([p["L"] for p in phys]), dev),
        "theta": _to_device(f32([p["theta"] for p in phys]), dev),
        "D_base": f32([p["D_base"] for p in phys]),
        "h_lo": f32([p["h_lo"] for p in phys]),
        "h_span": f32([p["h_span"] for p in phys]),
        "E0": np.asarray([p["E0"] for p in phys], np.float64),
        "capacity": np.asarray([p["capacity"] for p in phys], np.float64),
    }
    if kind == "table":
        R = max(p["table"].shape[0] for p in phys)
        tables, n_rows = [], []
        for p in phys:
            t = p["table"]
            n_rows.append(t.shape[0])
            if t.shape[0] < R:              # padding rows are never read
                t = np.concatenate(
                    [t, np.repeat(t[-1:], R - t.shape[0], axis=0)])
            tables.append(t)
        g["table"] = f32(tables)                              # (S, R, M)
        g["n_rows"] = np.asarray(n_rows, np.int64)            # (S,)
        g["loop"] = np.asarray([p["loop"] for p in phys], bool)
    else:
        g["rate_good"] = _to_device(f32([p["rate_good"] for p in phys]), dev)
        g["rate_bad"] = _to_device(f32([p["rate_bad"] for p in phys]), dev)
        g["p_gb"] = _to_device(f32([[p["p_gb"]] for p in phys]), dev)
        g["p_bg"] = _to_device(f32([[p["p_bg"]] for p in phys]), dev)
        g["good0"] = _to_device(
            np.stack([np.full(M, p["start_good"], bool) for p in phys]), dev)
    return g


# --------------------------------------------------------------------- #
# a chunk's inputs, on the host
# --------------------------------------------------------------------- #
def _harvest(h_lo: np.ndarray, h_span: np.ndarray,
             u: np.ndarray) -> np.ndarray:
    """``h_lo + h_span·u`` in float32 as one correctly rounded fused
    multiply-add — what the reference's jitted scan computes there."""
    h_lo, h_span, u = np.broadcast_arrays(h_lo, h_span, u)
    prod = torch.from_numpy(h_span.astype(np.float64) * u.astype(np.float64))
    return _fma_f32_from_double(prod, torch.from_numpy(
        np.ascontiguousarray(h_lo))).numpy()


def _table_rows(g: dict, ks: np.ndarray) -> np.ndarray:
    """(n, S, M) rate rows of slots ``ks``: each lane's table row, looped
    or held at its last row."""
    n_rows = g["n_rows"][None, :]
    idx = np.where(g["loop"][None, :], ks[:, None] % n_rows,
                   np.minimum(ks[:, None], n_rows - 1))          # (n, S)
    return g["table"][np.arange(g["S"])[None, :], idx]


def _chunk_inputs(g: dict, u: np.ndarray, k0: int) -> np.ndarray:
    """``(fields, n, S, M)`` float32 inputs of slots ``k0 …``: arrivals,
    harvest, and the rate rows (table family) or the channel uniforms
    (Gilbert–Elliott)."""
    n = u.shape[0]
    S, M = g["S"], g["M"]
    host = np.empty((3, n, S, M), np.float32)
    host[0] = g["D_base"][None] * (np.float32(0.5) + u[:, None, 0])
    host[1] = _harvest(g["h_lo"][None], g["h_span"][None], u[:, None, 1])
    if g["kind"] == "table":
        host[2] = _table_rows(g, np.arange(k0, k0 + n))
    else:
        host[2] = u[:, None, 2]
    return host


# --------------------------------------------------------------------- #
# the loop
# --------------------------------------------------------------------- #
def _sum_left(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis strictly from left to right."""
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def _run_chunk(g: dict, carry: tuple, x: torch.Tensor, k0: int,
               warmup: int) -> tuple:
    """Advance every lane by the slots of one chunk's inputs ``x``."""
    state, good, mom = carry
    zeros = torch.zeros_like(state.Q)
    for j in range(x.shape[1]):
        k = k0 + j
        if g["kind"] == "table":
            r = x[2, j]
        else:
            r = torch.where(good, g["rate_good"], g["rate_bad"])
            u2 = x[2, j]
            good = torch.where(good, u2 >= g["p_gb"], u2 < g["p_bg"])
        obs = Observation(D=x[0, j], r=r, E_H=x[1, j], L=g["L"],
                          new_cycles=zeros)
        state, dec = batched_schedule_slot_theta(state, g["params"], obs,
                                                 g["theta"])
        if k < warmup:
            # the reference adds w·x with w = 0 here: for finite x that
            # leaves every moment as it is
            continue
        t = float(k - warmup)
        rows = torch.stack([state.Q, state.H, state.E, dec.d, dec.c,
                            dec.y]).double()        # (6, S, M)
        qtot = _sum_left(rows[0])
        mom = {"s_q": mom["s_q"] + qtot,
               "s_tq": mom["s_tq"] + t * qtot,
               "sums": mom["sums"] + rows,
               "max_Q": torch.maximum(mom["max_Q"], rows[0])}
    return state, good, mom


def _init_carry(g: dict) -> tuple:
    S, M, dev = g["S"], g["M"], g["device"]
    z = torch.zeros((S, M), dtype=torch.float32, device=dev)
    E = _to_device(np.broadcast_to(g["E0"][:, None], (S, M))
                   .astype(np.float32), dev)
    state = QueueState(Q=z, H=z, E=E, R=z,
                       R_server=torch.zeros((S,), dtype=torch.float32,
                                            device=dev))
    good = g.get("good0")
    zl = torch.zeros((S,), dtype=torch.float64, device=dev)
    mom = {"s_q": zl, "s_tq": zl,
           "sums": torch.zeros((6, S, M), dtype=torch.float64, device=dev),
           "max_Q": torch.zeros((S, M), dtype=torch.float64, device=dev)}
    return state, good, mom


def run_soak(lanes: Sequence[SoakLane], n_slots: int, *,
             warmup: Optional[int] = None, chunk: int = DEFAULT_CHUNK,
             seed: int = 0, device="cuda") -> SoakResult:
    """Soak every lane for ``n_slots`` slots on ``device`` (the card unless
    the caller asks for ``"cpu"``) and reduce the moments.

    All lanes must share one :func:`soak_compat_key`.  ``warmup``
    (default ``n_slots // 5``) slots are simulated but excluded from
    every moment.  Results are bitwise independent of ``chunk``.  Nothing
    in the loop waits for the device; the host reads the carry at the
    end.
    """
    lanes = tuple(lanes)
    if not lanes:
        raise ValueError("run_soak needs at least one lane")
    if len({soak_compat_key(ln) for ln in lanes}) != 1:
        raise ValueError("lanes span multiple soak groups; partition by "
                         "soak_compat_key (repro_torch.sim.policy does)")
    if warmup is None:
        warmup = n_slots // 5
    if not 0 <= warmup < n_slots:
        raise ValueError(f"need 0 <= warmup < n_slots, got warmup="
                         f"{warmup}, n_slots={n_slots}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    g = _stack_group(lanes, device)
    carry = _init_carry(g)
    for step in range(math.ceil(n_slots / chunk)):
        k0 = step * chunk
        n = min(chunk, n_slots - k0)
        u = slot_uniforms(seed, k0, n, g["M"])
        x = _to_device(_chunk_inputs(g, u, k0), g["device"])
        carry = _run_chunk(g, carry, x, k0, warmup)
    state, good, mom = carry
    final = {f: getattr(state, f).cpu().numpy() for f in QueueState._fields}
    if good is not None:
        final["good"] = good.cpu().numpy()
    sums = mom["sums"].cpu().numpy()
    s_q, s_tq = mom["s_q"].cpu().numpy(), mom["s_tq"].cpu().numpy()
    max_Q = mom["max_Q"].cpu().numpy()

    n = float(n_slots - warmup)
    s_t = n * (n - 1.0) / 2.0                       # Σt, t = 0..n-1
    s_tt = (n - 1.0) * n * (2.0 * n - 1.0) / 6.0    # Σt²
    slope = np.atleast_1d(slope_from_moments(n, s_t, s_tt, s_q, s_tq))
    mean_qtot = s_q / n
    delivered = sums[4]
    return SoakResult(
        lanes=lanes, n_slots=int(n_slots), warmup=int(warmup),
        chunk=int(chunk),
        mean_Q=sums[0] / n, max_Q=max_Q,
        mean_H=sums[1] / n, mean_E=sums[2] / n,
        admitted=sums[3], delivered=delivered,
        mean_y=sums[5] / n,
        drift_slope=slope,
        drift_ratio=np.abs(slope) * n / (mean_qtot + 1.0),
        throughput=delivered.sum(axis=1) / n,
        jain=np.asarray([jain_index(row) for row in delivered]),
        utility=np.log1p(sums[5] / n).sum(axis=1),
        final=final)


# --------------------------------------------------------------------- #
# single-lane views (test cross-checks)
# --------------------------------------------------------------------- #
def soak_observations(lane: SoakLane, n_slots: int, *, seed: int = 0,
                      device="cuda") -> Observation:
    """The exact per-slot observation sequence one soak lane sees, as
    ``(n_slots, …)`` tensors for ``run_horizon`` (table channels only — a
    Gilbert–Elliott lane's rates depend on carried state)."""
    g = _stack_group([lane], "cpu")
    if g["kind"] != "table":
        raise ValueError("soak_observations supports table (static/trace) "
                         "channels only")
    M = lane.scenario.M
    x = torch.from_numpy(_chunk_inputs(
        g, slot_uniforms(seed, 0, n_slots, M), 0)[:, :, 0]).to(device)
    return Observation(
        D=x[0], r=x[2], E_H=x[1],
        L=torch.full((n_slots,), float(g["L"][0]), dtype=torch.float32,
                     device=device),
        new_cycles=torch.zeros((n_slots, M), dtype=torch.float32,
                               device=device))


def initial_state(lane: SoakLane, device="cuda") -> QueueState:
    """The (M,)-shaped initial :class:`QueueState` of one soak lane —
    zero queues, battery at the scenario's ``E0``."""
    return init_queues(lane.scenario.M, E0=_lane_physics(lane)["E0"],
                       device=device)


def lane_theta(lane: SoakLane, device="cuda") -> torch.Tensor:
    """The (M,) θ row of one lane (frac · E_cap), float32."""
    return torch.tensor(_lane_physics(lane)["theta"], dtype=torch.float32,
                        device=device)


def lane_capacity(lanes: Sequence[SoakLane]) -> np.ndarray:
    """(S,) hard uplink throughput envelope, bytes/slot: ``max r·T·L`` over
    every rate the channel can offer — no schedule beats it."""
    return np.asarray([_lane_physics(ln)["capacity"] for ln in lanes])
