"""Batched fleet engine for the co-simulator, in torch.

The torch port of ``repro.sim.batched``.  The communication phase of a
co-simulated epoch — per-slot P4–P7 scheduling with arrival-gated decode,
after a compute phase sampled on the host exactly as in the oracle — runs
for a whole fleet at once: all state (Q/H/E/R queues, pending payloads,
Gilbert–Elliott channel state) is carried as ``(S, M)`` tensors on the
fleet's device, and one *chunk runner* call advances every lane by a
chunk of slots.  The event-driven :class:`~repro_torch.sim.cluster.
EdgeCluster` is the oracle it is held against.

Where the reference ``vmap``s a ``lax.scan`` body, the port calls its
scheduler, which is generic over leading axes
(:func:`~repro_torch.core.lyapunov.scheduler.batched_schedule_slot`), on
``(S, M)`` tensors, one slot after the other: each slot is a short
sequence of torch operations that stay on the device, and the chunk's
outputs are written into one preallocated ``(chunk, outputs, S, M)``
buffer.  The chunk's inputs cross to the device in one copy (from pinned
memory on the card, so the host does not wait for it) and its outputs
come back in one copy, which the host stop tracker then consumes: the
host waits for the device once a chunk, never once a slot.

Lanes need only share *structure* — worker count ``M``, coding scheme and
channel model class — not physics: per-lane ``CommParams`` scalars,
``grad_bytes``, channel parameters of one class and ``SystemParams`` all
enter the chunk runner as stacked ``(S, …)`` rows
(:class:`_StackedPhysics`).  The per-lane ``max_slots`` cap and slot
length stay on the host in the stop tracker.  Every operation on the
device is elementwise or along one lane's worker axis, so a lane's results
never depend on which other lanes share the batch.

Exactness contract (held by ``tests/test_torch_fleet.py`` on every
registry scenario × scheme, and by ``chip_smoke.py`` on the card): on one
device the batched engine reproduces the oracle exactly — same decode
slot, arrival sets, byte ledgers and epoch results, at every legal chunk
size — because both engines

  * draw their randomness from the same per-seed block tapes
    (:class:`~repro_torch.sim.channel.CommTape`), leaving each seed's RNG
    stream at the same position for the next epoch;
  * share the pure per-slot physics (``schedule_slot``, whose reductions
    along the worker axis round the same for any shape, and the pure
    channel cores), with the Gilbert–Elliott flips resolved in float64 on
    the host;
  * apply the same stop rules in the same priority order per slot:
    decodable > provably-stuck > slot cap.

The chunk runs slots the oracle never executes (a stopped seed's lane
keeps computing until the chunk ends); the stop tracker ignores every
slot past a seed's stop slot, and a stopped seed's tape stops drawing
blocks, so its RNG stream stays aligned with the oracle's.
"""
from __future__ import annotations

import dataclasses
import time
from functools import lru_cache
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.lyapunov import (Observation, QueueState,
                                       batched_schedule_slot,
                                       stack_system_params)
from repro_torch.core.runtime import EpochResult
from repro_torch.sim.batched_compute import batched_comm_jobs
from repro_torch.sim.channel import TAPE_BLOCK, CommTape
from repro_torch.sim.cluster import (CommJob, CommStats, EdgeCluster,
                                     arrived_mask, stuck_tolerance)
from repro_torch.sim.scenarios import resolve_scenario
from repro_torch.sim.spec import build_cluster
from repro_torch.telemetry.compilation import note_compile
from repro_torch.telemetry.recorder import FleetRecorder, phase_span

__all__ = ["BatchedFleet", "run_fleet_batched", "MIN_CHUNK",
           "pick_chunk", "stack_fleet_physics", "scan_trace_count",
           "reset_scan_compile_cache"]

#: Smallest adaptive chunk.  Chunks are powers of two in
#: [MIN_CHUNK, TAPE_BLOCK], so every chunk divides the tape block and
#: chunk boundaries never straddle a randomness block (RNG draws are
#: identical for every legal chunk — the chunk-invariance contract).
MIN_CHUNK = 32

def pick_chunk(clusters: Sequence[EdgeCluster]) -> int:
    """Adaptive chunk length (slots per chunk runner call) for a fleet.

    Sized from the fleet's *expected* slots per epoch — per lane, that
    lane's compute-phase span plus a backlog-drain estimate bounded by
    both its link capacity and its sustainable energy-harvest rate — and
    the worst case over lanes, rounded up to the next power of two in
    ``[MIN_CHUNK, TAPE_BLOCK]``.  A lane whose channel cannot estimate a
    nominal rate forces the full-block chunk.  Purely a sizing heuristic
    (results are chunk-invariant by contract), deterministic in the
    fleet's physics, as the reference's.
    """
    rates = [c.channel.nominal_rates() for c in clusters]
    if any(r is None for r in rates):      # unknown physics: full block
        return TAPE_BLOCK
    est = 0.0
    for c, r in zip(clusters, rates):
        cp = c.comm
        rate = max(float(np.mean(r)), 1e-9)
        lanes = max(min(float(cp.n_subchannels), c.M), 1.0)
        # bytes/slot the uplink can move: link-capacity bound and the
        # energy-sustainable bound (harvest per slot buys 1/p transmit
        # time)
        cap_link = lanes * rate * cp.slot_T
        cap_energy = lanes * cp.harvest_mean * rate / max(cp.tx_power, 1e-9)
        cap = max(min(cap_link, cap_energy), 1e-9)
        drain_slots = float(np.sum(c.grad_bytes)) / cap
        # compute-phase span: the lane's slowest worker's per-partition
        # share, with slack for sampling noise, the deadline margin and a
        # stage-2 round
        comp_time = (c.K / max(c.M, 1)) / max(float(np.min(c.rates)), 1e-9)
        est = max(est, 4.0 * comp_time / cp.slot_T + 2.0 * drain_slots
                  + 8.0)
    chunk = MIN_CHUNK
    while chunk < min(est, TAPE_BLOCK):
        chunk *= 2
    return min(chunk, TAPE_BLOCK)


#: Chunk runners built (each a cache miss of :func:`_chunk_runner`) — the
#: port's counterpart of the reference's scan-trace count.
_runner_builds = 0


def scan_trace_count() -> int:
    """Monotone count of chunk-runner builds (the reference counts scan
    traces; the sweep's sharing contract is asserted against this)."""
    return _runner_builds


def reset_scan_compile_cache() -> None:
    """Drop the cached chunk runners (tests use this to count builds from
    a clean slate; the next fleet builds again)."""
    _chunk_runner.cache_clear()


# --------------------------------------------------------------------- #
# the chunk runner
# --------------------------------------------------------------------- #
#: Chunk outputs, in the order of the output buffer's second axis; ``H``
#: is added only when a recorder wants series.
_OUTS = ("d", "c", "Q", "E", "pend", "e_up", "e_com")


def _slot_step(state, pending, ch_state, xs, j, consts, channel_step,
               zeros):
    """Slot ``j`` of a chunk: the float32 physics both tails run, verbatim
    (``repro_torch.sim.device_epoch`` calls it too).  Returns the new
    queue state, pending payloads, channel state and the decisions."""
    sysp, gb, L, chp = consts
    # workers whose gradient became ready by this slot's tick join the
    # pending pool (ties ready == k*T resolved on the host)
    pending = pending + gb * xs["join"][j]
    if channel_step is not None:
        r, ch_state = channel_step(
            chp, ch_state, {k: v[j] for k, v in xs["ch"].items()},
            xs["k0"] + j)
    else:
        r = xs["r"][j]
    obs = Observation(D=pending, r=r, E_H=xs["h"][j], L=L, new_cycles=zeros)
    state, dec = batched_schedule_slot(state, sysp, obs)
    pending = pending - torch.minimum(pending, dec.d)
    return state, pending, ch_state, dec


@lru_cache(maxsize=64)
def _chunk_runner(channel_step, S: int, M: int, telemetry: bool = False,
                  device: str = "cuda"):
    """The function that advances an (S, M) fleet by one chunk of slots.

    ``channel_step`` is the channel class's pure ``step_batched`` for
    stateful channels, or ``None`` for stateless ones (their rate rows
    then arrive precomputed in ``xs["r"]``), so every static/trace fleet
    of one shape shares one runner.  ``telemetry`` adds the virtual
    admission queue ``H`` to the outputs; it is part of the cache key, so
    the off path runs exactly the telemetry-free computation.

    ``run(carry, xs, consts)`` returns the carry after the chunk and the
    ``(chunk, outputs, S, M)`` float32 output buffer, on the device.  The
    loop launches work on the device and never waits for it.
    """
    global _runner_builds
    _runner_builds += 1
    note_compile("comm_scan")
    names = _OUTS + (("H",) if telemetry else ())
    dev = torch.device(device)
    zeros = torch.zeros((S, M), dtype=torch.float32, device=dev)

    def run(carry, xs, consts):
        state, pending, ch_state = carry
        n = xs["h"].shape[0]
        out = torch.empty((n, len(names), S, M), dtype=torch.float32,
                          device=dev)
        for j in range(n):
            state, pending, ch_state, dec = _slot_step(
                state, pending, ch_state, xs, j, consts, channel_step, zeros)
            row = [dec.d, dec.c, state.Q, state.E, pending, dec.e_up,
                   dec.e_com]
            if telemetry:
                row.append(state.H)
            torch.stack(row, out=out[j])
        return (state, pending, ch_state), out

    return run


# --------------------------------------------------------------------- #
# stacked per-lane physics (built once per fleet, reused every epoch)
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class _StackedPhysics:
    """The fleet's comm physics stacked along the lane axis.

    Device members feed the chunk runner; the host rows (``slot_T``,
    ``cap``) drive the per-lane stop tracking.
    """
    device: torch.device
    sysp: object            # SystemParams, fields stacked (S, …)
    gb: torch.Tensor        # (S, M) f32 per-lane payload bytes
    L: torch.Tensor         # (S,)   f32 per-lane sub-channel budget
    chp: dict               # channel params, fields stacked (S, …)
    E_init: torch.Tensor    # (S, M) f32 per-lane initial battery
    slot_T: np.ndarray      # (S,)   f64 per-lane slot length
    cap: np.ndarray         # (S,)   int per-lane max_slots
    grid_len: int           # max over lanes of the slot cap


def stack_fleet_physics(clusters: Sequence[EdgeCluster],
                        device=None) -> _StackedPhysics:
    """Stack per-lane comm physics into the chunk runner's constants, on
    ``device`` (default: the first cluster's)."""
    dev = torch.device(device if device is not None
                       else clusters[0].device)
    per_chp = [c.channel.batched_params() for c in clusters]
    chp = ({key: torch.from_numpy(np.stack(
        [np.asarray(d[key]) for d in per_chp])).to(dev)
        for key in per_chp[0]} if per_chp[0] else {})
    cap = np.array([max(c.comm.max_slots, 1) for c in clusters])
    M = clusters[0].M

    def f32(rows):
        return torch.from_numpy(np.asarray(rows, np.float32)).to(dev)

    sysp = stack_system_params([c.sys_params for c in clusters],
                               device=dev)
    return _StackedPhysics(
        device=dev, sysp=sysp,
        gb=f32(np.stack([c.grad_bytes for c in clusters])),
        L=f32([float(c.comm.n_subchannels) for c in clusters]),
        chp=chp,
        E_init=f32(np.stack([np.full(M, c.comm.E0) for c in clusters])),
        slot_T=np.array([c.comm.slot_T for c in clusters]),
        cap=cap,
        grid_len=int(cap.max()))


# --------------------------------------------------------------------- #
# host-side stop tracking (mirrors the oracle's per-slot checks)
# --------------------------------------------------------------------- #
class _StopTracker:
    """Replays the oracle's per-slot bookkeeping over chunk outputs.

    Byte ledgers accumulate in float64 exactly as the oracle does; decode
    gates are evaluated on the host on arrival-mask changes only (the gate
    is a pure function of the mask, so skipping unchanged slots is
    lossless).  Slot length, slot cap, battery level and payload tolerance
    are per-lane rows, so heterogeneous lanes stop on their own clocks.
    """

    def __init__(self, jobs: Sequence[CommJob],
                 clusters: Sequence[EdgeCluster],
                 visible: np.ndarray, grid_len: int):
        S, M = visible.shape
        self.jobs = jobs
        self.T = np.array([c.comm.slot_T for c in clusters])       # (S,)
        self.cap = np.array([max(c.comm.max_slots, 1)
                             for c in clusters])                   # (S,)
        self.grid_len = grid_len
        self.gb = np.stack([c.grad_bytes for c in clusters])       # (S, M)
        self.visible = visible
        ready = np.stack([j.ready_time for j in jobs])
        fin = np.isfinite(ready)
        # the oracle's ``outstanding == 0``: every scheduled COMPUTE_DONE
        # has fired ⟺ slot k has reached the last finite ready time
        self.last_visible = np.where(
            fin.any(1), np.max(np.where(fin, visible, -1), axis=1), -1)
        self.tiny = np.array([stuck_tolerance(c.grad_bytes)
                              for c in clusters])                  # (S,)
        E0 = np.array([float(c.comm.E0) for c in clusters])        # (S,)
        # energy at each slot's start, for the oracle's float64 overdraft
        self._E_prev = np.broadcast_to(E0[:, None], (S, M)).copy()
        self.stopped = np.zeros(S, bool)
        self.ok = np.zeros(S, bool)
        self.n_slots = np.zeros(S, np.int64)
        self.decode_time = np.zeros(S)
        self.admitted = np.zeros((S, M))
        self.delivered = np.zeros((S, M))
        self.idle = np.zeros(S, np.int64)
        self.min_E = E0.copy()
        self.max_od = np.zeros(S)
        self.arrived = np.zeros((S, M), bool)
        self.snap_Q = np.zeros((S, M))
        self.snap_E = np.zeros((S, M))
        self.snap_pend = np.zeros((S, M))
        self.snap_owed = np.zeros((S, M))
        # memoized decode-gate value per seed; the all-False mask every
        # seed starts from always gates False (nothing arrived yet)
        self._memo_val = [False] * S

    @property
    def done(self) -> bool:
        return bool(self.stopped.all())

    def consume(self, k0: int, outs: dict) -> None:
        d_t = np.asarray(outs["d"], np.float64)
        c_t = np.asarray(outs["c"], np.float64)
        E_t = np.asarray(outs["E"], np.float64)
        eup_t = np.asarray(outs["e_up"], np.float64)
        ecom_t = np.asarray(outs["e_com"], np.float64)
        Q_t = np.ascontiguousarray(outs["Q"])             # float32
        p_t = np.ascontiguousarray(outs["pend"])
        S = self.stopped.shape[0]
        decod = np.fromiter(self._memo_val, bool, S)
        for j in range(d_t.shape[0]):
            k = k0 + j
            if self.done or k >= self.grid_len:
                break
            act = ~self.stopped
            d, c = d_t[j], c_t[j]
            self.admitted[act] += d[act]
            self.delivered[act] += c[act]
            idle_now = (d.sum(1) <= 0) & (c.sum(1) <= 0)
            self.idle[act] += idle_now[act]
            self.min_E[act] = np.minimum(self.min_E[act], E_t[j][act].min(1))
            # float64 spend vs slot-start energy, as the oracle computes it
            od = (eup_t[j] + ecom_t[j] - self._E_prev).max(axis=1)
            self.max_od[act] = np.maximum(self.max_od[act], od[act])
            self._E_prev = E_t[j]
            owed = self.gb * (self.visible <= k)
            arrived = arrived_mask(owed, self.delivered)
            # the decode gate is a pure function of the arrival mask —
            # re-evaluate only where the mask changed (vs the memoized one)
            changed = act & (arrived != self.arrived).any(axis=1)
            self.arrived[act] = arrived[act]
            for i in np.flatnonzero(changed):
                self._memo_val[i] = bool(self.jobs[i].is_decodable(
                    arrived[i]))
                decod[i] = self._memo_val[i]
            # oracle order per slot: decodable, then provably-stuck, then
            # the slot cap (the latter two never set decode_ok)
            p_left = p_t[j].astype(np.float64).sum(axis=1)
            q_left = Q_t[j].sum(axis=1)
            stuck = ((k >= self.last_visible) & (p_left <= self.tiny)
                     & (q_left <= self.tiny))
            stop = act & (decod | stuck | (k + 1 >= self.cap))
            if stop.any():
                self.stopped |= stop
                self.ok[stop] = decod[stop]
                self.n_slots[stop] = k + 1
                self.decode_time[stop] = (k + 1) * self.T[stop]
                self.snap_Q[stop] = Q_t[j][stop].astype(np.float64)
                self.snap_E[stop] = E_t[j][stop]
                self.snap_pend[stop] = p_t[j][stop].astype(np.float64)
                self.snap_owed[stop] = owed[stop]

    def finalize(self) -> List[CommStats]:
        assert self.done, "comm loop ended with unstopped seeds"
        return [CommStats(
            n_slots=int(self.n_slots[i]),
            decode_time=float(self.decode_time[i]),
            decode_ok=bool(self.ok[i]),
            arrived=self.arrived[i].copy(),
            bytes_offered=self.snap_owed[i].copy(),
            bytes_admitted=self.admitted[i].copy(),
            bytes_transmitted=self.delivered[i].copy(),
            queue_residual=self.snap_Q[i].copy(),
            pending_residual=self.snap_pend[i].copy(),
            min_energy=float(self.min_E[i]),
            max_overdraft=float(self.max_od[i]),
            final_energy=self.snap_E[i].copy(),
            idle_slots=int(self.idle[i]),
        ) for i in range(len(self.jobs))]


# --------------------------------------------------------------------- #
# batched comm phase
# --------------------------------------------------------------------- #
#: chunk output name per telemetry series field (``H`` only exists in
#: telemetry runners; the rest double as stop-tracker inputs)
_SERIES_OUT = {"Q": "Q", "H": "H", "E": "E", "admitted": "d",
               "transmitted": "c", "pending": "pend"}


def _visible_slots(jobs: Sequence[CommJob],
                   physics: _StackedPhysics) -> np.ndarray:
    """Slot at which each worker's payload becomes visible to the
    scheduler: first ``k`` on that lane's clock with ``k*T >= ready``
    (ties fire before the tick, matching the oracle's heap ordering);
    ``>=`` the lane's slot cap ⟹ never within this epoch.  Each lane
    searches its own slot grid — lanes may tick at different ``slot_T``.
    """
    ready = np.stack([j.ready_time for j in jobs])             # (S, M) f64
    grid_len = physics.grid_len
    grids = {}                               # slot grid per distinct slot_T
    visible = np.empty(ready.shape, np.int64)
    for i, T_i in enumerate(physics.slot_T):
        grid = grids.get(T_i)
        if grid is None:
            grid = grids[T_i] = np.arange(grid_len, dtype=np.float64) * T_i
        visible[i] = np.searchsorted(grid, ready[i], side="left")
    return visible


def _draw_chunk_tapes(tapes, stopped: np.ndarray, k0: int,
                      chunk: int) -> None:
    """Advance each *still-running* seed's tape to cover this chunk — a
    stopped seed's oracle run never drew it either, keeping the streams
    aligned (chunks divide the tape block, so a chunk never forces a
    block the oracle wouldn't have reached)."""
    for i, t in enumerate(tapes):
        if not stopped[i]:
            t.ensure(k0 + chunk - 1)


def _chunk_xs(clusters, tapes, visible: np.ndarray, k0: int, chunk: int,
              stateful: bool, zero_rows: np.ndarray,
              device: torch.device) -> dict:
    """Per-slot inputs for one chunk, ``(chunk, S, M)`` each: harvest rows,
    the join mask (``visible == k``), and the channel's rate rows or
    boolean flip rows.  They are packed into one float32 host array and
    cross to the device in one copy (pinned and asynchronous on the
    card)."""
    def rows_or_zero(t, kind):
        if t.n_drawn <= k0:
            return zero_rows               # stopped before this block
        rows = (t.harvest_rows(k0, chunk) if kind == "h"
                else t.channel_rows(k0, chunk))
        return rows if rows is not None else zero_rows

    S, M = visible.shape
    if stateful:
        per_seed = [c.channel.tape_arrays(rows_or_zero(t, "ch"))
                    for c, t in zip(clusters, tapes)]
        ch_keys = list(per_seed[0])
    else:
        ch_keys = []
    n_fields = 2 + (len(ch_keys) if stateful else 1)
    host = np.empty((n_fields, chunk, S, M), np.float32)
    host[0] = np.stack([rows_or_zero(t, "h") for t in tapes], axis=1)
    host[1] = visible[None] == np.arange(k0, k0 + chunk)[:, None, None]
    if stateful:
        for i, key in enumerate(ch_keys):
            host[2 + i] = np.stack([d[key] for d in per_seed], axis=1)
    else:
        # per-lane rate rows: stateless channels of one class but
        # different parameters stack freely
        slots = np.arange(k0, k0 + chunk)
        host[2] = np.stack([c.channel.rates_for_slots(slots)
                            for c in clusters], axis=1)
    x = _to_device(host, device)
    xs = {"h": x[0], "join": x[1], "k0": k0}
    if stateful:
        flips = x[2:] != 0
        xs["ch"] = {key: flips[i] for i, key in enumerate(ch_keys)}
    else:
        xs["r"] = x[2]
    return xs


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: from pinned memory and asynchronous on
    the card, so the host never waits for the copy."""
    x = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        x = x.pin_memory().to(device, non_blocking=True)
    return x


def _initial_carry(clusters, tapes, physics: _StackedPhysics) -> tuple:
    """The chunk loop's first carry: empty queues at each lane's battery
    level, nothing pending, and each lane's channel state drawn from its
    tape (stateful channels only)."""
    S, M = physics.gb.shape
    z = torch.zeros((S, M), dtype=torch.float32, device=physics.device)
    state = QueueState(Q=z, H=z, E=physics.E_init, R=z,
                       R_server=torch.zeros((S,), dtype=torch.float32,
                                            device=physics.device))
    if clusters[0].channel.stateful:
        ch_state = _to_device(np.stack(
            [c.channel.init_state_np(t.u_init)
             for c, t in zip(clusters, tapes)]), physics.device)
    else:
        ch_state = ()
    return state, z, ch_state


def _batched_comm(clusters: Sequence[EdgeCluster],
                  jobs: Sequence[CommJob],
                  chunk: Optional[int] = None, *,
                  physics: Optional[_StackedPhysics] = None,
                  telemetry: Optional[FleetRecorder] = None,
                  epoch: int = 0,
                  counters: Optional[Dict[str, float]] = None
                  ) -> List[CommStats]:
    c0 = clusters[0]
    series = telemetry is not None and telemetry.wants_series
    chunk = int(chunk or TAPE_BLOCK)
    S, M = len(clusters), c0.M
    if physics is None:
        physics = stack_fleet_physics(clusters)
    dev = physics.device
    grid_len = physics.grid_len              # the oracle always runs slot 0
    stateful = c0.channel.stateful

    visible = _visible_slots(jobs, physics)
    tapes = [CommTape(c.channel, c.engine.rng, c.comm.harvest_mean,
                      c.comm.harvest_jitter) for c in clusters]

    runner = _chunk_runner(
        type(c0.channel).step_batched if stateful else None, S, M, series,
        str(dev))
    consts = (physics.sysp, physics.gb, physics.L, physics.chp)

    carry = _initial_carry(clusters, tapes, physics)

    tracker = _StopTracker(jobs, clusters, visible, grid_len)
    names = _OUTS + (("H",) if series else ())
    blocks: List[dict] = []        # chunk outputs for series slicing
    zero_rows = np.zeros((chunk, M))
    n_chunks = -(-grid_len // chunk)
    for b in range(n_chunks):
        if tracker.done:
            break
        t0 = time.perf_counter()
        k0 = b * chunk
        _draw_chunk_tapes(tapes, tracker.stopped, k0, chunk)
        xs = _chunk_xs(clusters, tapes, visible, k0, chunk, stateful,
                       zero_rows, dev)
        carry, out = runner(carry, xs, consts)
        host = out.cpu().numpy()        # the host waits here, once a chunk
        outs = {name: host[:, i] for i, name in enumerate(names)}
        tracker.consume(k0, outs)
        if series:
            blocks.append(outs)
        if counters is not None:
            counters["chunks"] += 1
            counters["slots"] += chunk
            counters["host_waits"] += 1
            counters["seconds"] += time.perf_counter() - t0
    stats = tracker.finalize()
    if series:
        # one vectorized slice per lane: concatenate the chunk blocks
        # along the slot axis, then trim each lane to its own stop slot
        stacked = {f: np.concatenate([b[out] for b in blocks])
                   for f, out in _SERIES_OUT.items()}
        for lane, st in enumerate(stats):
            telemetry.record_comm_series(
                lane, epoch, n_slots=st.n_slots,
                **{f: arr[:st.n_slots, lane] for f, arr in stacked.items()})
    return stats


# --------------------------------------------------------------------- #
# the fleet
# --------------------------------------------------------------------- #
class BatchedFleet:
    """A fleet of same-structure clusters advanced one batched epoch at a
    time: the compute phases on the host (vectorized over the fleet, or
    per seed), then one chunk loop for the whole fleet's communication
    phase on the fleet's device, then per-seed decode + assembly.

    Lanes must share only the fleet's *structure* — worker count ``M``,
    coding scheme, and channel model class; everything else may vary per
    lane and enters the chunk runner as stacked ``(S, …)`` rows
    (:class:`_StackedPhysics`).

    ``scenario`` is a :class:`~repro_torch.sim.spec.ScenarioSpec`.
    ``compute`` selects the compute-phase engine: ``"batched"`` (default)
    vectorizes the two-stage planner/predictor/sampling across the fleet
    (``repro_torch.sim.batched_compute``); ``"host"`` keeps the per-seed
    host loop.  ``chunk`` pins the chunk length; it must divide
    :data:`~repro_torch.sim.channel.TAPE_BLOCK`, and by default it is
    picked from the physics (:func:`pick_chunk`).  Results are identical
    for every legal chunk.

    ``tail`` selects where the per-slot stop tracking runs: ``"host"``
    (default) replays each chunk's outputs through the numpy
    :class:`_StopTracker`; ``"device"`` keeps the whole stop state
    machine in the chunk loop's carry on the fleet's device
    (``repro_torch.sim.device_epoch``), bit-identical by contract.  A
    recorder that wants per-slot series runs the host tail.  ``mesh=``
    (device tail only) raises ``NotImplementedError``: one card batches
    every lane.

    ``device`` is where the chunk loop runs: by default the card, or,
    with explicit ``clusters=``, the clusters' device (which must be one).
    Nothing falls back to the CPU.  ``chunk_counters`` accumulates, over the
    fleet's life, chunks run, slots run, host waits for the device and
    seconds spent in chunk loops.

    Most callers go through :class:`~repro_torch.sim.fleet.Fleet`.
    """

    def __init__(self, scenario=None,
                 scheme: str = "two-stage", seeds: Sequence[int] = (0,),
                 *, clusters: Optional[Sequence[EdgeCluster]] = None,
                 compute: str = "batched", chunk: Optional[int] = None,
                 tail: str = "host", mesh=None,
                 telemetry: Optional[FleetRecorder] = None,
                 device=None, **overrides):
        if compute not in ("batched", "host"):
            raise ValueError(f"compute must be 'batched' or 'host', "
                             f"got {compute!r}")
        if tail not in ("host", "device"):
            raise ValueError(f"tail must be 'host' or 'device', "
                             f"got {tail!r}")
        if mesh is not None and tail != "device":
            raise ValueError("mesh= requires tail='device' (the host tail "
                             "never shards the seed axis)")
        if mesh is not None:
            raise NotImplementedError(
                "mesh=: one card batches every lane of the device tail, so "
                "the port does not shard the seed axis; sharding over "
                "several cards waits for the port of launch/mesh "
                "(ROADMAP.md, queue 1, item 5)")
        if clusters is None:
            if scenario is None:
                raise ValueError("need a scenario spec or explicit clusters")
            spec = resolve_scenario(scenario, overrides)
            dev = torch.device("cuda" if device is None else device)
            clusters = [build_cluster(spec, scheme, int(s), device=dev)
                        for s in seeds]
        elif overrides:
            raise ValueError(
                f"overrides {sorted(overrides)} have no effect with "
                f"explicit clusters=; apply them to the spec instead")
        clusters = list(clusters)
        if not clusters:
            raise ValueError("need at least one cluster")
        c0 = clusters[0]
        for c in clusters[1:]:
            if (c.M != c0.M or c.scheme != c0.scheme
                    or type(c.channel) is not type(c0.channel)):
                raise ValueError(
                    "BatchedFleet lanes must share structure: same worker "
                    "count M, coding scheme and channel model class "
                    f"(got M={c.M}/{c0.M}, scheme={c.scheme!r}/"
                    f"{c0.scheme!r}, channel={type(c.channel).__name__}/"
                    f"{type(c0.channel).__name__}); per-lane physics "
                    "within one structure stack freely")
        devices = {c.device for c in clusters}
        if len(devices) != 1 or (device is not None
                                 and torch.device(device) not in devices):
            raise ValueError(f"the fleet's clusters run on "
                             f"{sorted(map(str, devices))}; a fleet runs "
                             f"on one device (device={device!r})")
        self.device = c0.device
        self.compute = compute
        self.tail = tail
        self.clusters = clusters
        # stacked per-lane physics, built once and reused every epoch
        self._physics = stack_fleet_physics(clusters, self.device)
        self.telemetry = telemetry
        if telemetry:
            # host-path compute phases (compute="host") emit per-lane
            # stage-1/stage-2 spans through the runtime's own hook
            for lane, c in enumerate(clusters):
                c.telemetry_lane = lane
                c.telemetry = telemetry
        if chunk is None:
            chunk = pick_chunk(clusters)
        else:
            chunk = int(chunk)
            if chunk < 1 or TAPE_BLOCK % chunk != 0:
                raise ValueError(
                    f"chunk must be a positive divisor of TAPE_BLOCK="
                    f"{TAPE_BLOCK} so chunks stay aligned with the "
                    f"randomness tape blocks, got {chunk}")
        self.chunk = chunk
        self.chunk_counters = {"chunks": 0, "slots": 0, "host_waits": 0,
                               "seconds": 0.0}

    @property
    def n_seeds(self) -> int:
        return len(self.clusters)

    def run_epoch(self, epoch: int) -> List[EpochResult]:
        """One batched epoch → per-seed :class:`EpochResult` list."""
        rec = self.telemetry
        with phase_span(rec, "compute_phase", epoch=epoch):
            if self.compute == "batched":
                jobs = batched_comm_jobs(self.clusters, epoch)
            else:
                jobs = [c.comm_job(epoch) for c in self.clusters]
        with phase_span(rec, "comm", epoch=epoch):
            # per-slot series telemetry needs the chunk outputs the device
            # tail never copies to the host — that one observability mode
            # falls back to the (bit-identical) host tail
            series = rec is not None and rec.wants_series
            if self.tail == "device" and not series:
                from repro_torch.sim.device_epoch import device_comm
                stats = device_comm(self.clusters, jobs, self.chunk,
                                    physics=self._physics,
                                    counters=self.chunk_counters)
            else:
                stats = _batched_comm(self.clusters, jobs, self.chunk,
                                      physics=self._physics, telemetry=rec,
                                      epoch=epoch,
                                      counters=self.chunk_counters)
        with phase_span(rec, "decode", epoch=epoch):
            results = [job.assemble(st) for job, st in zip(jobs, stats)]
        if rec:
            for lane, res in enumerate(results):
                rec.record_epoch(lane, epoch, res)
        return results

    def run(self, n_epochs: int) -> List[List[EpochResult]]:
        """``n_epochs`` batched epochs → results indexed [epoch][seed]."""
        return [self.run_epoch(e) for e in range(n_epochs)]


def run_fleet_batched(scenario, scheme: str = "two-stage", *,
                      seeds: Sequence[int] = (0,), n_epochs: int = 3,
                      compute: str = "batched",
                      chunk: Optional[int] = None, device="cuda",
                      **overrides) -> List[List[EpochResult]]:
    """Convenience wrapper: build a fleet on ``device`` and run it,
    [epoch][seed].  ``scenario`` is a ScenarioSpec."""
    return BatchedFleet(scenario, scheme, seeds, compute=compute,
                        chunk=chunk, device=device, **overrides).run(n_epochs)
