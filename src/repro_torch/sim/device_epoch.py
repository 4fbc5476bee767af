"""Device-resident epoch tail: the stop state machine in the chunk carry.

The torch port of ``repro.sim.device_epoch``.  The host-tail engine
(``repro_torch.sim.batched``) copies every chunk's ``(chunk, outputs, S,
M)`` block to the host and replays it through the numpy
:class:`~repro_torch.sim.batched._StopTracker`.  This module keeps that
whole state machine — float64 byte ledgers, arrival masks, decode gates
(:class:`~repro_torch.sim.cluster.GateSpec` stacked per lane), the
provably-stuck rule, per-lane slot caps, energy extrema and stop-slot
snapshots — in the carry of the chunk loop, on the fleet's device, so the
host reads one ``(S,)`` stop mask a chunk and one packed result an epoch.

Bit-identity contract (``tests/test_torch_device_epoch.py``): the carry
update mirrors ``_StopTracker.consume`` operation for operation —

  * ledgers and energy extrema accumulate in float64 in the same per-slot
    order (the card has float64 units; the float32 slot physics is the
    host tail's own, :func:`~repro_torch.sim.batched._slot_step`);
  * the sums behind the idle and stuck predicates replicate numpy's
    pairwise summation bitwise (:func:`_pairwise_last`), including the
    tracker's float32 fold over ``Q``;
  * decode gates are evaluated every slot from the stacked predicates —
    equal to the tracker's memoized exact gate because the gate is a pure
    function of the (monotone per lane) arrival mask, and re-checked on
    the host against the exact gate after the loop;
  * the stop priority is the oracle's: decodable > provably-stuck > slot
    cap, latched per lane with its snapshots.

Every operation in the loop is elementwise or along one lane's worker
axis, each a separate torch call (so no two roundings fuse), and nothing
in a slot waits for the card.  What stays on the host, by design: the
per-epoch float64 control plane (planning, predictor, decode weights) and
the randomness tapes — a stopped seed stops drawing tape blocks, which is
why the loop reads the stop mask once a chunk.

The reference can also ``shard_map`` the seed axis over a device mesh.
One card batches every lane, so the port has no mesh here
(``BatchedFleet(mesh=...)`` raises).
"""
from __future__ import annotations

import dataclasses
import time
from functools import lru_cache
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.sim.batched import (_chunk_xs, _draw_chunk_tapes,
                                     _initial_carry, _slot_step,
                                     _StackedPhysics, _to_device,
                                     _visible_slots, stack_fleet_physics)
from repro_torch.sim.channel import TAPE_BLOCK, CommTape
from repro_torch.sim.cluster import (ARRIVAL_ATOL, ARRIVAL_RTOL, CommJob,
                                     CommStats, EdgeCluster, stuck_tolerance)
from repro_torch.telemetry.compilation import note_compile

__all__ = ["device_comm"]


# --------------------------------------------------------------------- #
# numpy-bitwise pairwise summation
# --------------------------------------------------------------------- #
def _pairwise_last(x):
    """Sum over the last axis replicating numpy's pairwise algorithm
    bitwise (same dtype, same association order): a sequential fold under
    8 elements, eight accumulators up to 128, recursive halving (the cut
    rounded down to a multiple of 8) above.  Works on torch tensors and
    numpy arrays alike."""
    n = x.shape[-1]
    if n == 0:
        return x.sum(-1)
    if n < 8:
        acc = x[..., 0]
        for i in range(1, n):
            acc = acc + x[..., i]
        return acc
    if n <= 128:
        r = [x[..., i] for i in range(8)]
        i = 8
        while i + 8 <= n:
            for j in range(8):
                r[j] = r[j] + x[..., i + j]
            i += 8
        acc = (((r[0] + r[1]) + (r[2] + r[3]))
               + ((r[4] + r[5]) + (r[6] + r[7])))
        while i < n:
            acc = acc + x[..., i]
            i += 1
        return acc
    n2 = (n // 2) // 8 * 8
    return _pairwise_last(x[..., :n2]) + _pairwise_last(x[..., n2:])


# --------------------------------------------------------------------- #
# stacked decode gates
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class _StackedGates:
    """Per-lane :class:`~repro_torch.sim.cluster.GateSpec` predicates
    stacked into mask/count arrays the loop evaluates each slot:

        decodable ⟺ has_work ∧ (arrived ∨ ¬must).all()
                             ∧ count(arrived ∧ cnt) ≥ need
                             ∧ every valid FRS group has an arrival
    """
    must: np.ndarray        # (S, M) bool — workers that must all arrive
    cnt: np.ndarray         # (S, M) bool — workers the count applies to
    need: np.ndarray        # (S,)  int64 — arrivals needed among ``cnt``
    has_work: np.ndarray    # (S,)  bool
    member: np.ndarray      # (S, G, M) bool — FRS group membership
    gvalid: np.ndarray      # (S, G) bool — padded groups gate nothing


def _stack_gates(jobs: Sequence[CommJob], M: int) -> _StackedGates:
    gates = [j.gate for j in jobs]
    missing = [i for i, g in enumerate(gates) if g is None]
    if missing:
        raise ValueError(
            f"device tail needs CommJob.gate on every lane; lanes "
            f"{missing} have none (legacy job construction?)")
    S = len(gates)
    G = max((int(g.groups.max()) + 1 for g in gates
             if g.groups is not None), default=0)
    must = np.zeros((S, M), bool)
    cnt = np.zeros((S, M), bool)
    need = np.zeros(S, np.int64)
    has_work = np.zeros(S, bool)
    member = np.zeros((S, G, M), bool)
    gvalid = np.zeros((S, G), bool)
    for i, g in enumerate(gates):
        must[i, np.asarray(g.must, int)] = True
        cnt[i, np.asarray(g.count_over, int)] = True
        need[i] = g.need
        has_work[i] = g.has_work
        if G and g.groups is not None:
            member[i, np.asarray(g.groups, int), np.arange(M)] = True
            gvalid[i] = member[i].any(-1)
    return _StackedGates(must, cnt, need, has_work, member, gvalid)


def _gate(gates: dict, arrived: torch.Tensor) -> torch.Tensor:
    """(S,) decodable under the stacked gates, for an (S, M) arrival
    mask."""
    count = (arrived & gates["cnt"]).sum(-1)
    ok = (gates["has_work"] & (arrived | ~gates["must"]).all(-1)
          & (count >= gates["need"]))
    if gates["member"].shape[1]:
        grp = (gates["member"] & arrived[:, None, :]).any(-1)
        ok = ok & (grp | ~gates["gvalid"]).all(-1)
    return ok


# --------------------------------------------------------------------- #
# the chunk loop with the stop state machine in its carry
# --------------------------------------------------------------------- #
#: The float64 (S, M) members of the tail carry, in the order of the
#: packed result the host reads once an epoch.
_TAIL_ROWS = ("admitted", "delivered", "E_prev", "snap_Q", "snap_E",
              "snap_pend", "snap_owed")
#: Its (S,) members (booleans and counts are exact in float64).
_TAIL_LANES = ("stopped", "ok", "n_slots", "idle", "min_E", "max_od")


@lru_cache(maxsize=64)
def _tail_runner(channel_step, S: int, M: int, device: str = "cuda"):
    """The function that advances an (S, M) fleet by one chunk of slots,
    carrying the full stop state machine.  Cached on the same structural
    signature as the host tail's runner."""
    note_compile("device_comm_scan")
    zeros = torch.zeros((S, M), dtype=torch.float32,
                        device=torch.device(device))

    def run(carry, xs, consts, tc):
        state, pending, ch_state, t = carry
        n = xs["h"].shape[0]
        for j in range(n):
            k = xs["k0"] + j
            # ---- float32 slot physics, the host tail's own ----
            state, pending, ch_state, dec = _slot_step(
                state, pending, ch_state, xs, j, consts, channel_step, zeros)
            # ---- float64 stop state machine (= _StopTracker.consume) ----
            act = ~t["stopped"]
            actc = act[:, None]
            d64 = dec.d.double()
            c64 = dec.c.double()
            E64 = state.E.double()
            admitted = torch.where(actc, t["admitted"] + d64, t["admitted"])
            delivered = torch.where(actc, t["delivered"] + c64,
                                    t["delivered"])
            idle_now = (_pairwise_last(d64) <= 0) & (_pairwise_last(c64) <= 0)
            idle = t["idle"] + (act & idle_now)
            min_E = torch.where(act, torch.minimum(t["min_E"],
                                                   E64.amin(-1)), t["min_E"])
            # float64 spend against slot-start energy, as the oracle's
            od = (dec.e_up.double() + dec.e_com.double()
                  - t["E_prev"]).amax(-1)
            max_od = torch.where(act, torch.maximum(t["max_od"], od),
                                 t["max_od"])
            owed = tc["gb64"] * (tc["visible"] <= k)
            arr_now = (owed > 0) & (delivered >= owed - ARRIVAL_RTOL * owed
                                    - ARRIVAL_ATOL)
            arrived = torch.where(actc, arr_now, t["arrived"])
            decod = _gate(tc, arrived)
            # the tracker's dtype split: pending folds in float64, Q in
            # float32 (both then compare against the float64 tolerance)
            p_left = _pairwise_last(pending.double())
            q_left = _pairwise_last(state.Q)
            stuck = ((k >= tc["last_visible"]) & (p_left <= tc["tiny"])
                     & (q_left <= tc["tiny"]))
            # oracle order per slot: decodable, then provably-stuck, then
            # the slot cap (the latter two never set decode_ok)
            stop = act & (decod | stuck | (k + 1 >= tc["cap"]))
            stopc = stop[:, None]
            t = {
                "stopped": t["stopped"] | stop,
                "ok": torch.where(stop, decod, t["ok"]),
                "n_slots": torch.where(stop, k + 1, t["n_slots"]),
                "admitted": admitted, "delivered": delivered,
                "idle": idle, "min_E": min_E, "max_od": max_od,
                "E_prev": E64, "arrived": arrived,
                "snap_Q": torch.where(stopc, state.Q.double(), t["snap_Q"]),
                "snap_E": torch.where(stopc, E64, t["snap_E"]),
                "snap_pend": torch.where(stopc, pending.double(),
                                         t["snap_pend"]),
                "snap_owed": torch.where(stopc, owed, t["snap_owed"]),
            }
        return state, pending, ch_state, t

    return run


def _initial_tail(S: int, M: int, E0: np.ndarray,
                  dev: torch.device) -> dict:
    def zeros(*shape, dtype=torch.float64):
        return torch.zeros(shape, dtype=dtype, device=dev)

    E0 = _to_device(E0.astype(np.float64), dev)
    return {"stopped": zeros(S, dtype=torch.bool),
            "ok": zeros(S, dtype=torch.bool),
            "n_slots": zeros(S, dtype=torch.int64),
            "admitted": zeros(S, M), "delivered": zeros(S, M),
            "idle": zeros(S, dtype=torch.int64),
            "min_E": E0.clone(), "max_od": zeros(S),
            "E_prev": E0[:, None].expand(S, M).clone(),
            "arrived": zeros(S, M, dtype=torch.bool),
            "snap_Q": zeros(S, M), "snap_E": zeros(S, M),
            "snap_pend": zeros(S, M), "snap_owed": zeros(S, M)}


def device_comm(clusters: Sequence[EdgeCluster],
                jobs: Sequence[CommJob],
                chunk: Optional[int] = None, *,
                physics: Optional[_StackedPhysics] = None,
                counters: Optional[Dict[str, float]] = None
                ) -> List[CommStats]:
    """Run one epoch's comm phase with the stop tracker in the carry.

    Drop-in replacement for ``repro_torch.sim.batched._batched_comm``
    (minus per-slot telemetry series, which need the chunk outputs this
    path never copies to the host).  ``counters`` accumulates chunks,
    slots, host waits and chunk-loop seconds, as the host tail's do.
    """
    c0 = clusters[0]
    chunk = int(chunk or TAPE_BLOCK)
    S, M = len(clusters), c0.M
    if physics is None:
        physics = stack_fleet_physics(clusters)
    dev = physics.device
    stateful = c0.channel.stateful

    visible = _visible_slots(jobs, physics)
    tapes = [CommTape(c.channel, c.engine.rng, c.comm.harvest_mean,
                      c.comm.harvest_jitter) for c in clusters]
    gates = _stack_gates(jobs, M)
    runner = _tail_runner(
        type(c0.channel).step_batched if stateful else None, S, M, str(dev))
    consts = (physics.sysp, physics.gb, physics.L, physics.chp)

    # the host rows the stop rules need, exactly as _StopTracker builds
    # them: last COMPUTE_DONE slot, per-lane stuck tolerance, payloads
    ready = np.stack([j.ready_time for j in jobs])
    fin = np.isfinite(ready)
    last_visible = np.where(
        fin.any(1), np.max(np.where(fin, visible, -1), axis=1), -1)
    host = {"gb64": np.stack([c.grad_bytes for c in clusters]),
            "visible": visible, "last_visible": last_visible,
            "tiny": np.array([stuck_tolerance(c.grad_bytes)
                              for c in clusters]),
            "cap": physics.cap.astype(np.int64),
            "must": gates.must, "cnt": gates.cnt, "need": gates.need,
            "has_work": gates.has_work, "member": gates.member,
            "gvalid": gates.gvalid}
    tc = {key: _to_device(v, dev) for key, v in host.items()}
    E0 = np.array([float(c.comm.E0) for c in clusters])
    carry = _initial_carry(clusters, tapes, physics) + (
        _initial_tail(S, M, E0, dev),)

    zero_rows = np.zeros((chunk, M))
    stopped = np.zeros(S, bool)
    for b in range(-(-physics.grid_len // chunk)):
        if stopped.all():
            break
        t0 = time.perf_counter()
        k0 = b * chunk
        # tape drawing stays on the host: a stopped seed stops drawing
        # blocks, keeping its RNG stream aligned with the oracle's — the
        # one (S,) read a chunk this path makes
        _draw_chunk_tapes(tapes, stopped, k0, chunk)
        xs = _chunk_xs(clusters, tapes, visible, k0, chunk, stateful,
                       zero_rows, dev)
        carry = runner(carry, xs, consts, tc)
        stopped = carry[3]["stopped"].cpu().numpy()   # the host waits here
        if counters is not None:
            counters["chunks"] += 1
            counters["slots"] += chunk
            counters["host_waits"] += 1
            counters["seconds"] += time.perf_counter() - t0

    # one packed copy of the tail carry: (S, 7, M) rows, (S, 6) lanes,
    # (S, M) arrival mask — the epoch's only other wait
    tail = carry[3]
    packed = torch.cat([
        torch.stack([tail[k] for k in _TAIL_ROWS], 1).flatten(1),
        torch.stack([tail[k].double() for k in _TAIL_LANES], 1),
        tail["arrived"].double()], 1).cpu().numpy()
    if counters is not None:
        counters["host_waits"] += 1
    nr = len(_TAIL_ROWS) * M
    rows = {k: packed[:, :nr].reshape(S, -1, M)[:, i]
            for i, k in enumerate(_TAIL_ROWS)}
    lanes = {k: packed[:, nr + i] for i, k in enumerate(_TAIL_LANES)}
    arrived_all = packed[:, nr + len(_TAIL_LANES):] != 0
    if not lanes["stopped"].all():
        raise AssertionError("device comm loop ended with unstopped seeds")
    stats = []
    for i, job in enumerate(jobs):
        n = int(lanes["n_slots"][i])
        ok = bool(lanes["ok"][i])
        arrived = arrived_all[i].copy()
        # guard the one corner where the count/mask gate can diverge from
        # the exact one (an ill-conditioned LS decode): re-check on the
        # final mask — monotone arrivals make this sufficient — and refuse
        # to return silently different results
        if ok != bool(job.is_decodable(arrived)):
            raise RuntimeError(
                f"device decode gate diverged from the exact gate on lane "
                f"{i} (gate={ok}, exact={not ok}); this scheme needs the "
                f"host tail")
        stats.append(CommStats(
            n_slots=n,
            decode_time=float(n * physics.slot_T[i]),
            decode_ok=ok,
            arrived=arrived,
            bytes_offered=rows["snap_owed"][i].copy(),
            bytes_admitted=rows["admitted"][i].copy(),
            bytes_transmitted=rows["delivered"][i].copy(),
            queue_residual=rows["snap_Q"][i].copy(),
            pending_residual=rows["snap_pend"][i].copy(),
            min_energy=float(lanes["min_E"][i]),
            max_overdraft=float(lanes["max_od"][i]),
            final_energy=rows["snap_E"][i].copy(),
            idle_slots=int(lanes["idle"][i]),
        ))
    return stats
