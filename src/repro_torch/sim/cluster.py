"""EdgeCluster: closed-loop co-simulation of one TSDCFL epoch.

The torch counterpart of ``repro.sim.cluster.EdgeCluster`` (the
event-driven engine the reference calls its oracle).  It couples the two
phases the paper analyses separately:

  compute phase (paper §3)
      ``TwoStageRuntime.compute_phase`` — stage-1 coded compute → deadline →
      stage-2 planning, producing per-worker *gradient-ready* times (or, for
      the CRS/FRS/uncoded baselines, a single-stage static scheme).  Host
      numpy, bit-identical to the reference.

  communication phase (paper §4)
      Each ready worker's coded partial gradient (``grad_bytes``) is offered
      to the drift-plus-penalty scheduler as the ``D_m`` arrival of
      ``schedule_slot``; per slot the channel model supplies ``r_m(t)``, the
      harvest model ``E^H_m(t)``, and the P4–P7 closed forms decide
      admission, energy intake and transmission time.  The queues and the
      scheduler run in float32 on ``device``; each slot's decisions come
      back to the host's float64 ledgers in one copy.

  decode
      Fires at the end of the first slot by which enough coded
      contributions have *arrived* (every stage-1 finisher + at least
      ``n_active − s`` stage-2 workers; for static schemes, any alive set
      ``decode_weights`` accepts) — not merely been computed.

The heap-based :class:`~repro_torch.sim.events.EventEngine` merges
continuous compute-completion events into the slotted comm timeline and
owns the one RNG stream behind completion sampling, fading and harvest.
All comm-phase randomness is drawn through a
:class:`~repro_torch.sim.channel.CommTape` in fixed blocks, so the
batched fleet engine (``repro_torch.sim.batched``) replays an epoch bit
for bit from the same seed.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.coded_step import build_slot_plan, slot_weights
from repro_torch.core.coding import CodingScheme, decode_weights
from repro_torch.core.lyapunov import (Observation, init_queues,
                                       make_system_params, schedule_slot)
from repro_torch.core.runtime import (EpochResult, build_epoch_backend,
                                      single_stage_accounting)
from repro_torch.sim.channel import ChannelModel, CommTape, StaticChannel
from repro_torch.sim.events import COMPUTE_DONE, SLOT_TICK, EventEngine
from repro_torch.telemetry.recorder import FleetRecorder, phase_span

__all__ = ["CommJob", "CommParams", "CommStats", "EdgeCluster", "GateSpec",
           "SCHEMES", "arrived_mask", "stuck_tolerance"]

SCHEMES = ("two-stage", "cyclic", "fractional", "uncoded")


@functools.lru_cache(maxsize=256)
def _shared_consts(M, slot_T, tx_power, delta, xi, f_max, F, E_cap, V,
                   n_subchannels, device):
    """``(SystemParams, L, zeros)`` per distinct uplink physics and device.

    Every cluster of a 64-seed fleet shares identical CommParams; caching
    the immutable float32 tensors turns 64 × 11 tiny device allocations
    into one.  Nothing writes to them (the scheduler returns new tensors).
    """
    dev = torch.device(device)
    return (make_system_params(M, T=slot_T, p=tx_power, delta=delta, xi=xi,
                               f_max=f_max, F=F, E_cap=E_cap, V=V,
                               device=dev),
            torch.tensor(n_subchannels, dtype=torch.float32, device=dev),
            torch.zeros((M,), dtype=torch.float32, device=dev))

#: Arrival tolerance: a worker's payload counts as arrived once
#: ``delivered >= owed·(1 − ARRIVAL_RTOL) − ARRIVAL_ATOL``.
ARRIVAL_RTOL = 1e-6
ARRIVAL_ATOL = 1e-12
#: Residual bytes below ``STUCK_FRAC · max(grad_bytes)`` count as drained
#: when deciding that an epoch is provably stuck.
STUCK_FRAC = 1e-6


def arrived_mask(owed: np.ndarray, delivered: np.ndarray) -> np.ndarray:
    """Workers whose full payload reached the server."""
    return (owed > 0) & (delivered >= owed - ARRIVAL_RTOL * owed
                         - ARRIVAL_ATOL)


def stuck_tolerance(grad_bytes: np.ndarray) -> float:
    """Residual-byte tolerance for the provably-stuck stop rule."""
    return STUCK_FRAC * float(np.max(grad_bytes))


@dataclasses.dataclass
class CommParams:
    """Physics of the uplink phase (paper §III.3 symbols + sim knobs)."""
    grad_bytes: float = 1.0        # payload per coded partial gradient
    slot_T: float = 0.1            # slot length (time units)
    n_subchannels: float = 2.0     # L(t): simultaneous uplink sub-channels
    V: float = 50.0                # Lyapunov trade-off knob
    tx_power: float = 0.5          # p_m — energy per unit transmission time
    E0: float = 5.0                # initial battery
    E_cap: float = 10.0            # battery capacity
    harvest_mean: float = 0.5      # mean harvestable energy per slot
    harvest_jitter: float = 0.5    # E_H ~ U(mean·(1−j), mean·(1+j))
    xi: float = 0.01               # server cycles per uploaded byte
    F: float = 100.0               # server cycles per slot
    f_max: float = 100.0           # worker cycles per slot (unused backlog)
    delta: float = 1e-3            # energy per worker cycle
    max_slots: int = 5000          # hard cap on comm slots per epoch


@dataclasses.dataclass(frozen=True)
class GateSpec:
    """Count/mask form of a job's decode gate:

        fires ⟺ has_work ∧ arrived[must].all()
                        ∧ count(arrived[count_over]) >= need
                        ∧ every FRS group in ``groups`` has an arrival

    Kept as the reference builds it; the event-driven loop here evaluates
    the exact ``is_decodable`` closure instead.
    """
    kind: str                 # two-stage | vandermonde | fractional | uncoded
    must: np.ndarray          # (n_must,) worker ids that must all arrive
    count_over: np.ndarray    # (n,) worker ids the count applies to
    need: int                 # arrivals needed among ``count_over``
    groups: Optional[np.ndarray] = None   # (M,) FRS group id per worker
    has_work: bool = True     # False ⟺ nothing was ever computed


@dataclasses.dataclass
class CommJob:
    """Comm-phase inputs + result assembly for one epoch."""
    ready_time: np.ndarray                       # (M,) gradient-ready times
    is_decodable: Callable[[np.ndarray], bool]   # arrival mask -> gate
    assemble: Callable[["CommStats"], EpochResult]
    gate: Optional[GateSpec] = None


@dataclasses.dataclass
class CommStats:
    """Per-epoch accounting of the communication phase (per-worker arrays
    are length M).  Conservation invariant (tested):
    ``bytes_admitted == bytes_transmitted + queue_residual`` per worker."""
    n_slots: int
    decode_time: float
    decode_ok: bool
    arrived: np.ndarray            # (M,) bool — full payload reached server
    bytes_offered: np.ndarray      # (M,) gradient bytes that became ready
    bytes_admitted: np.ndarray     # (M,) admitted into Q_m (P5)
    bytes_transmitted: np.ndarray  # (M,) drained from Q_m over the air
    queue_residual: np.ndarray     # (M,) final Q_m backlog
    pending_residual: np.ndarray   # (M,) ready bytes never admitted
    min_energy: float              # min over slots/workers of battery level
    max_overdraft: float           # max of (e_up+e_com − E_before); ≤ 0 ⟹
    final_energy: np.ndarray       # (M,)              never overspends
    idle_slots: int                # slots with no admission/transmission


class EdgeCluster:
    """One (scheme × scenario) co-simulated edge cluster.

    Produces :class:`~repro_torch.core.runtime.EpochResult` objects whose
    ``time`` is the end-to-end wall-clock (compute ∥ scheduled uplink) with
    a ``compute_time`` / ``comm_time`` breakdown, plus a slot plan +
    decode-weight matrix a trainer can step with.  The scheduler runs on
    ``device`` (the card unless the caller asks for ``"cpu"``).
    """

    def __init__(self, M: int, K: int, *, scheme: str = "two-stage",
                 M1: Optional[int] = None, s: int = 1,
                 rates: Optional[np.ndarray] = None,
                 noise_scale: float = 0.2, fault_prob: float = 0.0,
                 straggler_prob: float = 0.0, straggler_slow: float = 8.0,
                 deadline_quantile: float = 0.9,
                 channel: Optional[ChannelModel] = None,
                 comm: Optional[CommParams] = None,
                 n_slots: Optional[int] = None, seed: int = 0,
                 select: str = "rotate", device="cuda"):
        if scheme not in SCHEMES:
            raise ValueError(f"scheme must be one of {SCHEMES}, got {scheme}")
        self.M, self.K, self.s = M, K, s
        self.scheme = scheme
        self.device = torch.device(device)
        self.comm = comm or CommParams()
        self.channel = channel or StaticChannel(np.full(M, 10.0))
        if self.channel.M != M:
            raise ValueError(f"channel has {self.channel.M} workers, "
                             f"cluster has {M}")
        self.engine = EventEngine(seed)
        self._telemetry: Optional[FleetRecorder] = None
        self._telemetry_lane = 0
        rates = np.asarray(rates if rates is not None else np.ones(M),
                           np.float64)
        self.rates = rates

        self.runtime, self.static_scheme, self.time_model, self.n_slots = \
            build_epoch_backend(
                scheme, M, K, M1=M1, s=s, rates=rates,
                noise_scale=noise_scale, fault_prob=fault_prob,
                straggler_prob=straggler_prob,
                straggler_slow=straggler_slow, seed=seed, n_slots=n_slots,
                deadline_quantile=deadline_quantile, select=select,
                engine=self.engine)

        cp = self.comm
        self.grad_bytes = np.broadcast_to(
            np.asarray(cp.grad_bytes, np.float64), (M,)).copy()
        self.sys_params, self._L, self._zeros = _shared_consts(
            M, float(cp.slot_T), float(cp.tx_power), float(cp.delta),
            float(cp.xi), float(cp.f_max), float(cp.F), float(cp.E_cap),
            float(cp.V), float(cp.n_subchannels), str(self.device))

    # -- telemetry plumbing ---------------------------------------------- #
    @property
    def telemetry(self) -> Optional[FleetRecorder]:
        """Recorder observing this cluster (``None`` ⟹ telemetry off —
        the zero-cost default).  Propagates to the two-stage runtime so
        its stage-1/stage-2 spans land in the same recorder."""
        return self._telemetry

    @telemetry.setter
    def telemetry(self, rec: Optional[FleetRecorder]) -> None:
        self._telemetry = rec
        if self.runtime is not None:
            self.runtime.telemetry = rec
            self.runtime.telemetry_lane = self._telemetry_lane

    @property
    def telemetry_lane(self) -> int:
        """This cluster's lane index inside the recorded fleet."""
        return self._telemetry_lane

    @telemetry_lane.setter
    def telemetry_lane(self, lane: int) -> None:
        self._telemetry_lane = int(lane)
        if self.runtime is not None:
            self.runtime.telemetry_lane = int(lane)

    # ------------------------------------------------------------------ #
    def comm_job(self, epoch: int) -> CommJob:
        """Sample the compute phase and package the comm-phase inputs.

        Consumes this epoch's compute-phase randomness; the returned job
        must then be driven through exactly one comm phase (event-driven
        or batched) so the per-seed RNG stream stays aligned with the
        reference's.  The batched compute engine
        (``repro_torch.sim.batched_compute``) samples the phase for a
        whole fleet at once and hands each seed's outcome to the same
        :meth:`job_from_phase`/:meth:`job_from_static` methods.
        """
        if self.scheme == "two-stage":
            return self.job_from_phase(self.runtime.compute_phase(epoch))
        t = self.engine.sample_completion(
            self.time_model, np.arange(self.M),
            self.static_scheme.copies_per_worker)
        return self.job_from_static(t)

    def job_from_phase(self, ph, requirements=None) -> CommJob:
        """Comm job for a sampled two-stage :class:`ComputePhase`.

        ``requirements`` optionally supplies this phase's precomputed
        ``(must_arrive, stage2_workers, n_needed2)`` triple — the batched
        engine computes the whole fleet's triples in one stacked pass
        (:func:`~repro_torch.core.runtime.decode_requirements_batched`),
        so gate and assembly stay defined here for every engine.
        """
        must, w2, need2 = (self.runtime.decode_requirements(ph)
                           if requirements is None else requirements)

        def decodable(arrived: np.ndarray) -> bool:
            if len(must) == 0 and need2 == 0:
                return False  # nothing ever computed
            if not arrived[must].all():
                return False
            if need2:
                if int(arrived[w2].sum()) < need2:
                    return False
                try:  # the count gate is necessary, not sufficient
                    decode_weights(ph.st2.scheme, arrived[w2])
                except ValueError:
                    return False
            return True

        def assemble(stats: CommStats) -> EpochResult:
            # decodability is monotone in arrivals and gated per slot,
            # so a forced stop implies result_from_phase's own decode
            # fails (or a finisher is missing) — decode_ok needs no
            # override here.
            return self.runtime.result_from_phase(
                ph, stats.arrived, stats.decode_time, comm=stats)

        gate = GateSpec(kind="two-stage", must=np.asarray(must, int),
                        count_over=np.asarray(w2, int), need=int(need2),
                        has_work=bool(len(must) > 0 or need2 > 0))
        return CommJob(ph.ready_time, decodable, assemble, gate=gate)

    def job_from_static(self, t: np.ndarray) -> CommJob:
        """Comm job for sampled single-stage completion times ``t``."""
        scheme = self.static_scheme
        tasks = scheme.copies_per_worker

        def decodable(arrived: np.ndarray) -> bool:
            # no count precheck: FRS can decode with fewer than M - s
            # arrivals (one representative per group suffices)
            if not arrived.any():
                return False
            try:
                decode_weights(scheme, arrived)
                return True
            except ValueError:
                return False

        def assemble(stats: CommStats) -> EpochResult:
            return self._static_result(scheme, t, tasks, stats)

        M = self.M
        if scheme.kind == "uncoded":
            gate = GateSpec(kind="uncoded", must=np.arange(M),
                            count_over=np.zeros(0, int), need=0)
        elif scheme.kind == "fractional":
            gate = GateSpec(kind="fractional", must=np.zeros(0, int),
                            count_over=np.zeros(0, int), need=0,
                            groups=np.arange(M) // max(scheme.group_size, 1))
        else:           # vandermonde (CRS): closed-form needs M - s alive;
            # need >= 1 keeps the exact gate's any-arrived precheck
            gate = GateSpec(kind="vandermonde", must=np.zeros(0, int),
                            count_over=np.arange(M),
                            need=max(M - scheme.s, 1))
        return CommJob(t, decodable, assemble, gate=gate)

    # ------------------------------------------------------------------ #
    def run_epoch(self, epoch: int) -> EpochResult:
        """One co-simulated epoch: compute → scheduled uplink → decode."""
        rec, lane = self._telemetry, self._telemetry_lane
        with phase_span(rec, "compute_phase", epoch=epoch, lane=lane):
            job = self.comm_job(epoch)
        with phase_span(rec, "comm", epoch=epoch, lane=lane):
            stats = self._run_comm(job.ready_time, job.is_decodable,
                                   epoch=epoch)
        with phase_span(rec, "decode", epoch=epoch, lane=lane):
            result = job.assemble(stats)
        if rec:
            rec.record_epoch(lane, epoch, result)
        return result

    # ------------------------------------------------------------------ #
    def _static_result(self, scheme: CodingScheme, t: np.ndarray,
                       tasks: np.ndarray, stats: CommStats) -> EpochResult:
        M = self.M
        alive = stats.arrived
        try:
            a = decode_weights(scheme, alive)
            ok = True
        except ValueError:
            a = np.zeros(M)
            ok = False
        decode_time = stats.decode_time
        compute_time = float(np.max(t[alive], initial=0.0))
        if not alive.any():
            compute_time = float(np.max(np.where(np.isfinite(t), t, 0.0),
                                        initial=0.0))
        comm_time = max(decode_time - compute_time, 0.0)
        useful, total, executed = single_stage_accounting(
            t, tasks, alive, decode_time)
        plan = build_slot_plan([scheme], M, self.n_slots)
        w = slot_weights(plan, a)
        return EpochResult(
            plan=plan, weights=w, time=compute_time + comm_time,
            useful_task_time=useful, total_task_time=total,
            n_stragglers=int(M - alive.sum()), stage2_triggered=False,
            redundancy=scheme.redundancy,
            executed_tasks=executed, K=self.K, M=M,
            compute_time=compute_time, comm_time=comm_time,
            decode_ok=ok, comm=stats)

    # ------------------------------------------------------------------ #
    def _run_comm(self, ready_time: np.ndarray,
                  is_decodable: Callable[[np.ndarray], bool],
                  *, epoch: int = 0) -> CommStats:
        """Drain gradient payloads through the Lyapunov scheduler slot by
        slot until the decodable set has arrived (or progress is provably
        impossible / the slot cap fires).

        Per slot: one host→device copy of the observation rows (pending
        bytes, rates, harvest — float32, as the reference's scheduler
        inputs), the scheduler on ``device``, and one device→host copy of
        the decisions and post-step queues into the float64 ledgers.  With
        a recorder that wants series, the copy also brings ``H`` back and
        each slot's float32 rows are kept (the batched engine slices the
        same values out of its chunk outputs).
        """
        M, cp, eng = self.M, self.comm, self.engine
        dev = self.device
        rec = self._telemetry
        series = rec.wants_series if rec is not None else False
        kept = {f: [] for f in ("Q", "H", "E", "admitted", "transmitted",
                                "pending")} if series else None
        T = cp.slot_T
        eng.clear()
        eng.reset_clock()
        # All comm randomness flows through the tape (channel init, channel
        # per-slot uniforms, harvest); the channel object stays untouched.
        tape = CommTape(self.channel, eng.rng, cp.harvest_mean,
                        cp.harvest_jitter)
        ch_state = self.channel.init_state_np(tape.u_init)

        outstanding = 0
        for m in np.flatnonzero(np.isfinite(ready_time)):
            eng.schedule(float(ready_time[m]), COMPUTE_DONE, int(m))
            outstanding += 1

        state = init_queues(M, E0=cp.E0, device=dev)
        # the battery before each slot, as float32 on the host (the
        # reference reads state.E before stepping)
        E_host = np.full(M, cp.E0, np.float32)
        # pending is float32, bit-identical to the scheduler's D input
        pending = np.zeros(M, np.float32)  # ready at worker, not admitted
        owed = np.zeros(M)         # total payload each worker must deliver
        admitted = np.zeros(M)
        delivered = np.zeros(M)
        arrived = np.zeros(M, bool)
        Q_host = np.zeros(M, np.float32)
        min_E = float(cp.E0)
        max_overdraft = 0.0
        idle_slots = 0
        n_slots = 0
        decode_ok = False
        decode_time = 0.0

        eng.schedule(0.0, SLOT_TICK, 0)
        while not eng.empty():
            ev = eng.pop()
            if ev.kind == COMPUTE_DONE:
                m = ev.payload
                pending[m] += self.grad_bytes[m]
                owed[m] += self.grad_bytes[m]
                outstanding -= 1
                continue

            k = ev.payload                       # SLOT_TICK: decide slot k
            tape.ensure(k)
            r, ch_state = self.channel.step_np(ch_state, tape.channel_u(k),
                                               k)
            rows = torch.from_numpy(np.array(
                [pending, r, tape.harvest(k)], np.float32)).to(dev)
            obs = Observation(D=rows[0], r=rows[1], E_H=rows[2], L=self._L,
                              new_cycles=self._zeros)
            state, dec = schedule_slot(state, self.sys_params, obs)
            if series:
                back = torch.stack([dec.d, dec.c, dec.e_up, dec.e_com,
                                    state.Q, state.E, state.H]).cpu().numpy()
                d32, c32, e_up, e_com, Q_host, E_after, H_host = back
            else:
                back = torch.stack([dec.d, dec.c, dec.e_up, dec.e_com,
                                    state.Q, state.E]).cpu().numpy()
                d32, c32, e_up, e_com, Q_host, E_after = back
            d = d32.astype(np.float64)
            c = c32.astype(np.float64)
            spend = e_up.astype(np.float64) + e_com.astype(np.float64)
            max_overdraft = max(max_overdraft,
                                float(np.max(spend - E_host.astype(
                                    np.float64))))
            E_host = E_after
            pending -= np.minimum(pending, d32)
            admitted += d
            delivered += c
            min_E = min(min_E, float(np.min(E_after)))
            n_slots = k + 1
            if float(d.sum()) <= 0 and float(c.sum()) <= 0:
                idle_slots += 1
            if series:
                # post-step state + this slot's decisions, in the float32
                # the batched engine stacks — the parity contract
                kept["Q"].append(Q_host)
                kept["H"].append(H_host)
                kept["E"].append(E_after)
                kept["admitted"].append(d32)
                kept["transmitted"].append(c32)
                kept["pending"].append(pending.copy())

            arrived = arrived_mask(owed, delivered)
            if is_decodable(arrived):
                decode_ok = True
                decode_time = (k + 1) * T
                break
            q_left = float(Q_host.sum())
            tiny = stuck_tolerance(self.grad_bytes)
            if (outstanding == 0
                    and float(pending.astype(np.float64).sum()) <= tiny
                    and q_left <= tiny):
                # everything that will ever arrive has arrived — decode is
                # impossible for this epoch (too many faults): force stop
                decode_time = (k + 1) * T
                break
            if k + 1 >= cp.max_slots:
                decode_time = (k + 1) * T
                break
            eng.schedule((k + 1) * T, SLOT_TICK, k + 1)

        eng.clear()                              # drop unneeded computes
        if series:
            rec.record_comm_series(
                self._telemetry_lane, epoch, n_slots=n_slots,
                **{f: (np.stack(v) if v else np.zeros((0, M), np.float32))
                   for f, v in kept.items()})
        return CommStats(
            n_slots=n_slots, decode_time=decode_time, decode_ok=decode_ok,
            arrived=arrived, bytes_offered=owed.copy(),
            bytes_admitted=admitted, bytes_transmitted=delivered,
            queue_residual=Q_host.astype(np.float64),
            pending_residual=pending.astype(np.float64), min_energy=min_E,
            max_overdraft=max_overdraft,
            final_energy=E_host.astype(np.float64),
            idle_slots=idle_slots)
