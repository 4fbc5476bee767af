"""Two-stage epoch runtime: deadlines, completion simulation, decode weights.

A numpy copy of ``repro.core.runtime``: the port keeps its own so that it
never imports the JAX package.  Host arithmetic, and every draw from the
RNG stream, is bit-identical to it.

This is the host-side control loop of TSDCFL.  Completion times come from
a ``CompletionTimeModel`` (shifted-exponential per-worker service times +
fault probability — the standard straggler model matching the paper's
latency analysis).

The epoch is split into two explicit halves:

  * :meth:`TwoStageRuntime.compute_phase` — stage-1 plan → deadline →
    stage-2 plan, sampling completion times (through the event engine's RNG
    when one is attached) and recording per-worker *gradient-ready* times.
  * decode — the co-simulated path (:meth:`TwoStageRuntime.
    result_from_phase`, driven by ``repro_torch.sim.cluster.EdgeCluster``:
    decode fires only once enough coded contributions have *arrived*
    through the Lyapunov-scheduled uplink), or the instant-uplink path
    (:meth:`TwoStageRuntime.run_epoch`: decode fires as soon as enough
    workers have *computed*).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import TYPE_CHECKING, Optional

import numpy as np

if TYPE_CHECKING:                      # circular at runtime: sim → core
    from repro_torch.sim.cluster import CommStats

from repro_torch.core.coding import (CodingScheme, StragglerPredictor,
                                     TwoStagePlanner, build_static_scheme,
                                     decode_weights)
from repro_torch.core.coded_step import (SlotPlan, build_slot_plan,
                                         slot_weights)

__all__ = ["CompletionDraws", "CompletionTimeModel", "ComputePhase",
           "EpochResult", "TwoStageRuntime", "build_epoch_backend",
           "decode_requirements_batched", "sample_batched", "simulate_epoch_single_stage",
           "single_stage_accounting", "stage1_accounting",
           "stage1_deadline", "twostage_slot_bound"]


@dataclasses.dataclass
class CompletionTimeModel:
    """T_m = n_tasks / rate_m · (1 + Exp(noise)) · straggler_slowdown.

    ``straggler_prob`` injects the paper's 1–2 stragglers/epoch (a worker is
    slowed by ``straggler_slow``×); ``fault_prob`` models workers that never
    return (node failure).

    Sampling is split into a randomness tape (:meth:`draw`, RNG consumption
    only) and a pure core (:meth:`sample_np`, arithmetic only), as in the
    reference, whose batched compute engine evaluates the arithmetic
    vectorized across a fleet.  ``sample`` composes the two.
    """
    rates: np.ndarray                 # (M,) tasks per unit time
    noise_scale: float = 0.2
    fault_prob: float = 0.0
    straggler_prob: float = 0.0
    straggler_slow: float = 8.0

    def draw(self, n: int, rng: np.random.Generator) -> "CompletionDraws":
        """Draw one sampling tape for ``n`` workers (RNG consumption only).

        Order and sizes match what :meth:`sample` has always consumed:
        exponential noise, then straggler uniforms iff straggler_prob > 0,
        then fault uniforms iff fault_prob > 0 — both conditions are static
        scenario physics, so consumption is deterministic per call.
        """
        noise = rng.exponential(self.noise_scale, size=n)
        u_straggle = (rng.random(n) if self.straggler_prob > 0 else None)
        u_fault = rng.random(n) if self.fault_prob > 0 else None
        return CompletionDraws(noise, u_straggle, u_fault)

    def sample_np(self, worker_ids: np.ndarray, n_tasks: np.ndarray,
                  draws: "CompletionDraws") -> np.ndarray:
        """Pure completion times from a pre-drawn tape (no RNG access).

        Works elementwise on any leading batch shape: stacking S seeds'
        tapes into (S, n) arrays yields bitwise-identical rows to S
        independent calls, because every op is elementwise IEEE float64.
        """
        worker_ids = np.asarray(worker_ids, int)
        n_tasks = np.asarray(n_tasks, np.float64)
        base = n_tasks / self.rates[worker_ids]
        t = base * (1.0 + draws.noise)
        if self.straggler_prob > 0:
            slow = draws.u_straggle < self.straggler_prob
            t = np.where(slow, t * self.straggler_slow, t)
        if self.fault_prob > 0:
            t = np.where(draws.u_fault < self.fault_prob, np.inf, t)
        return t

    def sample(self, worker_ids: np.ndarray, n_tasks: np.ndarray,
               rng: np.random.Generator) -> np.ndarray:
        worker_ids = np.asarray(worker_ids, int)
        return self.sample_np(worker_ids, n_tasks,
                              self.draw(len(worker_ids), rng))


@dataclasses.dataclass
class CompletionDraws:
    """One :meth:`CompletionTimeModel.draw` tape: per-worker noise plus the
    optional straggler/fault uniforms (None when that physics is off).
    Stackable along a leading seed axis for the batched compute engine."""
    noise: np.ndarray
    u_straggle: Optional[np.ndarray]
    u_fault: Optional[np.ndarray]

    @staticmethod
    def stack(draws: "list[CompletionDraws]") -> "CompletionDraws":
        """(S,)-list of (n,) tapes → one (S, n) tape."""
        return CompletionDraws(
            np.stack([d.noise for d in draws]),
            (np.stack([d.u_straggle for d in draws])
             if draws[0].u_straggle is not None else None),
            (np.stack([d.u_fault for d in draws])
             if draws[0].u_fault is not None else None))


def sample_batched(models, worker_ids: np.ndarray, n_tasks: np.ndarray,
                   draws: CompletionDraws) -> np.ndarray:
    """Batched twin of :meth:`CompletionTimeModel.sample_np` over a stack
    of per-lane models: row i is bitwise the row ``models[i].sample_np``
    would produce from ``draws`` row i.

    Lanes may differ in rates / probabilities / slowdown (stacked as
    per-lane columns), but must agree on *which* uniforms were drawn —
    all lanes with straggler physics on, or all off (and likewise for
    faults); the batched compute engine groups lanes accordingly.
    """
    worker_ids = np.asarray(worker_ids, int)
    n_tasks = np.asarray(n_tasks, np.float64)
    rates = np.stack([m.rates for m in models])
    base = n_tasks / np.take_along_axis(rates, worker_ids, axis=1)
    t = base * (1.0 + draws.noise)
    if draws.u_straggle is not None:
        prob = np.array([m.straggler_prob for m in models])[:, None]
        slow_by = np.array([m.straggler_slow for m in models])[:, None]
        t = np.where(draws.u_straggle < prob, t * slow_by, t)
    if draws.u_fault is not None:
        fprob = np.array([m.fault_prob for m in models])[:, None]
        t = np.where(draws.u_fault < fprob, np.inf, t)
    return t


def stage1_deadline(per_task_q: np.ndarray, tasks1: np.ndarray,
                    deadline_quantile: float) -> np.ndarray:
    """T_comp: deadline_quantile (over selected workers) of each worker's
    predicted finish time for its own share, with a 5% slack.  Pure; works
    on (M1,) rows or an (S, M1) stack (quantile along the last axis is
    bitwise identical to per-row calls)."""
    pred_finish = per_task_q * np.maximum(tasks1, 1)
    return np.quantile(pred_finish, deadline_quantile, axis=-1) * 1.05


def stage1_accounting(t1: np.ndarray, tasks1: np.ndarray,
                      finished: np.ndarray, T_comp) -> tuple:
    """(stage1_time, total_task_time, executed) for the stage-1 window.

    Pure twin of the oracle's scalar bookkeeping; accepts (M1,) rows with
    scalar ``T_comp`` or an (S, M1) stack with (S,) deadlines.  The
    zero-padded masked max is exact because completion times are strictly
    positive; ``stage1_useful`` is *not* computed here — its compressed
    sum ``t1[finished].sum()`` pairs addends differently than a padded
    sum, so callers keep it per seed.
    """
    T_comp = np.asarray(T_comp, np.float64)
    Tc = T_comp[..., None]
    mx = np.minimum(np.max(np.where(finished, t1, 0.0), axis=-1), T_comp)
    stage1_time = np.where(finished.all(axis=-1), mx, T_comp)
    total = np.sum(np.minimum(t1, Tc), axis=-1)
    # partition-copies executed by the deadline (partial work counts)
    executed = np.sum(tasks1 * np.minimum(t1, Tc)
                      / np.maximum(t1, 1e-12), axis=-1)
    return stage1_time, total, executed


def twostage_slot_bound(M: int, K: int, M1: int, s: int) -> int:
    """Static slot-count bound: stage-1 share + worst-case stage-2 share."""
    per1 = -(-K // max(M1, 1))
    per2 = -(-(K * (s + 2)) // max(M - 1, 1)) + 1
    return per1 + per2 + 2


def build_epoch_backend(scheme: str, M: int, K: int, *, M1, s, rates,
                        noise_scale, fault_prob, straggler_prob,
                        straggler_slow, seed, n_slots,
                        deadline_quantile: float = 0.9,
                        select: str = "rotate", engine=None):
    """Per-scheme epoch-simulation backend, shared by ``FELTrainer`` and
    ``EdgeCluster`` so their setups cannot drift.

    Returns ``(runtime, static_scheme, time_model, n_slots)`` — exactly one
    of ``runtime``/``static_scheme`` is non-None.  For two-stage the
    runtime's slot width is pinned to the static bound (one train-step
    compile; oversized epochs auto-size, see ``_assemble``).
    """
    rates = np.asarray(rates, np.float64)
    if scheme == "two-stage":
        runtime = TwoStageRuntime(
            M, K, M1 or max(M // 2, 1), rates=rates,
            noise_scale=noise_scale, fault_prob=fault_prob,
            straggler_prob=straggler_prob, straggler_slow=straggler_slow,
            deadline_quantile=deadline_quantile, seed=seed, select=select,
            engine=engine)
        n_slots = n_slots or twostage_slot_bound(M, K, runtime.M1, s)
        runtime.n_slots = n_slots
        return runtime, None, runtime.time_model, n_slots
    static = build_static_scheme(scheme, M, K, s)
    time_model = CompletionTimeModel(rates, noise_scale, fault_prob,
                                     straggler_prob, straggler_slow)
    return None, static, time_model, (
        n_slots or int(static.copies_per_worker.max()))


@dataclasses.dataclass
class EpochResult:
    plan: SlotPlan
    weights: np.ndarray               # (M, n_slots) loss weights a_m·B[m,k]
    time: float                       # simulated epoch wall-clock
    useful_task_time: float
    total_task_time: float
    n_stragglers: int
    stage2_triggered: bool
    redundancy: float
    executed_tasks: float = 0.0       # partition-copies actually computed
    K: int = 0

    M: int = 0

    # compute/comm wall-clock breakdown. ``compute_time`` is the epoch time
    # under a free/instant uplink (the pre-co-sim semantics); ``comm_time``
    # is the extra wall-clock until the decodable set *arrived* at the
    # server.  time == compute_time + comm_time.  Legacy (instant-uplink)
    # paths report comm_time == 0.
    compute_time: float = 0.0
    comm_time: float = 0.0
    decode_ok: bool = True
    comm: Optional["CommStats"] = None   # None on instant-uplink paths

    @property
    def utilization(self) -> float:
        """Useful compute-time / (M × epoch wall-clock)."""
        denom = max(self.M, 1) * max(self.time, 1e-12)
        return min(self.useful_task_time / denom, 1.0)

    @property
    def compute_efficiency(self) -> float:
        """K / partition-copies executed — redundancy-adjusted efficiency
        (the paper's computational-resource claim C3: redundant coded
        copies and discarded partial work count as waste)."""
        return min(self.K / max(self.executed_tasks, 1e-12), 1.0)


@dataclasses.dataclass
class ComputePhase:
    """Outcome of the compute half of a TSDCFL epoch, before any uplink.

    ``ready_time[m]`` is the absolute (epoch-relative) wall-clock at which
    worker ``m``'s coded partial gradient becomes available for upload
    (``inf`` for workers that produce nothing: non-selected, cut at the
    deadline without a stage-2 role, or faulted).
    """
    epoch: int
    st1: object                       # Stage1Plan
    st2: object                       # Stage2Plan
    t1: np.ndarray                    # (M1,) sampled stage-1 times
    tasks1: np.ndarray
    finished: np.ndarray              # (M1,) bool — finished by T_comp
    T_comp: float
    stage1_time: float
    t2: Optional[np.ndarray]          # (n_active,) stage-2 times, None if
    tasks2: Optional[np.ndarray]      # stage 2 was not triggered
    ready_time: np.ndarray            # (M,) gradient-ready wall-clock
    stage1_total_task_time: float
    stage1_useful: float
    stage1_executed: float

    @property
    def triggered(self) -> bool:
        return self.st2.triggered


class TwoStageRuntime:
    """Per-epoch TSDCFL control: plan stage 1 → observe → plan stage 2.

    When ``engine`` (a ``repro_torch.sim.events.EventEngine``) is supplied, all
    completion-time sampling draws from the engine's RNG stream so the
    compute phase and the communication phase of a co-simulation share one
    randomness source.
    """

    def __init__(self, M: int, K: int, M1: int, *, rates: np.ndarray,
                 noise_scale: float = 0.2, fault_prob: float = 0.0,
                 straggler_prob: float = 0.0, straggler_slow: float = 8.0,
                 deadline_quantile: float = 0.9, n_slots: int = 0,
                 seed: int = 0, select: str = "rotate", engine=None):
        self.M, self.K, self.M1 = M, K, M1
        self.planner = TwoStagePlanner(M, K, M1, select=select, seed=seed)
        self.predictor = StragglerPredictor(M)
        self.time_model = CompletionTimeModel(
            np.asarray(rates, np.float64), noise_scale, fault_prob,
            straggler_prob, straggler_slow)
        self.deadline_quantile = deadline_quantile
        self.n_slots = n_slots or None
        self.engine = engine
        self._rng = (engine.rng if engine is not None
                     else np.random.default_rng(seed + 1))
        #: Optional telemetry recorder (duck-typed; see
        #: ``repro_torch.telemetry.recorder``).  When set and span
        #: recording is enabled, the compute phase wraps its stage-1 and
        #: stage-2 halves in wall-clock spans; ``None`` (the default)
        #: keeps the phase span-free — the zero-cost off switch.
        self.telemetry = None
        #: This runtime's lane in the recorded fleet.
        self.telemetry_lane = 0

    def _span(self, name: str, **meta):
        rec = self.telemetry
        if rec is not None and rec.wants_spans:
            return rec.span(name, lane=self.telemetry_lane, **meta)
        return contextlib.nullcontext()

    # ------------------------------------------------------------------ #
    def compute_phase(self, epoch: int) -> ComputePhase:
        """Plan + sample the compute half of the epoch (no decode yet).

        The stochastic/arithmetic steps route through the pure cores
        (``CompletionTimeModel.draw``/``sample_np``, :func:`stage1_deadline`,
        :func:`stage1_accounting`) the reference shares with its batched
        compute engine, so the draw order is the reference's.
        """
        M = self.M
        with self._span("stage1", epoch=epoch):
            speeds = self.predictor.speeds()
            st1 = self.planner.plan_stage1(epoch, speeds)
            tasks1 = st1.scheme.copies_per_worker             # (M1,)
            t1 = self.time_model.sample(st1.workers, tasks1, self._rng)

            # per-worker-aware deadline: quantile (over selected workers)
            # of the predicted finish time of each worker's own share
            per_task_q = self.predictor.time_quantile(0.9)[st1.workers]
            T_comp = float(stage1_deadline(per_task_q, tasks1,
                                           self.deadline_quantile))
            finished = t1 <= T_comp

            # predictor update with whatever we observed by the deadline
            obs = np.isfinite(t1)
            self.predictor.update_times(
                st1.workers[obs & finished],
                (t1 / np.maximum(tasks1, 1))[obs & finished])

        # RNG-free stage-1 accounting (ahead of the stage-2 span, so the
        # span covers planning and sampling without reordering draws)
        stage1_time, stage1_total, stage1_executed = (
            float(x) for x in stage1_accounting(t1, tasks1, finished,
                                                T_comp))
        stage1_useful = float(np.sum(t1[finished]))
        ready = np.full(M, np.inf)
        ready[st1.workers[finished]] = t1[finished]

        with self._span("stage2", epoch=epoch):
            s_hat = self.predictor.predict_s(
                n_active=M - int(finished.sum()), s_min=1)
            st2 = self.planner.plan_stage2(st1, finished, s_hat, speeds)
            t2 = tasks2 = None
            if st2.triggered:
                tasks2 = st2.scheme.copies_per_worker
                t2 = self.time_model.sample(st2.active_workers, tasks2,
                                            self._rng)
                ready[st2.active_workers] = np.where(
                    np.isfinite(t2), stage1_time + t2, np.inf)
        return ComputePhase(
            epoch=epoch, st1=st1, st2=st2, t1=t1, tasks1=tasks1,
            finished=finished, T_comp=T_comp, stage1_time=stage1_time,
            t2=t2, tasks2=tasks2, ready_time=ready,
            stage1_total_task_time=stage1_total,
            stage1_useful=stage1_useful, stage1_executed=stage1_executed)

    # ------------------------------------------------------------------ #
    def _assemble(self, ph: ComputePhase, alive2: Optional[np.ndarray],
                  stage2_cutoff: float, *, time: float,
                  compute_time: float, comm_time: float,
                  comm=None, arrived1: Optional[np.ndarray] = None
                  ) -> EpochResult:
        """Decode + bookkeeping shared by the legacy and co-sim paths.

        ``alive2`` is the stage-2 alive mask used for the decode (ignored
        when stage 2 never triggered); ``stage2_cutoff`` bounds the partial
        work counted as executed during stage 2.  ``arrived1`` masks the
        stage-1 finishers whose payload actually reached the server (None
        = all of them, the instant-uplink semantics).
        """
        M, K = self.M, self.K
        st1, st2 = ph.st1, ph.st2
        schemes = []
        decode_w_global = np.zeros(M)
        decode_ok = True
        # stage-1 finishers: uncoded contribution, weight 1
        fin_rows = np.flatnonzero(ph.finished)
        if len(fin_rows):
            B_fin = st1.scheme.B[fin_rows]
            schemes.append(CodingScheme(
                B=B_fin, s=0, kind="uncoded",
                workers=st1.workers[fin_rows],
                partitions=st1.partitions))
            fin_got = (np.ones(len(fin_rows), bool) if arrived1 is None
                       else np.asarray(arrived1, bool))
            decode_w_global[st1.workers[fin_rows[fin_got]]] = 1.0
            if not fin_got.all():
                decode_ok = False

        total_task_time = ph.stage1_total_task_time
        useful = ph.stage1_useful
        executed = ph.stage1_executed
        n_straggle = 0

        if st2.triggered:
            scheme2, t2, tasks2 = st2.scheme, ph.t2, ph.tasks2
            n_active = scheme2.M
            try:
                a2 = decode_weights(scheme2, alive2)
            except ValueError:
                a2 = np.zeros(n_active)
                decode_ok = False
            decode_w_global[st2.active_workers] = a2
            schemes.append(scheme2)
            n_straggle = int(n_active - alive2.sum())
            total_task_time += float(np.sum(np.minimum(
                t2, np.where(np.isfinite(t2), t2, stage2_cutoff))))
            t2f = np.where(np.isfinite(t2), t2, np.inf)
            executed += float(np.sum(
                tasks2 * np.minimum(t2f, stage2_cutoff)
                / np.maximum(t2f, 1e-12)))
            # useful work: alive workers' coded tasks that enter the decode
            useful += float(np.sum(t2[alive2]))
            self.predictor.update_times(
                st2.active_workers[alive2],
                (t2 / np.maximum(tasks2, 1))[alive2])

        self.predictor.update_straggler_count(n_straggle)
        try:
            plan = build_slot_plan(schemes, M, self.n_slots)
        except ValueError:
            # the predictor's s_hat can exceed the static slot bound in
            # pathological epochs — auto-size rather than crash (costs one
            # re-jit of the train step for that width)
            plan = build_slot_plan(schemes, M, None)
        if not decode_ok:
            # failed epoch (decoder.py contract): without a full decode the
            # weighted gradient would be a *biased* partial sum — zero every
            # weight so the step is an exact no-op, flagged via decode_ok.
            decode_w_global[:] = 0.0
        w = slot_weights(plan, decode_w_global)
        red = plan.slot_coeff[plan.slot_partition >= 0].size / max(K, 1)
        return EpochResult(plan=plan, weights=w, time=time,
                           useful_task_time=useful,
                           total_task_time=total_task_time,
                           n_stragglers=n_straggle,
                           stage2_triggered=st2.triggered, redundancy=red,
                           executed_tasks=executed, K=K, M=M,
                           compute_time=compute_time, comm_time=comm_time,
                           decode_ok=decode_ok, comm=comm)

    # ------------------------------------------------------------------ #
    def run_epoch(self, epoch: int) -> EpochResult:
        """Legacy instant-uplink epoch: decode as soon as enough workers
        have *computed* (synchronous wait for the fastest n_active − s)."""
        ph = self.compute_phase(epoch)
        time = ph.stage1_time
        alive2 = None
        stage2_cutoff = 0.0
        if ph.triggered:
            t2 = ph.t2
            n_active = ph.st2.scheme.M
            s = ph.st2.scheme.s
            order = np.argsort(np.where(np.isfinite(t2), t2, np.inf))
            need = n_active - s
            alive2 = np.zeros(n_active, bool)
            alive2[order[:need]] = True
            alive2 &= np.isfinite(t2)
            stage2_cutoff = float(np.max(t2[alive2], initial=0.0))
            time = ph.stage1_time + stage2_cutoff
        return self._assemble(ph, alive2, stage2_cutoff, time=time,
                              compute_time=time, comm_time=0.0)

    # ------------------------------------------------------------------ #
    def result_from_phase(self, ph: ComputePhase, arrived: np.ndarray,
                          decode_time: float, comm=None) -> EpochResult:
        """Co-simulated epoch: decode from the set whose coded partial
        gradients *arrived* through the scheduled uplink by ``decode_time``.

        Args:
          arrived: bool (M,) — workers whose full gradient payload reached
            the server.
          decode_time: wall-clock at which the decodable set completed
            arrival (the epoch's end-to-end time).
          comm: CommStats attached to the result.
        """
        arrived = np.asarray(arrived, bool)
        alive2 = None
        compute_time = ph.stage1_time
        stage2_cutoff = 0.0
        if ph.triggered:
            alive2 = arrived[ph.st2.active_workers]
            # arrived ⟹ computed, so t2 is finite on alive2
            stage2_cutoff = max(decode_time - ph.stage1_time, 0.0)
            compute_time = ph.stage1_time + float(
                np.max(ph.t2[alive2], initial=0.0))
        # (no stage-2: the compute phase ends at stage1_time regardless of
        # which finishers' payloads arrived — the deadline bounds it)
        comm_time = max(decode_time - compute_time, 0.0)
        arrived1 = arrived[ph.st1.workers[ph.finished]]
        return self._assemble(ph, alive2, stage2_cutoff,
                              time=compute_time + comm_time,
                              compute_time=compute_time,
                              comm_time=comm_time, comm=comm,
                              arrived1=arrived1)

    # ------------------------------------------------------------------ #
    def decode_requirements(self, ph: ComputePhase):
        """(must_arrive, stage2_workers, n_needed2) for the arrival gate.

        Decode fires once every stage-1 finisher's gradient has arrived
        (their partitions are uniquely covered) and, when stage 2 was
        triggered, at least ``n_active − s`` stage-2 gradients arrived.
        """
        must = ph.st1.workers[ph.finished]
        if ph.triggered:
            sch = ph.st2.scheme
            return must, ph.st2.active_workers, sch.M - sch.s
        return must, np.zeros(0, int), 0


# --------------------------------------------------------------------- #
def decode_requirements_batched(phases: "list[ComputePhase]") -> list:
    """The fleet's decode-arrival requirements in one vectorized pass.

    Returns one ``(must_arrive, stage2_workers, n_needed2)`` triple per
    phase, identical to per-seed :meth:`TwoStageRuntime.
    decode_requirements` calls: the stage-1 finisher extraction
    (``st1.workers[finished]``) runs as a single stacked ``nonzero`` +
    split per ``M1`` shape group instead of S per-seed index calls; the
    stage-2 entries are O(1) attribute reads.
    """
    reqs: list = [None] * len(phases)
    groups: dict = {}
    for i, ph in enumerate(phases):
        groups.setdefault(len(ph.finished), []).append(i)
    for idxs in groups.values():
        workers = np.stack([phases[i].st1.workers for i in idxs])
        fin = np.stack([phases[i].finished for i in idxs])
        rows, cols = np.nonzero(fin)
        musts = np.split(workers[rows, cols],
                         np.cumsum(fin.sum(axis=1))[:-1])
        for must, i in zip(musts, idxs):
            ph = phases[i]
            if ph.triggered:
                sch = ph.st2.scheme
                reqs[i] = (must, ph.st2.active_workers, sch.M - sch.s)
            else:
                reqs[i] = (must, np.zeros(0, int), 0)
    return reqs


# --------------------------------------------------------------------- #
def single_stage_accounting(t: np.ndarray, tasks: np.ndarray,
                            alive: np.ndarray, cutoff: float
                            ) -> tuple[float, float, float]:
    """(useful, total, executed) task-time accounting for a single-stage
    epoch — shared by the instant-uplink baseline and the co-simulator so
    the utilization/efficiency metrics cannot drift between paths."""
    tf = np.where(np.isfinite(t), t, np.inf)
    useful = float(np.sum(t[alive]))
    total = float(np.sum(np.minimum(tf, cutoff)))
    executed = float(np.sum(tasks * np.minimum(tf, cutoff)
                            / np.maximum(tf, 1e-12)))
    return useful, total, executed


def simulate_epoch_single_stage(scheme: CodingScheme,
                                time_model: CompletionTimeModel,
                                rng, wait_for: Optional[int] = None) -> dict:
    """Baseline epoch (CRS/FRS/uncoded) under the instant uplink: all M
    workers start together and decode waits for the M-s fastest.

    Returns the decode weights, the epoch time, the alive mask and the
    utilization inputs.  A failed decode has zero weights, ``ok`` False and
    the time of the last finite worker.
    """
    M = scheme.M
    tasks = scheme.copies_per_worker
    t = time_model.sample(np.arange(M), tasks, rng)
    need = wait_for if wait_for is not None else M - scheme.s
    order = np.argsort(np.where(np.isfinite(t), t, np.inf))
    alive = np.zeros(M, bool)
    alive[order[:need]] = True
    alive &= np.isfinite(t)
    time = float(np.max(t[alive], initial=0.0))
    try:
        a = decode_weights(scheme, alive)
        ok = True
    except ValueError:
        a = np.zeros(M)
        ok = False
        time = float(np.max(np.where(np.isfinite(t), t, 0.0)))
    useful, total, executed = single_stage_accounting(t, tasks, alive, time)
    return {"decode_w": a, "time": time, "alive": alive, "ok": ok,
            "useful_task_time": useful, "total_task_time": total,
            "redundancy": scheme.redundancy, "executed_tasks": executed}
