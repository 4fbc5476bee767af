"""Batched two-stage compute phase for the fleet engines.

The torch port of ``repro.sim.batched_compute`` (numpy float64, no torch:
the compute phase runs on the host in every engine).  The TSDCFL control
loop of stage-1 worker sampling, completion prediction, stage-2
assignment planning and the decode-requirement check is, in the oracle,
one host-side Python epoch loop per seed.  This module is its batched
twin: the
whole fleet's compute phase is evaluated at once, vectorized over the seed
axis, bit-exactly reproducing the per-seed
:meth:`~repro_torch.core.runtime.TwoStageRuntime.compute_phase` oracle.

Exactness contract (held by ``tests/test_torch_fleet.py`` on every
registry scenario × scheme):

  * **randomness** — each seed's sampling tape is drawn from that seed's
    own RNG stream (``engine.rng``) in exactly the order and sizes the
    oracle draws (:meth:`CompletionTimeModel.draw`; the same block-tape
    idea as :class:`~repro_torch.sim.channel.CommTape`) — and the stage-2 tape
    is drawn *only for lanes whose stage 2 actually triggered* — so after
    a batched epoch every stream sits at the oracle's position for the
    comm phase and the next epoch;
  * **arithmetic** — the vectorized steps are elementwise IEEE float64
    twins of the oracle's scalar cores (``sample_np``,
    ``stage1_deadline``, ``stage1_accounting``, ``plan_stage1_batched``,
    ``plan_stage2_batched``, ``update_times_batched``);
    ``np.quantile`` along the seed stack's last axis is bitwise identical
    to per-seed calls, and reductions keep the oracle's pairwise-sum
    shapes (the one compressed sum, ``stage1_useful``, stays per seed —
    padding it with zeros would pair addends differently);
  * **state** — the predictor EWMAs update as masked array ops over the
    ``(S, M)`` seed stack (one observation per worker per epoch, so the
    oracle's sequential loop order is immaterial), and the ragged
    stage-2 Vandermonde planning runs group-vectorized by
    ``(K_rem, s, n_active)`` signature through the *same* planner the
    oracle uses, so after the epoch the planner/predictor state of every
    lane is the oracle's, and a later oracle epoch on the same cluster
    still matches.

The cores are deliberately host-side numpy float64: the control plane
(coding matrices, decode solves, deadlines) is float64 by design
(DESIGN.md §2), and the exactness contract against the float64 oracle is
the whole point — the same reason the comm engine pre-resolves
Gilbert–Elliott thresholds in float64 on the host.  The device part of an
epoch remains the comm-phase chunk loop; with this module a full epoch
(compute + comm) costs one vectorized host pass plus one chunk loop,
instead of a per-seed Python loop.  The only
per-seed Python left in the two-stage epoch hot path is row slicing and
result-object construction — every planning, sampling, prediction and
decode-requirement step is vectorized or group-vectorized.

Fleets whose lanes differ in compute physics (a grouped sweep stacks cells
that share channel/comm physics but not compute physics) are partitioned
into *compute groups* of identical shape/branch structure — same
``(M, K, M1, select, deadline_quantile)`` and the same straggler/fault
draw presence — and each group is vectorized; per-lane rates, noise scales
and probabilities stack as per-lane columns inside a group.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.coding import StragglerPredictor
from repro_torch.core.runtime import (CompletionDraws, ComputePhase,
                                TwoStageRuntime,
                                decode_requirements_batched, sample_batched,
                                stage1_accounting, stage1_deadline)
from repro_torch.sim.cluster import CommJob, EdgeCluster

__all__ = ["batched_comm_jobs", "batched_compute_phase", "compute_group_key"]


def compute_group_key(rt: TwoStageRuntime) -> Tuple:
    """Vectorization-compatibility signature of one lane's compute phase.

    Lanes with equal keys share array shapes (``M``, ``K``, ``M1``), the
    stage-1 selection policy, the deadline quantile (a scalar argument of
    ``np.quantile``) and the tape *structure* (which uniform blocks
    :meth:`CompletionTimeModel.draw` consumes).  Everything else — rates,
    noise scale, probabilities, predictor state — varies freely per lane.
    """
    tm = rt.time_model
    return (rt.M, rt.K, rt.M1, rt.planner.select, rt.deadline_quantile,
            tm.straggler_prob > 0, tm.fault_prob > 0)


def batched_compute_phase(runtimes: Sequence[TwoStageRuntime],
                          epoch: int) -> List[ComputePhase]:
    """The fleet's two-stage compute phases, one vectorized pass per
    compute group — bit-identical to per-seed ``compute_phase`` calls."""
    phases: Dict[int, ComputePhase] = {}
    groups: Dict[Tuple, List[int]] = {}
    for i, rt in enumerate(runtimes):
        groups.setdefault(compute_group_key(rt), []).append(i)
    for idxs in groups.values():
        group = _phase_group([runtimes[i] for i in idxs], epoch)
        assert len(group) == len(idxs), "a compute group dropped a lane"
        for i, ph in zip(idxs, group):
            phases[i] = ph
    # grouping is a partition of range(len(runtimes)) by construction;
    # assert it so a partial fill can never escape as a silent None
    assert len(phases) == len(runtimes), "compute grouping lost lanes"
    return [phases[i] for i in range(len(runtimes))]


def _phase_group(rts: Sequence[TwoStageRuntime], epoch: int
                 ) -> List[ComputePhase]:
    """One compute group's phases (same shapes/branches across lanes)."""
    r0 = rts[0]
    S, M, M1 = len(rts), r0.M, r0.M1

    # --- stage 1: plan, sample, deadline (vectorized over seeds) ------- #
    speeds = np.stack([r.predictor.speeds() for r in rts])          # (S, M)
    st1s = r0.planner.plan_stage1_batched(epoch, speeds)
    workers = np.stack([p.workers for p in st1s])                   # (S, M1)
    tasks1 = np.stack([p.scheme.copies_per_worker for p in st1s])
    # each seed's tape comes from its own stream, in oracle draw order
    draws = CompletionDraws.stack(
        [r.time_model.draw(M1, r._rng) for r in rts])
    models = [r.time_model for r in rts]
    t1 = sample_batched(models, workers, tasks1, draws)             # (S, M1)

    per_task_q = np.take_along_axis(
        np.stack([r.predictor.time_quantile(0.9) for r in rts]),
        workers, axis=1)
    T_comp = stage1_deadline(per_task_q, tasks1, r0.deadline_quantile)
    finished = t1 <= T_comp[:, None]
    t_per_task = t1 / np.maximum(tasks1, 1)

    stage1_time, stage1_total, stage1_executed = stage1_accounting(
        t1, tasks1, finished, T_comp)

    ready = np.full((S, M), np.inf)
    rows, cols = np.nonzero(finished)
    ready[rows, workers[rows, cols]] = t1[rows, cols]

    # --- batched tail: predictor update, stage-2 plan + sample --------- #
    # EWMA updates run as one masked (S, M) scatter (each worker observed
    # at most once per epoch, so the oracle's sequential order is
    # immaterial); the forecast and the ragged Vandermonde stage-2
    # planning vectorize through the predictor/planner batched twins.
    predictors = [r.predictor for r in rts]
    sel = np.isfinite(t1) & finished
    StragglerPredictor.update_times_batched(predictors, workers,
                                            t_per_task, sel)
    s_hats = StragglerPredictor.predict_s_batched(
        predictors, M - finished.sum(axis=1), s_min=1)
    st2s = r0.planner.plan_stage2_batched(st1s, finished, s_hats, speeds)

    # Stage-2 sampling: each triggered lane draws its tape from its own
    # RNG stream (exactly the oracle's order and sizes — non-triggered
    # lanes draw nothing); the arithmetic then runs vectorized per
    # ragged group of equal active-worker count.
    t2s: Dict[int, np.ndarray] = {}
    by_n: Dict[int, List[int]] = {}
    lane_draws: Dict[int, CompletionDraws] = {}
    for i, st2 in enumerate(st2s):
        if st2.triggered:
            n = len(st2.active_workers)
            lane_draws[i] = rts[i].time_model.draw(n, rts[i]._rng)
            by_n.setdefault(n, []).append(i)
    for n, lanes in by_n.items():
        wk2 = np.stack([st2s[i].active_workers for i in lanes])
        tk2 = np.stack([st2s[i].scheme.copies_per_worker for i in lanes])
        tt = sample_batched([rts[i].time_model for i in lanes], wk2, tk2,
                            CompletionDraws.stack(
                                [lane_draws[i] for i in lanes]))
        lr = np.asarray(lanes)
        ready[lr[:, None], wk2] = np.where(
            np.isfinite(tt), stage1_time[lr][:, None] + tt, np.inf)
        for j, i in enumerate(lanes):
            t2s[i] = tt[j]

    return [ComputePhase(
        epoch=epoch, st1=st1s[i], st2=st2s[i], t1=t1[i], tasks1=tasks1[i],
        finished=finished[i], T_comp=float(T_comp[i]),
        stage1_time=float(stage1_time[i]), t2=t2s.get(i),
        tasks2=(st2s[i].scheme.copies_per_worker
                if st2s[i].triggered else None),
        ready_time=ready[i],
        stage1_total_task_time=float(stage1_total[i]),
        stage1_useful=float(np.sum(t1[i][finished[i]])),
        stage1_executed=float(stage1_executed[i])) for i in range(S)]


def batched_comm_jobs(clusters: Sequence[EdgeCluster],
                      epoch: int) -> List[CommJob]:
    """One epoch's :class:`CommJob` per cluster, compute phase batched.

    The two-stage control loop vectorizes through
    :func:`batched_compute_phase` and the fleet's decode-arrival
    requirements come out of one stacked pass
    (:func:`~repro_torch.core.runtime.decode_requirements_batched`), so the
    jobs are produced in one sweep over precomputed rows; the static
    single-stage baselines' compute phase is one cheap sampling call per
    seed, so those lanes delegate to ``EdgeCluster.comm_job`` unchanged.
    Either way the job — ready times, decode gate, result assembly — is
    built by the cluster's own ``job_from_*`` methods, shared with the
    event-driven engine.
    """
    clusters = list(clusters)
    if not clusters:
        return []
    if clusters[0].scheme != "two-stage":
        return [c.comm_job(epoch) for c in clusters]
    phases = batched_compute_phase([c.runtime for c in clusters], epoch)
    reqs = decode_requirements_batched(phases)
    return [c.job_from_phase(ph, requirements=rq)
            for c, ph, rq in zip(clusters, phases, reqs)]
