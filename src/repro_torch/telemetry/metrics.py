"""Pure derived telemetry metrics (numpy only, no engine imports).

The paper's headline claims are *time-series* claims — fairness of the
perturbed-Lyapunov admission protocol (paper §4) and resource utilization
of two-stage coding (paper §3) — so the raw per-slot series the recorder
collects (``Q``/``H``/``E``/admissions/transmissions, DESIGN.md §3.9)
need standard reductions before they gate anything:

  * :func:`jain_index` — Jain's fairness index over per-worker totals,
    the metric the Lyapunov admission protocol is supposed to keep near 1;
  * :func:`queue_stability_drift` — least-squares slope of the total
    backlog over slots; a stable queue system drifts ≈ 0, a positive
    slope is the signature of an unstable admission policy;
  * :func:`straggler_rate_ewma` — the exponentially-weighted straggler
    rate adaptive-redundancy schemes key their ``s`` on (Adaptive
    Gradient Coding, arXiv:2006.04845);
  * :func:`fleet_fairness` / :func:`mean_queue_residual` — the
    :class:`~repro_torch.sim.montecarlo.FleetSummary` columns, reduced from a
    fleet's :class:`~repro_torch.sim.cluster.CommStats` ledgers.

Everything here is a pure function of arrays/results — no recorder, no
clock, no engine state — so the same reductions serve live summaries,
JSONL post-processing and regression bounds.

The torch port of ``repro.telemetry.metrics``.  :func:`jain_index` is the
port's one definition (``repro_torch.core.lyapunov.scheduler``), which
scales by the largest share before squaring: where the reference returns
NaN for shares whose squares underflow (``[1e-200]``), it returns 1.0.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from repro_torch.core.lyapunov.scheduler import jain_index

__all__ = ["jain_index", "queue_stability_drift", "slope_from_moments",
           "straggler_rate_ewma", "fleet_fairness", "mean_queue_residual",
           "comm_stats_of"]


def queue_stability_drift(q_series: np.ndarray) -> float:
    """Least-squares slope (bytes/slot) of the total backlog ``ΣQ_m(t)``.

    ``q_series`` is the recorder's ``(n_slots, M)`` per-slot backlog
    series (or an already-summed ``(n_slots,)`` vector).  A
    drift-plus-penalty policy keeping its queues strongly stable shows a
    drift ≈ 0 over a long horizon; a persistently positive slope means
    admissions outrun the uplink — the queue-stability regression bound
    the ROADMAP's scheduler-soak item gates on.  Series shorter than two
    slots have no measurable drift and return 0.0.
    """
    q = np.asarray(q_series, np.float64)
    if q.ndim == 2:
        q = q.sum(axis=1)
    if q.size < 2:
        return 0.0
    slots = np.arange(q.size, dtype=np.float64)
    return float(np.polyfit(slots, q, 1)[0])


def slope_from_moments(n, s_t, s_tt, s_q, s_tq):
    """Least-squares slope from running moments — the O(1)-memory form of
    :func:`queue_stability_drift` the soak harness's scan carry uses.

    Given ``n`` samples ``(t_i, q_i)`` summarized as ``s_t = Σt``,
    ``s_tt = Σt²``, ``s_q = Σq`` and ``s_tq = Σt·q``, returns the same
    ``polyfit(t, q, 1)[0]`` slope a materialized series would give —
    ``(n·Σtq − Σt·Σq) / (n·Σt² − (Σt)²)`` — without ever holding the
    series.  Degenerate windows (``n < 2`` or all-equal ``t``) have no
    measurable drift and return 0.0.  Inputs may be numpy arrays (the
    soak's per-lane (S,) moment rows); the reduction broadcasts.
    """
    n = np.asarray(n, np.float64)
    s_t = np.asarray(s_t, np.float64)
    s_tt = np.asarray(s_tt, np.float64)
    s_q = np.asarray(s_q, np.float64)
    s_tq = np.asarray(s_tq, np.float64)
    den = n * s_tt - s_t * s_t
    num = n * s_tq - s_t * s_q
    with np.errstate(divide="ignore", invalid="ignore"):
        slope = np.where((n >= 2.0) & (den > 0.0), num / np.where(
            den > 0.0, den, 1.0), 0.0)
    if slope.ndim == 0:
        return float(slope)
    return slope


def straggler_rate_ewma(counts: Sequence[float], alpha: float = 0.3,
                        ) -> np.ndarray:
    """EWMA of a per-epoch straggler-count series (``alpha`` = weight of
    the newest observation).  Returns the full smoothed series so both
    the live estimate (last element) and its trajectory are available."""
    if not 0.0 < alpha <= 1.0:
        raise ValueError(f"alpha must be in (0, 1], got {alpha}")
    c = np.asarray(counts, np.float64).ravel()
    out = np.empty_like(c)
    acc = 0.0
    for i, v in enumerate(c):
        acc = v if i == 0 else (1.0 - alpha) * acc + alpha * v
        out[i] = acc
    return out


def comm_stats_of(results: Iterable) -> list:
    """The non-None ``.comm`` ledgers of an epoch-result iterable
    (instant-uplink results carry no comm phase and are skipped)."""
    return [r.comm for r in results if getattr(r, "comm", None) is not None]


def fleet_fairness(results: Iterable) -> float:
    """Jain index of per-worker bytes admitted, totalled across every
    epoch result in the fleet — the FleetSummary fairness column.  A
    fleet with no comm phases is vacuously fair (1.0)."""
    stats = comm_stats_of(results)
    if not stats:
        return 1.0
    per_worker = np.sum([np.asarray(s.bytes_admitted, np.float64)
                         for s in stats], axis=0)
    return jain_index(per_worker)


def mean_queue_residual(results: Iterable) -> float:
    """Mean leftover per-worker backlog ``Q_m`` at epoch end (bytes),
    averaged over workers and epochs — the FleetSummary backlog column.
    0 for fleets with no comm phases."""
    stats = comm_stats_of(results)
    if not stats:
        return 0.0
    return float(np.mean([np.mean(np.asarray(s.queue_residual, np.float64))
                          for s in stats]))
