"""Batched multi-seed co-simulation fleets with summary statistics.

The torch port of ``repro.sim.montecarlo``; every entry point runs on the
card unless the caller passes ``device="cpu"``.


``run_fleet`` runs one (scenario × scheme) pair across ``n_seeds``
independent clusters and aggregates the epoch results;
``compare_schemes`` sweeps all four coding schemes under the same scenario
and seed list so the comparison shares sampled conditions.

Engine dispatch: by default epochs run on the batched fleet engine
(``repro_torch.sim.batched`` — one chunk-runner call advances every
seed's communication phase by a chunk of slots); ``engine="oracle"``
replays the same seeds through the event-driven
:class:`~repro_torch.sim.cluster.EdgeCluster` loop.  Both engines draw
from identical per-seed randomness tapes, so for the same arguments they
produce the same per-epoch results (the contract
``tests/test_torch_fleet.py`` enforces).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.runtime import EpochResult
from repro_torch.sim.cluster import SCHEMES
from repro_torch.sim.fleet import ENGINES, Fleet
from repro_torch.sim.scenarios import resolve_scenario
from repro_torch.sim.spec import ExperimentSpec, fleet_seeds
from repro_torch.telemetry.metrics import fleet_fairness, mean_queue_residual
from repro_torch.telemetry.recorder import FleetRecorder

__all__ = ["FleetSummary", "run_fleet", "run_experiment",
           "compare_schemes", "ENGINES"]


@dataclasses.dataclass
class FleetSummary:
    scenario: str
    scheme: str
    n_seeds: int
    n_epochs: int
    mean_time: float           # mean epoch wall-clock (compute + comm)
    std_time: float
    p50_time: float
    p95_time: float
    mean_compute_time: float
    mean_comm_time: float
    comm_fraction: float       # comm share of the epoch wall-clock
    mean_utilization: float
    mean_slots: float          # comm slots per epoch
    decode_failure_rate: float
    mean_stragglers: float
    # telemetry-derived fleet-health columns (repro_torch.telemetry.metrics);
    # trailing defaults keep older positional constructions working
    jain_fairness: float = 1.0       # Jain index over admitted bytes
    mean_queue_residual: float = 0.0  # mean end-of-epoch Q_m backlog
    # epochs whose decode failed: the paper's *no-op steps* — wall-clock
    # burned with no model progress (``CodedTrainer`` leaves params
    # untouched on these).  Absolute count across the fleet; the rate is
    # ``decode_failure_rate``.
    noop_steps: int = 0

    def row(self) -> str:
        return (f"{self.scenario:<30s} {self.scheme:<10s} "
                f"time={self.mean_time:6.3f}±{self.std_time:5.3f} "
                f"(comp={self.mean_compute_time:6.3f} "
                f"comm={self.mean_comm_time:6.3f} "
                f"{100 * self.comm_fraction:4.1f}%) "
                f"p95={self.p95_time:6.3f} slots={self.mean_slots:5.1f} "
                f"fail={self.decode_failure_rate:.2f} "
                f"noop={self.noop_steps:d} "
                f"jain={self.jain_fairness:.3f}")


def summarize_fleet(scenario: str, scheme: str, n_seeds: int,
                    n_epochs: int,
                    results: Sequence[EpochResult]) -> FleetSummary:
    """Reduce seed-major per-epoch results to a :class:`FleetSummary`
    (shared by ``run_fleet`` and the grouped ``repro_torch.sim.sweep`` path, so
    a sweep cell's row is bit-identical to its standalone fleet)."""
    times = [r.time for r in results]
    comp = [r.compute_time for r in results]
    comm = [r.comm_time for r in results]
    util = [r.utilization for r in results]
    strag = [r.n_stragglers for r in results]
    slots = [r.comm.n_slots if r.comm is not None else 0 for r in results]
    failures = sum(1 for r in results if not r.decode_ok)
    t = np.asarray(times)
    # With fewer than 20 epoch samples the default linear interpolation
    # fabricates a 95th percentile between the top two order statistics —
    # an epoch time nobody observed.  Report the nearest observed value
    # from above instead, so p50 <= p95 <= max(t) and p95 ∈ t always hold
    # on small fleets.
    method = "higher" if t.size < 20 else "linear"
    p50, p95 = (float(x) for x in np.percentile(t, [50, 95], method=method))
    return FleetSummary(
        scenario=scenario, scheme=scheme, n_seeds=n_seeds,
        n_epochs=n_epochs,
        mean_time=float(t.mean()), std_time=float(t.std()),
        p50_time=p50, p95_time=p95,
        mean_compute_time=float(np.mean(comp)),
        mean_comm_time=float(np.mean(comm)),
        comm_fraction=float(np.mean(comm) / max(t.mean(), 1e-12)),
        mean_utilization=float(np.mean(util)),
        mean_slots=float(np.mean(slots)),
        decode_failure_rate=failures / max(len(results), 1),
        mean_stragglers=float(np.mean(strag)),
        jain_fairness=fleet_fairness(results),
        mean_queue_residual=mean_queue_residual(results),
        noop_steps=failures)


def run_fleet(scenario, scheme: str = "two-stage", *,
              n_seeds: int = 8, n_epochs: int = 3, base_seed: int = 0,
              engine: str = "batched",
              telemetry: Optional[FleetRecorder] = None,
              device="cuda", **overrides) -> FleetSummary:
    """Monte-Carlo fleet: ``n_seeds`` clusters × ``n_epochs`` epochs.

    Thin wrapper over the :class:`~repro_torch.sim.fleet.Fleet` facade, kept
    for its established signature.  ``scenario`` is a
    :class:`~repro_torch.sim.spec.ScenarioSpec`; ``**overrides`` are validated
    spec-field overrides.  ``engine`` is any of
    :data:`~repro_torch.sim.fleet.ENGINES`; all engines draw the same tapes
    and produce the same results.

    ``telemetry`` optionally threads a
    :class:`~repro_torch.telemetry.recorder.FleetRecorder` through whichever
    engine runs (per-slot series, phase spans, epoch events); ``None``
    (default) takes the exact telemetry-free code path.  The fleet runs
    on ``device``: the card unless the caller asks for ``"cpu"``.
    """
    if n_seeds < 1 or n_epochs < 1:
        raise ValueError(f"need n_seeds >= 1 and n_epochs >= 1, got "
                         f"n_seeds={n_seeds}, n_epochs={n_epochs}")
    run = Fleet(scenario, **overrides).run(
        scheme, fleet_seeds(n_seeds, base_seed), n_epochs=n_epochs,
        engine=engine, telemetry=telemetry, device=device)
    return run.summary()


def run_experiment(exp: ExperimentSpec, *, engine: str = "batched",
                   device="cuda") -> FleetSummary:
    """Run one declarative grid cell — the spec-native ``run_fleet``."""
    return run_fleet(exp.scenario, exp.scheme, n_seeds=exp.n_seeds,
                     n_epochs=exp.n_epochs, base_seed=exp.base_seed,
                     engine=engine, device=device)


def compare_schemes(scenario, schemes: Optional[Sequence[str]] = None,
                    **kwargs) -> dict:
    """All schemes under one scenario/seed list → {scheme: FleetSummary}.
    ``scenario`` is a ScenarioSpec; ``kwargs`` go to :func:`run_fleet`
    (``n_seeds``, ``n_epochs``, ``engine``, ``device``, …)."""
    spec = resolve_scenario(scenario)
    return {s: run_fleet(spec, scheme=s, **kwargs)
            for s in (schemes or SCHEMES)}
