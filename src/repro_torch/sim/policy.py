"""Lyapunov policy search: V / θ / D grids → throughput–fairness
frontiers, in torch.

The torch port of ``repro.sim.policy``.  The soak harness
(``repro_torch.sim.soak``) measures one operating point; this layer
sweeps the scheduler's control knobs — the Lyapunov ``V`` (through
``ScenarioSpec.with_overrides(V=...)``), the P6/P7 energy perturbation
``theta_frac`` and the arrival scale ``D_scale`` — across scenarios, and
reduces each scenario's grid to its throughput–fairness frontier.

Grouping rides the sweep machinery: :func:`~repro_torch.sim.sweep.
plan_groups` partitions the grid with
:func:`~repro_torch.sim.soak.soak_compat_key` as the structural
signature, so every table-channel scenario × knob cell of one worker
count runs in one stacked soak loop (Gilbert–Elliott cells form another
group).  All cells share one common-random-numbers seed, so a scenario's
V-grid points are paired comparisons.

``frontier_dict`` emits the reference's ``lyapunov-frontier/v1`` schema
(``benchmarks/baselines/BENCH_lyapunov_frontier.json``)::

    {"schema": "lyapunov-frontier/v1", "n_slots": ..., "warmup": ...,
     "scenarios": {name: {
         "points": [{"V", "theta_frac", "D_scale", "throughput", "jain",
                     "mean_qtot", "max_Q", "mean_H", "drift_slope",
                     "drift_ratio", "utility", "capacity", "pareto"}],
         "max_throughput": ..., "max_jain": ..., "max_drift_ratio": ...,
         "max_mean_qtot": ...}}}
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.sim.soak import (DEFAULT_CHUNK, SoakLane, lane_capacity,
                                  run_soak, soak_compat_key)
from repro_torch.sim.spec import ScenarioSpec
from repro_torch.sim.sweep import plan_groups

__all__ = ["PolicyCell", "PolicyPoint", "policy_grid", "policy_search",
           "pareto_mask", "frontier_dict", "DEFAULT_V_GRID"]

#: Default Lyapunov-V grid: log-spaced around the registry scenarios'
#: V = 50, wide enough that both ends of the backlog–utility trade-off
#: show.
DEFAULT_V_GRID = (5.0, 20.0, 80.0, 320.0)


@dataclasses.dataclass(frozen=True)
class PolicyCell:
    """One policy-grid cell: a scenario at one (V, θ-fraction, D-scale)
    knob setting.  ``V`` overrides the scenario's ``comm.V``."""
    scenario: ScenarioSpec
    V: float
    theta_frac: float = 0.5
    D_scale: float = 1.0
    load: float = 1.2

    def __post_init__(self):
        if not isinstance(self.scenario, ScenarioSpec):
            raise TypeError(f"PolicyCell.scenario wants a ScenarioSpec, "
                            f"got {type(self.scenario).__name__}")
        if self.V <= 0.0:
            raise ValueError(f"V must be positive, got {self.V}")

    @property
    def lane(self) -> SoakLane:
        """The soak lane this cell resolves to (V baked into the spec)."""
        return SoakLane(
            scenario=self.scenario.with_overrides(V=float(self.V)),
            theta_frac=self.theta_frac, D_scale=self.D_scale,
            load=self.load)


@dataclasses.dataclass(frozen=True)
class PolicyPoint:
    """One measured operating point: the cell plus its steady-state
    estimates (see :class:`~repro_torch.sim.soak.SoakResult`).
    ``pareto`` marks membership of the scenario's throughput–fairness
    frontier (no other grid point dominates it on both axes)."""
    cell: PolicyCell
    throughput: float
    jain: float
    mean_qtot: float
    max_Q: float
    mean_H: float
    drift_slope: float
    drift_ratio: float
    utility: float
    capacity: float
    pareto: bool = False

    def to_dict(self) -> dict:
        return {
            "V": float(self.cell.V),
            "theta_frac": float(self.cell.theta_frac),
            "D_scale": float(self.cell.D_scale),
            "throughput": self.throughput, "jain": self.jain,
            "mean_qtot": self.mean_qtot, "max_Q": self.max_Q,
            "mean_H": self.mean_H, "drift_slope": self.drift_slope,
            "drift_ratio": self.drift_ratio, "utility": self.utility,
            "capacity": self.capacity, "pareto": self.pareto,
        }


def policy_grid(scenarios: Sequence[ScenarioSpec],
                V_grid: Sequence[float] = DEFAULT_V_GRID,
                theta_grid: Sequence[float] = (0.5,),
                D_grid: Sequence[float] = (1.0,), *,
                load: float = 1.2) -> List[PolicyCell]:
    """The full scenario × V × θ × D product, scenario-major so a
    scenario's cells stay adjacent in the emitted frontier."""
    return [PolicyCell(scenario=sc, V=float(V), theta_frac=float(th),
                       D_scale=float(ds), load=load)
            for sc in scenarios for V in V_grid for th in theta_grid
            for ds in D_grid]


def policy_search(cells: Sequence[PolicyCell], n_slots: int, *,
                  warmup: Optional[int] = None, chunk: int = DEFAULT_CHUNK,
                  seed: int = 0, device="cuda") -> List[PolicyPoint]:
    """Soak every grid cell on ``device`` (the card unless the caller asks
    for ``"cpu"``), one :class:`PolicyPoint` per cell in input order.
    Cells are partitioned with ``plan_groups(key=soak_compat_key)`` and
    each group runs as one stacked :func:`~repro_torch.sim.soak.run_soak`;
    pareto membership is then marked per scenario name."""
    cells = list(cells)
    for i, c in enumerate(cells):
        if not isinstance(c, PolicyCell):
            raise TypeError(f"cells[{i}] is {type(c).__name__}, "
                            f"expected PolicyCell")
    lanes = [c.lane for c in cells]
    points: Dict[int, PolicyPoint] = {}
    for idxs in plan_groups(lanes, key=soak_compat_key):
        group = [lanes[i] for i in idxs]
        res = run_soak(group, n_slots, warmup=warmup, chunk=chunk,
                       seed=seed, device=device)
        caps = lane_capacity(group)
        for j, i in enumerate(idxs):
            points[i] = PolicyPoint(
                cell=cells[i],
                throughput=float(res.throughput[j]),
                jain=float(res.jain[j]),
                mean_qtot=float(res.mean_qtot[j]),
                max_Q=float(res.max_Q[j].max()),
                mean_H=float(res.mean_H[j].sum()),
                drift_slope=float(res.drift_slope[j]),
                drift_ratio=float(res.drift_ratio[j]),
                utility=float(res.utility[j]),
                capacity=float(caps[j]))
    assert len(points) == len(cells)
    ordered = [points[i] for i in range(len(cells))]
    # pareto marking per scenario (the *base* scenario name: V/θ/D vary)
    by_name: Dict[str, List[int]] = {}
    for i, p in enumerate(ordered):
        by_name.setdefault(p.cell.scenario.name, []).append(i)
    for idxs in by_name.values():
        mask = pareto_mask(
            np.asarray([[ordered[i].throughput, ordered[i].jain]
                        for i in idxs]))
        for on, i in zip(mask, idxs):
            ordered[i] = dataclasses.replace(ordered[i], pareto=bool(on))
    return ordered


def pareto_mask(xy: np.ndarray) -> np.ndarray:
    """Boolean mask of the maximize-both pareto frontier of (n, 2) points:
    ``True`` where no other point is >= on both axes and > on at least
    one."""
    xy = np.asarray(xy, np.float64)
    n = xy.shape[0]
    mask = np.ones(n, bool)
    for i in range(n):
        ge = (xy >= xy[i]).all(axis=1)
        gt = (xy > xy[i]).any(axis=1)
        mask[i] = not (ge & gt).any()
    return mask


def frontier_dict(points: Sequence[PolicyPoint], *, n_slots: int,
                  warmup: int) -> dict:
    """Reduce measured points to the frontier artifact (module docstring
    schema)."""
    scenarios: Dict[str, dict] = {}
    for p in points:
        scenarios.setdefault(p.cell.scenario.name,
                             {"points": []})["points"].append(p.to_dict())
    for row in scenarios.values():
        pts = row["points"]
        row["max_throughput"] = max(q["throughput"] for q in pts)
        row["max_jain"] = max(q["jain"] for q in pts)
        row["max_drift_ratio"] = max(q["drift_ratio"] for q in pts)
        row["max_mean_qtot"] = max(q["mean_qtot"] for q in pts)
    return {"schema": "lyapunov-frontier/v1", "n_slots": int(n_slots),
            "warmup": int(warmup), "scenarios": scenarios}
