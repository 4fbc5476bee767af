"""Grid sweeps that share one chunk runner per structural group.

The torch port of ``repro.sim.sweep``.  A sweep grid is a sequence of
:class:`~repro_torch.sim.spec.ExperimentSpec` cells (scenario × scheme × seeds × epochs).  Cells whose *structural
signature* matches — same worker count ``M``, same scheme topology, same
channel model *kind* — are stacked along the batched engine's fleet axis
and run through **one** :class:`~repro_torch.sim.batched.BatchedFleet`,
so the whole group builds one chunk runner instead of one per cell.
Everything else about a cell's physics — comm scalars, payload sizes,
channel parameters, energy model — enters the scan as stacked per-lane
parameter rows (``repro_torch.sim.batched.stack_fleet_physics``), so a whole
scenario × scheme × override grid typically collapses to a handful of
structural groups.
Results are unstacked into per-cell :class:`FleetSummary` rows that are
bit-identical to running each cell alone with
``run_fleet(engine="batched")``:

  * every lane draws from its own per-seed :class:`CommTape`, and the
    chunk runner never mixes lanes, so a lane's epoch results do not
    depend on which other lanes share the batch;
  * a group runs ``max(n_epochs)`` epochs — a cell wanting fewer epochs
    just has its later epochs dropped (extra epochs only advance that
    lane's private RNG stream, never the kept results);
  * cells are summarized with the same seed-major reduction
    (:func:`~repro_torch.sim.montecarlo.summarize_fleet`) ``run_fleet`` uses.

The sharing contract is asserted in ``tests/test_torch_sweep.py``
against :func:`~repro_torch.sim.batched.scan_trace_count`: a grouped sweep
builds at most one chunk runner per compatibility group (groups of equal
fleet shape and channel kind even share one).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from repro_torch.sim.batched import BatchedFleet
from repro_torch.sim.fleet import validate_engine
from repro_torch.sim.montecarlo import FleetSummary, run_experiment, \
    summarize_fleet
from repro_torch.sim.spec import ExperimentSpec, build_cluster

__all__ = ["compat_key", "plan_groups", "sweep"]


def compat_key(exp: ExperimentSpec) -> Tuple:
    """Hashable *structural* signature of a grid cell.

    Two cells with equal keys satisfy ``BatchedFleet``'s structural
    requirement — same worker count ``M``, same scheme, same channel
    model kind — and may therefore share one stacked fleet.  Everything
    else (CommParams scalars, ``grad_bytes``, channel parameters of the
    shared kind, energy physics, compute physics) varies freely per lane
    inside a group and is deliberately *not* part of the key: parameter
    values ride through the chunk runner as stacked per-lane rows, so
    keying on them would only shatter the grid into needless
    runner builds.
    """
    sc = exp.scenario
    return (exp.scheme, sc.M, sc.channel.kind)


def plan_groups(grid: Sequence, *, key=None) -> List[List[int]]:
    """Partition grid-cell indices into runner-sharing groups, ordered
    by first appearance (cells keep their input order within a group).

    With the default ``key=None`` the grid must be
    :class:`ExperimentSpec` cells and :func:`compat_key` is the
    signature; passing ``key=`` generalizes the same partition to other
    cell types with their own structural signature — the soak grids of
    ``repro_torch.sim.policy`` group their lanes through here with
    ``key=soak_compat_key``.
    """
    keyfn = compat_key if key is None else key
    groups: Dict[Tuple, List[int]] = {}
    for i, exp in enumerate(grid):
        if key is None and not isinstance(exp, ExperimentSpec):
            raise TypeError(f"grid[{i}] is {type(exp).__name__}, "
                            f"expected ExperimentSpec")
        groups.setdefault(keyfn(exp), []).append(i)
    return list(groups.values())


def sweep(grid: Sequence[ExperimentSpec], *, engine: str = "batched",
          device="cuda") -> List[FleetSummary]:
    """Run every grid cell, one :class:`FleetSummary` per cell in input
    order, on ``device`` (the card unless the caller asks for ``"cpu"``).
    With the default batched engine, structurally compatible cells are
    stacked into one fleet per group — compute and comm phases both
    batched over the stacked lanes (lanes that differ in compute physics
    fall into separate *compute groups* inside
    ``repro_torch.sim.batched_compute`` but still share the one chunk
    runner); ``engine="hybrid"`` stacks the same fleets with the per-seed
    host compute loop; ``engine="oracle"`` runs each cell through the
    event-driven loop instead (the differential baseline);
    ``engine="device"`` stacks the same fleets as ``"batched"`` and keeps
    the stop state machine in the chunk loop's carry
    (``repro_torch.sim.device_epoch``)."""
    grid = list(grid)
    groups = plan_groups(grid)      # also validates cell types, any engine
    validate_engine(engine)
    if engine == "oracle":
        return [run_experiment(exp, engine=engine, device=device)
                for exp in grid]
    rows: Dict[int, FleetSummary] = {}
    for idxs in groups:
        cells = [grid[i] for i in idxs]
        clusters = [build_cluster(c.scenario, c.scheme, seed,
                                  device=device)
                    for c in cells for seed in c.seeds]
        fleet = BatchedFleet(clusters=clusters, device=device,
                             compute=("host" if engine == "hybrid"
                                      else "batched"),
                             tail=("device" if engine == "device"
                                   else "host"))
        per_epoch = fleet.run(max(c.n_epochs for c in cells))
        lane = 0
        for i, cell in zip(idxs, cells):
            # seed-major unstack, exactly run_fleet's reduction order
            results = [per_epoch[e][lane + j]
                       for j in range(cell.n_seeds)
                       for e in range(cell.n_epochs)]
            rows[i] = summarize_fleet(cell.scenario.name, cell.scheme,
                                      cell.n_seeds, cell.n_epochs, results)
            lane += cell.n_seeds
    # plan_groups partitions the index range; assert full coverage so a
    # grouping bug surfaces here as a hard error, never as a None row
    assert len(rows) == len(grid) and all(i in rows for i in range(len(grid)))
    return [rows[i] for i in range(len(grid))]
