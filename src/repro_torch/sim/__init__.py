"""Event-driven edge-cluster co-simulator and its batched fleet engines,
ported to torch.

Couples the two-stage coded computing phase (paper §3) with the fair
Lyapunov-scheduled transmission phase (paper §4) inside one epoch:
stage-1 coded compute → deadline → stage-2 planning → per-slot
drift-plus-penalty uplink of each worker's partial-gradient bytes → decode
once enough coded contributions have *arrived* (not merely been computed).

A scenario is a frozen :class:`ScenarioSpec`, resolved into a live
cluster by :func:`build_cluster`.  :class:`EdgeCluster` is the per-seed
event-driven oracle; :class:`BatchedFleet` runs a whole fleet of seeds
(and of stacked scenario cells, :func:`sweep`) through one chunk loop on
the card.  The front door is :class:`Fleet`:
``Fleet(spec).run(scheme, seeds, engine=...)`` dispatches the engines in
:data:`ENGINES` — including ``"device"``, which keeps the epoch's stop
state machine on the card (``device_epoch``) — with :func:`run_fleet`
and :func:`compare_schemes` as wrappers.  :func:`run_soak` runs the
scheduler alone for many slots (``soak``), and :func:`policy_search`
sweeps its V/θ/D knobs into throughput–fairness frontiers (``policy``).
The reference's ``shard_map`` over a device mesh has no counterpart: one
card batches every lane.
"""
from .events import COMPUTE_DONE, SLOT_TICK, Event, EventEngine
from .channel import (ChannelModel, CommTape, GilbertElliottChannel,
                      StaticChannel, TraceChannel)
from .cluster import SCHEMES, CommJob, CommParams, CommStats, EdgeCluster
from .spec import (ChannelSpec, CommSpec, ComputeSpec, EnergySpec,
                   ExperimentSpec, GilbertElliottChannelSpec, ScenarioSpec,
                   StaticChannelSpec, TraceChannelSpec, as_channel_spec,
                   build_cluster, split_comm_params)
from .scenarios import (SCENARIOS, available_scenarios, register_scenario,
                        resolve_scenario, scenario_spec)
from .batched import (BatchedFleet, pick_chunk, reset_scan_compile_cache,
                      run_fleet_batched, scan_trace_count)
from .fleet import ENGINES, Fleet, FleetRun, validate_engine
from .batched_compute import (batched_comm_jobs, batched_compute_phase,
                              compute_group_key)
from .montecarlo import (FleetSummary, compare_schemes, run_experiment,
                         run_fleet, summarize_fleet)
from .sweep import compat_key, plan_groups, sweep
from .soak import (SoakLane, SoakResult, run_soak, soak_compat_key,
                   soak_observations)
from .policy import (PolicyCell, PolicyPoint, frontier_dict, policy_grid,
                     policy_search)

__all__ = [
    "COMPUTE_DONE", "SLOT_TICK", "Event", "EventEngine",
    "ChannelModel", "CommTape", "GilbertElliottChannel", "StaticChannel",
    "TraceChannel", "SCHEMES", "CommJob", "CommParams", "CommStats",
    "EdgeCluster", "ChannelSpec", "CommSpec", "ComputeSpec", "EnergySpec",
    "ExperimentSpec", "GilbertElliottChannelSpec", "ScenarioSpec",
    "StaticChannelSpec", "TraceChannelSpec", "as_channel_spec",
    "build_cluster", "split_comm_params", "SCENARIOS",
    "available_scenarios", "register_scenario", "resolve_scenario",
    "scenario_spec",
    "BatchedFleet", "pick_chunk", "run_fleet_batched", "scan_trace_count",
    "reset_scan_compile_cache",
    "ENGINES", "Fleet", "FleetRun", "validate_engine",
    "batched_comm_jobs", "batched_compute_phase", "compute_group_key",
    "FleetSummary", "run_fleet", "run_experiment", "compare_schemes",
    "summarize_fleet",
    "compat_key", "plan_groups", "sweep",
    "SoakLane", "SoakResult", "run_soak", "soak_compat_key",
    "soak_observations",
    "PolicyCell", "PolicyPoint", "frontier_dict", "policy_grid",
    "policy_search",
]
