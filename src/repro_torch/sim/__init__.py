"""Event-driven edge-cluster co-simulator, ported to torch.

Couples the two-stage coded computing phase (paper §3) with the fair
Lyapunov-scheduled transmission phase (paper §4) inside one epoch:
stage-1 coded compute → deadline → stage-2 planning → per-slot
drift-plus-penalty uplink of each worker's partial-gradient bytes → decode
once enough coded contributions have *arrived* (not merely been computed).

A scenario is a frozen :class:`ScenarioSpec`, resolved into a live
cluster by :func:`build_cluster`.  The reference's batched fleet engines
are not ported yet; :class:`EdgeCluster` is the one engine here.
"""
from .events import COMPUTE_DONE, SLOT_TICK, Event, EventEngine
from .channel import (ChannelModel, CommTape, GilbertElliottChannel,
                      StaticChannel, TraceChannel)
from .cluster import SCHEMES, CommJob, CommParams, CommStats, EdgeCluster
from .spec import (ChannelSpec, CommSpec, ComputeSpec, EnergySpec,
                   ExperimentSpec, GilbertElliottChannelSpec, ScenarioSpec,
                   StaticChannelSpec, TraceChannelSpec, build_cluster)
from .scenarios import (SCENARIOS, available_scenarios, register_scenario,
                        scenario_spec)

__all__ = [
    "COMPUTE_DONE", "SLOT_TICK", "Event", "EventEngine",
    "ChannelModel", "CommTape", "GilbertElliottChannel", "StaticChannel",
    "TraceChannel", "SCHEMES", "CommJob", "CommParams", "CommStats",
    "EdgeCluster", "ChannelSpec", "CommSpec", "ComputeSpec", "EnergySpec",
    "ExperimentSpec", "GilbertElliottChannelSpec", "ScenarioSpec",
    "StaticChannelSpec", "TraceChannelSpec", "build_cluster", "SCENARIOS",
    "available_scenarios", "register_scenario", "scenario_spec",
]
