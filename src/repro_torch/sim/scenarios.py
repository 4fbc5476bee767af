"""Named co-simulation scenarios as declarative data.

A copy of ``repro.sim.scenarios``: the same registry, value for value.
The registry is a typed table of :class:`~repro_torch.sim.spec.ScenarioSpec`
values — plain frozen dataclasses, not factory closures.  Each spec fixes
a cluster's compute heterogeneity, channel model and energy physics; the
coding scheme and seed stay free so all four schemes (two-stage / cyclic /
fractional / uncoded) run under identical scenario conditions.  Scenario
motivation follows the paper's "practical network conditions" evaluation
plus the heterogeneous-rate and fading settings of hierarchical gradient
coding (arXiv:2406.10831) and heterogeneous-straggler approximate coding
(arXiv:2510.22539).

    spec = scenario_spec("fading-uplink")
    res = build_cluster(spec, scheme="two-stage", seed=3).run_epoch(0)

:func:`scenario_spec` is the one name → spec lookup.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.sim.spec import (CommSpec, ComputeSpec, EnergySpec,
                                  GilbertElliottChannelSpec, ScenarioSpec,
                                  StaticChannelSpec, TraceChannelSpec)

__all__ = ["SCENARIOS", "register_scenario", "available_scenarios",
           "scenario_spec", "resolve_scenario"]

# default cluster size: the paper's 6-node edge cluster, K == M partitions
_M = 6

#: The registry — scenario name → declarative spec (data, not closures).
SCENARIOS: Dict[str, ScenarioSpec] = {}


def register_scenario(spec: ScenarioSpec) -> ScenarioSpec:
    """Add a spec to the registry under ``spec.name`` (idempotent on
    equal respecs; a conflicting re-registration raises)."""
    old = SCENARIOS.get(spec.name)
    if old is not None and old != spec:
        raise ValueError(f"scenario {spec.name!r} already registered "
                         f"with a different spec")
    SCENARIOS[spec.name] = spec
    return spec


def available_scenarios() -> List[str]:
    return sorted(SCENARIOS)


def scenario_spec(name: str) -> ScenarioSpec:
    """Registry lookup: scenario name → :class:`ScenarioSpec`."""
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"available: {available_scenarios()}") from None


def resolve_scenario(scenario: ScenarioSpec,
                     overrides: dict = None) -> ScenarioSpec:
    """Apply validated overrides to a :class:`ScenarioSpec`.

    Plain strings are rejected: callers look names up explicitly with
    ``scenario_spec(name)``.
    """
    if isinstance(scenario, str):
        raise TypeError(
            f"pass repro_torch.sim.scenario_spec({scenario!r}), "
            f"not a scenario name")
    if not isinstance(scenario, ScenarioSpec):
        raise TypeError(f"expected a ScenarioSpec, got "
                        f"{type(scenario).__name__}")
    if overrides:
        scenario = scenario.with_overrides(**overrides)
    return scenario


# --------------------------------------------------------------------- #
# the shipped registry (paper's 6-node cluster, K == M partitions)
# --------------------------------------------------------------------- #
_PAPER_RATES = (2.0, 2.0, 4.0, 4.0, 8.0, 8.0)

register_scenario(ScenarioSpec(
    name="homogeneous",
    description="Equal compute rates, equal static uplinks — the control "
                "scenario.",
    M=_M, K=_M,
    compute=ComputeSpec(rates=(4.0,) * _M, noise_scale=0.15),
    channel=StaticChannelSpec(rates=(4.0,) * _M)))

register_scenario(ScenarioSpec(
    name="heterogeneous-rates",
    description="Paper's 2/2/4/4/8/8 compute cluster plus a matching "
                "spread of uplink capacities — slow compute correlates "
                "with slow links.",
    M=_M, K=_M,
    compute=ComputeSpec(rates=_PAPER_RATES),
    channel=StaticChannelSpec(rates=(1.5, 1.5, 3.0, 3.0, 6.0, 6.0))))

register_scenario(ScenarioSpec(
    name="bursty-stragglers",
    description="1–2 random 8x stragglers per epoch (paper's straggler "
                "injection) on a healthy static network — stresses the "
                "stage-2 re-coding path.",
    M=_M, K=_M,
    compute=ComputeSpec(rates=_PAPER_RATES, straggler_prob=0.25,
                        straggler_slow=8.0),
    channel=StaticChannelSpec(rates=(4.0,) * _M)))

register_scenario(ScenarioSpec(
    name="fading-uplink",
    description="Gilbert–Elliott two-state fading: links burst between a "
                "good rate and a deep fade — stresses the arrival-gated "
                "decode.",
    M=_M, K=_M,
    compute=ComputeSpec(rates=_PAPER_RATES),
    channel=GilbertElliottChannelSpec(
        rate_good=(5.0,) * _M, rate_bad=(0.25,) * _M,
        p_gb=0.15, p_bg=0.35, start_good=False)))

register_scenario(ScenarioSpec(
    name="energy-harvesting-constrained",
    description="Tiny batteries replenished by a weak stochastic harvest; "
                "the P6/P7 perturbed energy queues make the uplink the "
                "epoch bottleneck.",
    M=_M, K=_M,
    compute=ComputeSpec(rates=_PAPER_RATES),
    channel=StaticChannelSpec(rates=(4.0,) * _M),
    energy=EnergySpec(tx_power=4.0, E0=0.2, E_cap=1.0,
                      harvest_mean=0.12, harvest_jitter=0.5)))

register_scenario(ScenarioSpec(
    name="saturated-uplink",
    description="Gradient payloads an order of magnitude above per-slot "
                "link capacity: the epoch is dominated by a long, "
                "P7-contended drain of the backlog queues — the "
                "comm-bound regime where fleet-scale sweeps live or die.",
    M=_M, K=_M,
    compute=ComputeSpec(rates=_PAPER_RATES),
    channel=StaticChannelSpec(rates=(1.5, 1.5, 3.0, 3.0, 6.0, 6.0)),
    comm=CommSpec(grad_bytes=16.0)))


def _flash_crowd_trace() -> tuple:
    rows = []
    base = (1.5, 1.5, 3.0, 3.0, 6.0, 6.0)
    for t in range(30):
        scale = 0.1 if 8 <= t < 20 else 1.0     # the crowd arrives
        rows.append(tuple(scale * r for r in base))
    return tuple(rows)


register_scenario(ScenarioSpec(
    name="flash-crowd",
    description="Trace-driven congestion: uplink capacity collapses to "
                "10% for a burst of slots mid-epoch, then recovers "
                "(cross-traffic flash crowd).",
    M=_M, K=_M,
    compute=ComputeSpec(rates=_PAPER_RATES),
    # loop=False: one-shot collapse, last (healthy) row holds afterwards
    channel=TraceChannelSpec(trace=_flash_crowd_trace(), loop=False)))
