"""Declarative experiment specs: scenarios as data, not closures.

A copy of ``repro.sim.spec`` as plain frozen dataclasses (the reference
also registers each class as a static jax pytree node, which the port does
not need).  JSON round-trips are identical to the reference's.

The co-simulator's experiment surface is a small algebra of frozen,
hashable dataclasses:

    ComputeSpec   — compute-phase heterogeneity (rates, stragglers, stage-2
                    sizing) for ``build_epoch_backend``
    ChannelSpec   — one of :class:`StaticChannelSpec`,
                    :class:`GilbertElliottChannelSpec`,
                    :class:`TraceChannelSpec`; builds the matching
                    ``repro_torch.sim.channel`` model
    EnergySpec    — battery/harvest physics (the energy half of CommParams)
    CommSpec      — uplink physics and scheduler knobs (the other half)
    ScenarioSpec  — M, K + the four physics specs above
    ExperimentSpec— ScenarioSpec × scheme × seeds × epochs: one grid cell

Because a spec is plain data it can be stored (``to_json``/``from_json``
round-trip, golden-tested per registry scenario), hashed and compared.
``build_cluster(spec, scheme=..., seed=..., device=...)`` is the single
resolver from spec to a live :class:`~repro_torch.sim.cluster.EdgeCluster`.

Overrides are validated: any unknown field name raises ``ValueError``
listing the valid fields, instead of being silently dropped.  Flat
override keys are routed to the owning sub-spec (``rates`` → compute,
``grad_bytes`` → comm, ``tx_power`` → energy, …), so
``spec.with_overrides(grad_bytes=16.0)`` is how sweep grids vary one
physics axis.
"""
from __future__ import annotations

import dataclasses
import json
from typing import ClassVar, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.sim.channel import (ChannelModel, GilbertElliottChannel,
                                     StaticChannel, TraceChannel)
from repro_torch.sim.cluster import SCHEMES, CommParams, EdgeCluster

__all__ = [
    "ComputeSpec", "ChannelSpec", "StaticChannelSpec",
    "GilbertElliottChannelSpec", "TraceChannelSpec", "EnergySpec",
    "CommSpec", "ScenarioSpec", "ExperimentSpec", "build_cluster",
    "as_channel_spec", "split_comm_params", "fleet_seeds",
]


def fleet_seeds(n_seeds: int, base_seed: int) -> Tuple[int, ...]:
    """The fleet seed schedule of ``ExperimentSpec.seeds`` (the
    reference's ``run_fleet`` uses the same one)."""
    return tuple(base_seed + 1000 * i for i in range(n_seeds))


def _float_tuple(x) -> Tuple[float, ...]:
    return tuple(float(v) for v in np.asarray(x, np.float64).ravel())


def _set(obj, name, value) -> None:
    object.__setattr__(obj, name, value)    # frozen-dataclass normalization


# --------------------------------------------------------------------- #
# compute phase
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ComputeSpec:
    """Compute-phase physics: worker heterogeneity and stage-2 sizing.

    ``rates=None`` means equal unit rates; ``M1=None`` means the default
    stage-1 size ``max(M // 2 + 1, 1)``.
    """
    rates: Optional[Tuple[float, ...]] = None
    noise_scale: float = 0.2
    fault_prob: float = 0.0
    straggler_prob: float = 0.0
    straggler_slow: float = 8.0
    deadline_quantile: float = 0.9
    M1: Optional[int] = None
    s: int = 1
    select: str = "rotate"
    n_slots: Optional[int] = None

    def __post_init__(self):
        if self.rates is not None:
            _set(self, "rates", _float_tuple(self.rates))


# --------------------------------------------------------------------- #
# channel variants
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class _ChannelSpecBase:
    kind: ClassVar[str]

    @property
    def n_workers(self) -> int:
        raise NotImplementedError

    def build(self) -> ChannelModel:
        raise NotImplementedError

    def to_dict(self) -> dict:
        d = {"kind": self.kind}
        d.update(dataclasses.asdict(self))
        return d


@dataclasses.dataclass(frozen=True)
class StaticChannelSpec(_ChannelSpecBase):
    """Time-invariant per-worker uplink rates."""
    kind: ClassVar[str] = "static"
    rates: Tuple[float, ...] = ()

    def __post_init__(self):
        _set(self, "rates", _float_tuple(self.rates))

    @property
    def n_workers(self) -> int:
        return len(self.rates)

    def build(self) -> StaticChannel:
        return StaticChannel(np.asarray(self.rates, np.float64))


@dataclasses.dataclass(frozen=True)
class GilbertElliottChannelSpec(_ChannelSpecBase):
    """Two-state Markov fading (good/bad rate per worker)."""
    kind: ClassVar[str] = "gilbert-elliott"
    rate_good: Tuple[float, ...] = ()
    rate_bad: Tuple[float, ...] = ()
    p_gb: float = 0.1
    p_bg: float = 0.3
    start_good: bool = True

    def __post_init__(self):
        good = _float_tuple(self.rate_good)
        bad = _float_tuple(self.rate_bad)
        if len(bad) == 1 and len(good) > 1:
            bad = bad * len(good)
        if len(bad) != len(good):
            raise ValueError(f"rate_bad has {len(bad)} entries, "
                             f"rate_good has {len(good)}")
        _set(self, "rate_good", good)
        _set(self, "rate_bad", bad)

    @property
    def n_workers(self) -> int:
        return len(self.rate_good)

    def build(self) -> GilbertElliottChannel:
        return GilbertElliottChannel(
            rate_good=np.asarray(self.rate_good, np.float64),
            rate_bad=np.asarray(self.rate_bad, np.float64),
            p_gb=self.p_gb, p_bg=self.p_bg, start_good=self.start_good)


@dataclasses.dataclass(frozen=True)
class TraceChannelSpec(_ChannelSpecBase):
    """Trace-driven rates: row t of the trace is slot t's rate vector."""
    kind: ClassVar[str] = "trace"
    trace: Tuple[Tuple[float, ...], ...] = ()
    loop: bool = True

    def __post_init__(self):
        rows = np.atleast_2d(np.asarray(self.trace, np.float64))
        _set(self, "trace", tuple(_float_tuple(r) for r in rows))

    @property
    def n_workers(self) -> int:
        return len(self.trace[0]) if self.trace else 0

    def build(self) -> TraceChannel:
        return TraceChannel(np.asarray(self.trace, np.float64),
                            loop=self.loop)


ChannelSpec = Union[StaticChannelSpec, GilbertElliottChannelSpec,
                    TraceChannelSpec]

_CHANNEL_KINDS = {cls.kind: cls for cls in
                  (StaticChannelSpec, GilbertElliottChannelSpec,
                   TraceChannelSpec)}


def _channel_from_dict(d: dict) -> ChannelSpec:
    d = dict(d)
    kind = d.pop("kind", None)
    try:
        cls = _CHANNEL_KINDS[kind]
    except KeyError:
        raise ValueError(f"unknown channel kind {kind!r}; "
                         f"valid: {sorted(_CHANNEL_KINDS)}") from None
    return cls(**d)


def as_channel_spec(channel) -> ChannelSpec:
    """Coerce a ChannelSpec or a live ChannelModel into a ChannelSpec
    (the inverse of ``ChannelSpec.build`` for the shipped models)."""
    if isinstance(channel, _ChannelSpecBase):
        return channel
    if isinstance(channel, StaticChannel):
        return StaticChannelSpec(rates=tuple(channel._rates))
    if isinstance(channel, GilbertElliottChannel):
        return GilbertElliottChannelSpec(
            rate_good=tuple(channel.rate_good),
            rate_bad=tuple(channel.rate_bad),
            p_gb=channel.p_gb, p_bg=channel.p_bg,
            start_good=channel._start_good)
    if isinstance(channel, TraceChannel):
        return TraceChannelSpec(trace=tuple(map(tuple, channel.trace)),
                                loop=channel.loop)
    raise ValueError(f"cannot derive a ChannelSpec from "
                     f"{type(channel).__name__}; pass one of "
                     f"{sorted(_CHANNEL_KINDS)} specs instead")


# --------------------------------------------------------------------- #
# uplink physics — split into energy and comm halves
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class EnergySpec:
    """Battery and harvest physics (paper §III.3 energy symbols)."""
    tx_power: float = 0.5
    E0: float = 5.0
    E_cap: float = 10.0
    harvest_mean: float = 0.5
    harvest_jitter: float = 0.5
    delta: float = 1e-3


@dataclasses.dataclass(frozen=True)
class CommSpec:
    """Uplink payload/slotting physics and Lyapunov scheduler knobs.

    ``grad_bytes`` is a scalar payload or a per-worker tuple.
    """
    grad_bytes: Union[float, Tuple[float, ...]] = 1.0
    slot_T: float = 0.1
    n_subchannels: float = 2.0
    V: float = 50.0
    xi: float = 0.01
    F: float = 100.0
    f_max: float = 100.0
    max_slots: int = 5000

    def __post_init__(self):
        gb = self.grad_bytes
        if isinstance(gb, (tuple, list, np.ndarray)):
            _set(self, "grad_bytes", _float_tuple(gb))
        else:
            _set(self, "grad_bytes", float(gb))


def _comm_params(comm: CommSpec, energy: EnergySpec) -> CommParams:
    gb = comm.grad_bytes
    if isinstance(gb, tuple):
        gb = np.asarray(gb, np.float64)
    return CommParams(
        grad_bytes=gb, slot_T=comm.slot_T,
        n_subchannels=comm.n_subchannels, V=comm.V,
        tx_power=energy.tx_power, E0=energy.E0, E_cap=energy.E_cap,
        harvest_mean=energy.harvest_mean,
        harvest_jitter=energy.harvest_jitter,
        xi=comm.xi, F=comm.F, f_max=comm.f_max, delta=energy.delta,
        max_slots=comm.max_slots)


def split_comm_params(cp: CommParams) -> Tuple[CommSpec, EnergySpec]:
    """Split a legacy ``CommParams`` into its (CommSpec, EnergySpec)."""
    gb = cp.grad_bytes
    gb = _float_tuple(gb) if isinstance(gb, np.ndarray) else float(gb)
    return (CommSpec(grad_bytes=gb, slot_T=cp.slot_T,
                     n_subchannels=cp.n_subchannels, V=cp.V, xi=cp.xi,
                     F=cp.F, f_max=cp.f_max, max_slots=cp.max_slots),
            EnergySpec(tx_power=cp.tx_power, E0=cp.E0, E_cap=cp.E_cap,
                       harvest_mean=cp.harvest_mean,
                       harvest_jitter=cp.harvest_jitter, delta=cp.delta))


# --------------------------------------------------------------------- #
# scenario = shape + the four physics specs
# --------------------------------------------------------------------- #
_COMPUTE_FIELDS = {f.name for f in dataclasses.fields(ComputeSpec)}
_COMM_FIELDS = {f.name for f in dataclasses.fields(CommSpec)}
_ENERGY_FIELDS = {f.name for f in dataclasses.fields(EnergySpec)}


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One named scenario: cluster shape plus compute/channel/energy/comm
    physics.  The coding scheme and seed stay free, so all four schemes
    run under identical scenario conditions."""
    name: str
    description: str = ""
    M: int = 6
    K: int = 6
    compute: ComputeSpec = ComputeSpec()
    channel: Optional[ChannelSpec] = None    # None → static 10.0 × M
    energy: EnergySpec = EnergySpec()
    comm: CommSpec = CommSpec()

    def __post_init__(self):
        if self.M < 1 or self.K < 1:
            raise ValueError(f"need M >= 1 and K >= 1, got "
                             f"M={self.M}, K={self.K}")
        # sub-spec types are enforced here so every construction path —
        # direct, with_overrides, from_dict — yields a serializable spec
        for field, want in (("compute", ComputeSpec), ("energy", EnergySpec),
                            ("comm", CommSpec)):
            if not isinstance(getattr(self, field), want):
                raise TypeError(
                    f"{field}= wants a {want.__name__}, got "
                    f"{type(getattr(self, field)).__name__}"
                    + (" (pass it as comm= to have it split)"
                       if isinstance(getattr(self, field), CommParams)
                       and field != "comm" else ""))
        if self.channel is None:
            _set(self, "channel", StaticChannelSpec(rates=(10.0,) * self.M))
        elif not isinstance(self.channel, _ChannelSpecBase):
            raise TypeError(f"channel= wants a ChannelSpec, got "
                            f"{type(self.channel).__name__}")
        # catch shape mismatches where the spec is built, not deep inside
        # a later build_cluster call
        if self.channel.n_workers != self.M:
            raise ValueError(
                f"channel spec covers {self.channel.n_workers} workers, "
                f"scenario has M={self.M}")
        if (self.compute.rates is not None
                and len(self.compute.rates) != self.M):
            raise ValueError(
                f"compute.rates has {len(self.compute.rates)} entries, "
                f"scenario has M={self.M}")

    # -- validated overrides ------------------------------------------- #
    def with_overrides(self, **over) -> "ScenarioSpec":
        """Return a copy with override values applied.

        Accepts top-level fields (``M``, ``K``, ``name``, ``description``,
        whole sub-specs via ``compute=``/``channel=``/``energy=``/
        ``comm=``) and flat sub-spec fields routed to their owner
        (``rates`` → compute, ``grad_bytes`` → comm, ``tx_power`` →
        energy, …).  ``channel=`` also accepts a live ChannelModel and
        ``comm=`` a legacy CommParams (split into comm + energy).
        Unknown keys raise ``ValueError`` with the valid field list.

        The derived spec keeps this spec's ``name`` unless overridden —
        when sweeping along a physics axis, pass ``name=`` too so the
        per-cell ``FleetSummary`` rows stay distinguishable.
        """
        top: dict = {}
        comp: dict = {}
        comm: dict = {}
        energy: dict = {}
        valid = (sorted({"name", "description", "M", "K", "compute",
                         "channel", "energy", "comm"}
                        | _COMPUTE_FIELDS | _COMM_FIELDS | _ENERGY_FIELDS))
        for key, val in over.items():
            if key == "channel":
                top["channel"] = as_channel_spec(val)
            elif key == "comm":
                if isinstance(val, CommParams):
                    if "energy" in over:
                        # a CommParams carries the energy fields too —
                        # letting an explicit energy= also apply would
                        # make the result kwarg-order-dependent
                        raise ValueError(
                            "comm=CommParams conflicts with an explicit "
                            "energy= override; pass comm=CommSpec instead")
                    top["comm"], top["energy"] = split_comm_params(val)
                else:
                    top["comm"] = val
            elif key in ("name", "description", "M", "K", "compute",
                         "energy"):
                top[key] = val
            elif key in _COMPUTE_FIELDS:
                comp[key] = val
            elif key in _COMM_FIELDS:
                comm[key] = val
            elif key in _ENERGY_FIELDS:
                energy[key] = val
            else:
                raise ValueError(
                    f"unknown scenario override {key!r}; valid fields: "
                    f"{valid}")
        # merge everything first and construct once, so consistency is
        # validated against the final state only (e.g. M together with a
        # matching rates/channel resize is one legal override set)
        fields = {f.name: getattr(self, f.name)
                  for f in dataclasses.fields(self)}
        fields.update(top)
        for name, sub in (("compute", comp), ("comm", comm),
                          ("energy", energy)):
            if sub:
                fields[name] = dataclasses.replace(fields[name], **sub)
        return type(self)(**fields)

    # -- serialization -------------------------------------------------- #
    def to_dict(self) -> dict:
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self)}
        d["compute"] = dataclasses.asdict(self.compute)
        d["channel"] = self.channel.to_dict()   # carries the kind tag
        d["energy"] = dataclasses.asdict(self.energy)
        d["comm"] = dataclasses.asdict(self.comm)
        return d

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioSpec":
        d = dict(d)
        if "compute" in d:
            d["compute"] = ComputeSpec(**d["compute"])
        if "channel" in d:
            d["channel"] = _channel_from_dict(d["channel"])
        if "energy" in d:
            d["energy"] = EnergySpec(**d["energy"])
        if "comm" in d:
            d["comm"] = CommSpec(**d["comm"])
        return cls(**d)

    @classmethod
    def from_json(cls, text: str) -> "ScenarioSpec":
        return cls.from_dict(json.loads(text))


# --------------------------------------------------------------------- #
# experiment = one grid cell
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One sweep-grid cell: a scenario under one scheme, a seed fleet and
    an epoch count.  ``seeds`` reproduces ``run_fleet``'s seed list, so a
    cell names exactly the work ``run_fleet(scenario, scheme, ...)``
    would run."""
    scenario: ScenarioSpec
    scheme: str = "two-stage"
    n_seeds: int = 8
    n_epochs: int = 3
    base_seed: int = 0

    def __post_init__(self):
        if not isinstance(self.scenario, ScenarioSpec):
            raise TypeError(
                f"ExperimentSpec.scenario wants a ScenarioSpec, got "
                f"{type(self.scenario).__name__}; resolve registry names "
                f"with repro_torch.sim.scenario_spec(name) first")
        if self.scheme not in SCHEMES:
            raise ValueError(f"scheme must be one of {SCHEMES}, "
                             f"got {self.scheme!r}")
        if self.n_seeds < 1 or self.n_epochs < 1:
            raise ValueError(f"need n_seeds >= 1 and n_epochs >= 1, got "
                             f"n_seeds={self.n_seeds}, "
                             f"n_epochs={self.n_epochs}")

    @property
    def seeds(self) -> Tuple[int, ...]:
        return fleet_seeds(self.n_seeds, self.base_seed)


# --------------------------------------------------------------------- #
# the single resolver: spec -> live cluster
# --------------------------------------------------------------------- #
def build_cluster(spec: ScenarioSpec, scheme: str = "two-stage",
                  seed: int = 0, *, device="cuda") -> EdgeCluster:
    """Build an :class:`EdgeCluster` from a :class:`ScenarioSpec` for one
    (scheme, seed) — the one path from declarative specs to live physics.
    The scheduler runs on ``device``: the card unless the caller asks for
    ``"cpu"``."""
    if not isinstance(spec, ScenarioSpec):
        raise TypeError(f"build_cluster wants a ScenarioSpec, got "
                        f"{type(spec).__name__}; resolve registry names "
                        f"with repro_torch.sim.scenario_spec(name) first")
    c = spec.compute
    rates = (np.asarray(c.rates, np.float64) if c.rates is not None
             else np.ones(spec.M))
    M1 = c.M1 if c.M1 is not None else max(spec.M // 2 + 1, 1)
    return EdgeCluster(
        spec.M, spec.K, scheme=scheme, M1=M1, s=c.s, rates=rates,
        noise_scale=c.noise_scale, fault_prob=c.fault_prob,
        straggler_prob=c.straggler_prob, straggler_slow=c.straggler_slow,
        deadline_quantile=c.deadline_quantile,
        channel=spec.channel.build(),
        comm=_comm_params(spec.comm, spec.energy),
        n_slots=c.n_slots, seed=seed, select=c.select, device=device)
