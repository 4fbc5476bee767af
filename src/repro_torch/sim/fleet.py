"""Single front door for running co-simulated fleets.

The torch port of ``repro.sim.fleet``.  :class:`Fleet` resolves a scenario
once; :meth:`Fleet.run` runs one scheme × seed-list fleet on any engine
and returns a :class:`FleetRun`.  ``run_fleet`` and ``record_fleet`` are
thin wrappers over it.

    Fleet(spec).run("two-stage", seeds=(0, 1, 2), engine="batched")

:data:`ENGINES` is the reference's list of engine names, in its order;
every entry point validates against it through :func:`validate_engine`.
``engine="device"`` keeps the stop state machine in the chunk loop's
carry on the card (``repro_torch.sim.device_epoch``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.runtime import EpochResult
from repro_torch.sim.batched import BatchedFleet
from repro_torch.sim.scenarios import resolve_scenario
from repro_torch.sim.spec import build_cluster
from repro_torch.telemetry.recorder import FleetRecorder, TelemetryConfig

__all__ = ["ENGINES", "Fleet", "FleetRun", "validate_engine"]

#: The valid ``engine=`` names, the reference's, in its order:
#: ``batched`` — compute and comm phases batched over seeds, stop
#: tracking on the host (the default); ``device`` — the same compute
#: phase, with the stop state machine in the chunk loop's carry on the
#: device; ``hybrid`` — per-seed host compute phase + batched comm phase;
#: ``oracle`` — the event-driven per-seed reference loop.  All four draw
#: identical per-seed randomness tapes and produce identical per-epoch
#: results.
ENGINES = ("batched", "device", "hybrid", "oracle")

#: ``BatchedFleet`` knobs behind each batched-engine name.
_ENGINE_KNOBS = {"batched": {"compute": "batched", "tail": "host"},
                 "device": {"compute": "batched", "tail": "device"},
                 "hybrid": {"compute": "host", "tail": "host"}}


def validate_engine(engine: str) -> None:
    """Raise the canonical error unless ``engine`` is one of ENGINES."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")


@dataclasses.dataclass
class FleetRun:
    """One fleet run: epoch-major results plus the recorder (if any).

    ``results[epoch][lane]`` are the per-epoch
    :class:`~repro_torch.core.runtime.EpochResult`; :meth:`summary`
    reduces them to the :class:`~repro_torch.sim.montecarlo.FleetSummary`
    row exactly as ``run_fleet`` does (seed-major reduction order).
    """
    scenario: str
    scheme: str
    seeds: Tuple[int, ...]
    n_epochs: int
    engine: str
    results: List[List[EpochResult]]
    recorder: Optional[FleetRecorder] = None

    def seed_major(self) -> List[EpochResult]:
        """Flatten to the oracle's loop order: seed-major, epochs inner."""
        return [self.results[e][i] for i in range(len(self.seeds))
                for e in range(self.n_epochs)]

    def summary(self):
        from repro_torch.sim.montecarlo import summarize_fleet
        return summarize_fleet(self.scenario, self.scheme,
                               len(self.seeds), self.n_epochs,
                               self.seed_major())


class Fleet:
    """Facade over every co-sim engine for one resolved scenario.

    ``Fleet(spec, **overrides)`` resolves a
    :class:`~repro_torch.sim.spec.ScenarioSpec` (with validated field
    overrides) once; each :meth:`run` then executes one scheme × seed-list
    fleet on any engine in :data:`ENGINES`.
    """

    def __init__(self, scenario, **overrides):
        self.spec = resolve_scenario(scenario, overrides)

    def run(self, scheme: str = "two-stage",
            seeds: Sequence[int] = (0,), *, n_epochs: int = 3,
            engine: str = "batched", telemetry=None,
            chunk: Optional[int] = None, mesh=None,
            sinks: Sequence = (), device="cuda") -> FleetRun:
        """Run ``n_epochs`` epochs over ``seeds`` → :class:`FleetRun`.

        ``telemetry`` selects the observability mode: ``None`` (default)
        takes the exact telemetry-free code path; a
        :class:`~repro_torch.telemetry.recorder.FleetRecorder` is threaded
        through as-is (the caller owns meta/flush); a
        :class:`~repro_torch.telemetry.recorder.TelemetryConfig` or
        ``True`` makes this call own the recorder — run meta is stamped
        and the event stream is flushed to ``sinks``.  The fleet runs on
        ``device``: the card unless the caller asks for ``"cpu"``.
        ``mesh`` (``engine="device"`` only) raises
        ``NotImplementedError``: one card batches every lane.
        """
        validate_engine(engine)
        if n_epochs < 1 or not len(seeds):
            raise ValueError(f"need seeds and n_epochs >= 1, got "
                             f"seeds={tuple(seeds)!r}, n_epochs={n_epochs}")
        seeds = tuple(int(s) for s in seeds)
        owns_rec = telemetry is not None and not isinstance(telemetry,
                                                           FleetRecorder)
        if telemetry is None:
            rec = None
        elif isinstance(telemetry, FleetRecorder):
            rec = telemetry
        elif isinstance(telemetry, TelemetryConfig):
            rec = FleetRecorder(telemetry)
        elif telemetry is True:
            rec = FleetRecorder(TelemetryConfig())
        else:
            raise TypeError(f"telemetry must be None, True, a "
                            f"TelemetryConfig or a FleetRecorder, got "
                            f"{type(telemetry).__name__}")
        if owns_rec:
            rec.set_meta(scenario=self.spec.name, scheme=scheme,
                         engine=engine, n_seeds=len(seeds),
                         n_epochs=int(n_epochs))

        if mesh is not None and engine != "device":
            raise ValueError(f"mesh= requires engine='device' (the other "
                             f"engines never shard the seed axis), got "
                             f"engine={engine!r}")
        if engine == "oracle":
            if chunk is not None:
                raise ValueError("chunk= is a batched-engine knob; "
                                 "the oracle runs per-seed on the host")
            clusters = []
            for lane, seed in enumerate(seeds):
                c = build_cluster(self.spec, scheme, seed, device=device)
                if rec is not None:
                    c.telemetry_lane = lane
                    c.telemetry = rec
                clusters.append(c)
            results = [[c.run_epoch(e) for c in clusters]
                       for e in range(n_epochs)]
        else:
            fleet = BatchedFleet(self.spec, scheme, seeds, chunk=chunk,
                                 mesh=mesh, telemetry=rec, device=device,
                                 **_ENGINE_KNOBS[engine])
            results = fleet.run(n_epochs)
        if owns_rec:
            rec.flush(*sinks)
        return FleetRun(scenario=self.spec.name, scheme=scheme,
                        seeds=seeds, n_epochs=int(n_epochs),
                        engine=engine, results=results, recorder=rec)
