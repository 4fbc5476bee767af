"""High-level "record a fleet" entry point.

Wires a :class:`~repro_torch.telemetry.recorder.FleetRecorder` through any
co-sim engine and returns both the epoch results and the populated
recorder.  Kept out of ``repro_torch.telemetry``'s import graph proper (it
imports the simulator, which itself imports the rest of this package).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from repro_torch.telemetry.recorder import FleetRecorder, TelemetryConfig

__all__ = ["record_fleet"]


def record_fleet(scenario, scheme: str = "two-stage", *,
                 seeds: Sequence[int] = (0, 1, 2, 3), n_epochs: int = 2,
                 engine: str = "batched",
                 config: Optional[TelemetryConfig] = None,
                 sinks: Sequence = (), device="cuda",
                 ) -> Tuple[List[List], FleetRecorder]:
    """Run one (scenario × scheme) fleet with telemetry on.

    Returns ``(results, recorder)`` with ``results[epoch][lane]`` the
    per-epoch :class:`~repro_torch.core.runtime.EpochResult` lists and the
    recorder holding per-slot series, phase spans, epoch events and the
    build delta; ``sinks`` (e.g. a
    :class:`~repro_torch.telemetry.sinks.JsonlSink`) receive the flushed
    event stream before returning.  ``engine`` is any of
    :data:`repro_torch.sim.fleet.ENGINES`; the oracle records the
    identical series slot by slot (the parity contract).  The fleet runs
    on ``device``: the card unless the caller asks for ``"cpu"``.

    Thin wrapper over the :class:`~repro_torch.sim.fleet.Fleet` facade.
    """
    from repro_torch.sim.fleet import Fleet, validate_engine

    validate_engine(engine)
    run = Fleet(scenario).run(scheme, seeds, n_epochs=n_epochs,
                              engine=engine,
                              telemetry=config or TelemetryConfig(),
                              sinks=sinks, device=device)
    return run.results, run.recorder
