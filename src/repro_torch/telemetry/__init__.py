"""Fleet telemetry, ported to torch (the reference's ``repro.telemetry``).

Per-slot scheduler series, phase timing and build accounting for the
co-simulated fleets, with a zero-cost off switch:

  * :class:`TelemetryConfig` / :class:`FleetRecorder` — the recorder every
    engine threads through its epoch loop (``telemetry=`` on
    ``BatchedFleet`` / ``Fleet.run`` / ``run_fleet``; an attribute on
    ``EdgeCluster``);
  * :mod:`~repro_torch.telemetry.metrics` — pure derived metrics (Jain
    fairness, queue-stability drift, straggler EWMA);
  * :mod:`~repro_torch.telemetry.compilation` — named process-global
    build counters (chunk runners, ``nvcc`` builds);
  * :mod:`~repro_torch.telemetry.sinks` — JSONL + in-memory event sinks;
  * :mod:`~repro_torch.telemetry.trace` — Chrome/Perfetto trace export;
  * ``python -m repro_torch.telemetry.report`` — fleet summary table CLI;
  * :func:`record_fleet` — the one-call "run a fleet with telemetry"
    entry point (lazily imported: it pulls in the simulator, which in
    turn imports this package).
"""
from repro_torch.telemetry.compilation import (compile_counts, note_compile,
                                               reset_compile_counts)
from repro_torch.telemetry.metrics import (fleet_fairness, jain_index,
                                           mean_queue_residual,
                                           queue_stability_drift,
                                           straggler_rate_ewma)
from repro_torch.telemetry.recorder import (SERIES_FIELDS, FleetRecorder,
                                            Span, TelemetryConfig,
                                            phase_span)
from repro_torch.telemetry.sinks import JsonlSink, MemorySink
from repro_torch.telemetry.trace import (chrome_trace_events,
                                         write_chrome_trace)

__all__ = [
    "TelemetryConfig", "FleetRecorder", "Span", "SERIES_FIELDS",
    "phase_span",
    "jain_index", "fleet_fairness", "mean_queue_residual",
    "queue_stability_drift", "straggler_rate_ewma",
    "note_compile", "compile_counts", "reset_compile_counts",
    "JsonlSink", "MemorySink",
    "chrome_trace_events", "write_chrome_trace",
    "record_fleet",
]


def record_fleet(*args, **kwargs):
    """See :func:`repro_torch.telemetry.runner.record_fleet` (lazy import
    — keeps ``repro_torch.sim ↔ repro_torch.telemetry`` import order
    acyclic)."""
    from repro_torch.telemetry.runner import record_fleet as _record_fleet
    return _record_fleet(*args, **kwargs)
