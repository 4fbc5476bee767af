"""Fleet telemetry recorder: the torch port of ``repro.telemetry.recorder``.

One :class:`FleetRecorder` instance observes one fleet run — both co-sim
engines thread it through their epoch loops — and accumulates four kinds
of record in memory:

  * **per-slot comm series** — ``(n_slots, M)`` arrays per (lane, epoch)
    of the scheduler state the paper's time-series claims live on: queue
    backlog ``Q``, virtual admission queue ``H``, battery ``E``,
    admitted bytes, transmitted bytes and worker-pending bytes.  The
    event-driven oracle records rows slot by slot; the batched engine
    slices the same values out of its chunk-scan outputs — the telemetry
    parity contract (``tests/test_torch_telemetry.py``) pins the two series
    equal on every registry scenario × scheme;
  * **phase spans** — wall-clock ``(t0, t1)`` intervals around the
    stage-1 / stage-2 / comm / decode phases of every epoch, exportable
    as a Chrome/Perfetto trace (:mod:`repro_torch.telemetry.trace`);
  * **epoch events** — the scalar per-(lane, epoch) outcome summary
    (decode, slots, times, byte totals) the report CLI tabulates;
  * **compile accounting** — the delta of the named compile counters
    (:mod:`repro_torch.telemetry.compilation`) over the recorder's lifetime.

The **zero-cost off switch**: engines accept ``telemetry=None`` (the
default) or a recorder whose config is disabled, and both cases take the
exact pre-telemetry code path — no extra scan outputs are traced, no
per-slot host work runs, results are bit-identical to a run without the
argument (pinned by the existing differential suites plus the
``tests/test_torch_telemetry.py`` bit-identity test).  ``bool(recorder)`` is
the one check engines perform.

Recorders are engine-agnostic and numpy-pure: nothing here imports the
simulator, so ``repro_torch.sim`` modules may import this one freely.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.telemetry.compilation import compile_counts

__all__ = ["TelemetryConfig", "FleetRecorder", "Span", "SERIES_FIELDS",
           "phase_span"]

#: Per-slot series recorded for every (lane, epoch) comm phase, all
#: ``(n_slots, M)``: post-slot queue backlog / virtual queue / battery,
#: plus the slot's admissions, transmissions and post-slot worker-pending
#: bytes.  Field names are shared verbatim by both engines and the JSONL
#: schema.
SERIES_FIELDS = ("Q", "H", "E", "admitted", "transmitted", "pending")


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """What a recorder collects.  ``enabled=False`` makes the recorder
    falsy — engines then skip every telemetry branch (the off switch).

    ``sink_slots`` controls whether :meth:`FleetRecorder.flush` emits the
    (potentially large) per-slot series as JSONL events in addition to
    keeping them in memory; spans/epochs/compile counters always flush.
    """
    enabled: bool = True
    series: bool = True         # collect per-slot comm series
    spans: bool = True          # collect wall-clock phase spans
    sink_slots: bool = False    # emit slot events on flush (verbose)


@dataclasses.dataclass
class Span:
    """One wall-clock phase interval (``time.perf_counter`` seconds)."""
    name: str
    t0: float
    t1: float
    meta: dict

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class FleetRecorder:
    """Accumulates one fleet run's telemetry; see the module docstring.

    ``meta`` identifies the run (scenario/scheme/engine/fleet shape) for
    sinks and the report CLI; set it at construction or later via
    :meth:`set_meta`.
    """

    def __init__(self, config: Optional[TelemetryConfig] = None, **meta):
        self.config = config or TelemetryConfig()
        self.meta: dict = dict(meta)
        self.spans: List[Span] = []
        self._series: Dict[Tuple[int, int], Dict[str, np.ndarray]] = {}
        self._epochs: Dict[Tuple[int, int], dict] = {}
        self._compiles0 = compile_counts()

    # -- the off switch ------------------------------------------------- #
    def __bool__(self) -> bool:
        return self.config.enabled

    @property
    def wants_series(self) -> bool:
        return self.config.enabled and self.config.series

    @property
    def wants_spans(self) -> bool:
        return self.config.enabled and self.config.spans

    # -- identification ------------------------------------------------- #
    def set_meta(self, **meta) -> None:
        self.meta.update(meta)

    # -- per-slot comm series ------------------------------------------- #
    def record_comm_series(self, lane: int, epoch: int, *,
                           n_slots: int, **fields: np.ndarray) -> None:
        """Store one comm phase's per-slot series for ``(lane, epoch)``.

        Every :data:`SERIES_FIELDS` name must be supplied as an array
        whose leading axis covers at least ``n_slots`` rows; rows past
        ``n_slots`` (a batched chunk's overshoot past the stop slot) are
        trimmed here so both engines store identical shapes.
        """
        if not self.wants_series:
            return
        missing = set(SERIES_FIELDS) - set(fields)
        extra = set(fields) - set(SERIES_FIELDS)
        if missing or extra:
            raise ValueError(f"series fields must be exactly "
                             f"{SERIES_FIELDS}; missing={sorted(missing)} "
                             f"unknown={sorted(extra)}")
        out = {}
        for name in SERIES_FIELDS:
            arr = np.asarray(fields[name])
            if arr.shape[0] < n_slots:
                raise ValueError(
                    f"series {name!r} has {arr.shape[0]} rows < "
                    f"n_slots={n_slots} for lane={lane} epoch={epoch}")
            out[name] = arr[:n_slots].copy()
        self._series[(int(lane), int(epoch))] = out

    def comm_series(self, lane: int, epoch: int) -> Dict[str, np.ndarray]:
        """The recorded ``{field: (n_slots, M)}`` series of one epoch."""
        return self._series[(int(lane), int(epoch))]

    def series_keys(self) -> List[Tuple[int, int]]:
        return sorted(self._series)

    # -- phase spans ---------------------------------------------------- #
    @contextlib.contextmanager
    def span(self, name: str, **meta) -> Iterator[None]:
        """Record the wall-clock of the enclosed block as a named span."""
        if not self.wants_spans:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append(Span(name, t0, time.perf_counter(),
                                   dict(meta)))

    # -- epoch outcome events ------------------------------------------- #
    def record_epoch(self, lane: int, epoch: int, result) -> None:
        """Summarize one lane's :class:`~repro_torch.core.runtime.EpochResult`
        (duck-typed — no simulator import) into a scalar outcome event."""
        if not self.config.enabled:
            return
        ev = {"time": float(result.time),
              "compute_time": float(result.compute_time),
              "comm_time": float(result.comm_time),
              "decode_ok": bool(result.decode_ok),
              "utilization": float(result.utilization),
              "n_stragglers": int(result.n_stragglers),
              "stage2_triggered": bool(result.stage2_triggered)}
        comm = getattr(result, "comm", None)
        if comm is not None:
            ev.update(
                n_slots=int(comm.n_slots),
                idle_slots=int(comm.idle_slots),
                bytes_admitted=np.asarray(comm.bytes_admitted,
                                          np.float64).tolist(),
                bytes_transmitted=np.asarray(comm.bytes_transmitted,
                                             np.float64).tolist(),
                queue_residual=np.asarray(comm.queue_residual,
                                          np.float64).tolist(),
                min_energy=float(comm.min_energy))
        self._epochs[(int(lane), int(epoch))] = ev

    def epoch_events(self) -> List[dict]:
        """Epoch outcome events in (epoch, lane) order, keys inlined."""
        return [{"lane": lane, "epoch": epoch, **ev}
                for (lane, epoch), ev in sorted(
                    self._epochs.items(), key=lambda kv: kv[0][::-1])]

    # -- compile accounting --------------------------------------------- #
    def compile_delta(self) -> Dict[str, int]:
        """Compilations per named site since this recorder was created."""
        now = compile_counts()
        return {k: v - self._compiles0.get(k, 0) for k, v in now.items()
                if v != self._compiles0.get(k, 0)}

    # -- sink flush ----------------------------------------------------- #
    def events(self) -> Iterator[dict]:
        """The run as a flat, JSON-serializable event stream: one ``run``
        header, then ``epoch`` / ``span`` / optional ``slot`` events and
        a final ``compiles`` record (the JSONL schema of
        :mod:`repro_torch.telemetry.sinks` / ``repro_torch.telemetry.report``)."""
        yield {"type": "run", **self.meta}
        for ev in self.epoch_events():
            yield {"type": "epoch", **ev}
        for sp in self.spans:
            yield {"type": "span", "name": sp.name, "t0": sp.t0,
                   "t1": sp.t1, **sp.meta}
        if self.config.sink_slots:
            for (lane, epoch), series in sorted(self._series.items()):
                n = series[SERIES_FIELDS[0]].shape[0]
                for k in range(n):
                    yield {"type": "slot", "lane": lane, "epoch": epoch,
                           "slot": k,
                           **{f: series[f][k].tolist()
                              for f in SERIES_FIELDS}}
        yield {"type": "compiles", "counts": self.compile_delta()}

    def flush(self, *sinks) -> None:
        """Write the event stream to the given sinks (or, with no
        arguments, do nothing — the recorder itself stays queryable)."""
        if not sinks:
            return
        events = list(self.events())
        for sink in sinks:
            for ev in events:
                sink.write(ev)


def phase_span(recorder: Optional[FleetRecorder], name: str, **meta):
    """``recorder.span(...)`` when spans are wanted, else a null context —
    the guard every engine call site uses so the off path stays free."""
    if recorder is not None and recorder.wants_spans:
        return recorder.span(name, **meta)
    return contextlib.nullcontext()
