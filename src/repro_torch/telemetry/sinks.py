"""Telemetry event sinks: JSONL on disk, in-memory for tests.

A sink is anything with ``write(event: dict)`` — the recorder's
:meth:`~repro_torch.telemetry.recorder.FleetRecorder.flush` pushes its event
stream (``run`` / ``epoch`` / ``span`` / ``slot`` / ``compiles`` records,
see ``FleetRecorder.events``) through every sink it is given.  Multiple
runs may be flushed into one JSONL file; each run's ``run`` header resets
the reader's context (``repro_torch.telemetry.report`` relies on this).
"""
from __future__ import annotations

import json
from typing import List

import numpy as np

__all__ = ["JsonlSink", "MemorySink", "jsonable"]


def jsonable(obj):
    """Recursively coerce numpy scalars/arrays into JSON-native values."""
    if isinstance(obj, dict):
        return {k: jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


class MemorySink:
    """Keeps events as a list — the unit-test sink."""

    def __init__(self):
        self.events: List[dict] = []

    def write(self, event: dict) -> None:
        self.events.append(jsonable(event))

    def close(self) -> None:
        pass


class JsonlSink:
    """Appends one JSON object per line to ``path`` (created eagerly, so
    an empty run still leaves a file).  Usable as a context manager."""

    def __init__(self, path: str):
        self.path = str(path)
        self._f = open(self.path, "a")
        self.n_written = 0

    def write(self, event: dict) -> None:
        json.dump(jsonable(event), self._f, separators=(",", ":"))
        self._f.write("\n")
        self.n_written += 1

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
