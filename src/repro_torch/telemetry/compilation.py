"""Process-global build accounting.

The torch counterpart of ``repro.telemetry.compilation``: a *named*
counter registry that a site bumps once each time it builds something it
then reuses, never once per use.  The reference counts jax traces; the
port traces nothing, so its sites count what it does build:

  * ``comm_scan`` — each chunk runner the batched fleet engine builds
    (a cache miss of ``repro_torch.sim.batched._chunk_runner``);
  * ``device_comm_scan`` — each device-tail runner (a cache miss of
    ``repro_torch.sim.device_epoch._tail_runner``);
  * ``kernel_build:<name>`` — each ``nvcc`` build of a CUDA source
    (``repro_torch.kernels._build``), ``<name>`` being the source's stem.

The reference's ``schedule_slot`` site has no counterpart: the port's
scheduler is plain eager torch and is never compiled.  Recorders snapshot
the counters at construction and report the delta
(:meth:`~repro_torch.telemetry.recorder.FleetRecorder.compile_delta`).
"""
from __future__ import annotations

from collections import Counter
from typing import Dict

__all__ = ["note_compile", "compile_counts", "reset_compile_counts"]

_counts: Counter = Counter()


def note_compile(name: str) -> None:
    """Record one build of the named site."""
    _counts[str(name)] += 1


def compile_counts() -> Dict[str, int]:
    """Snapshot of all build counters since process start (or the last
    :func:`reset_compile_counts`)."""
    return dict(_counts)


def reset_compile_counts() -> None:
    """Zero every counter.  This does *not* drop any cache — pair it
    with ``repro_torch.sim.batched.reset_scan_compile_cache`` when a test
    needs the builds to happen again."""
    _counts.clear()
