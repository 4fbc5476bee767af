"""Heap-based discrete-event engine for the edge-cluster co-simulator.

A numpy copy of ``repro.sim.events``, kept so that the port
never imports the JAX package; bit-identical to it.

The engine owns two things:

  * an event heap — continuous-time compute-completion events
    (``COMPUTE_DONE``) are merged with the slotted communication timeline
    (``SLOT_TICK``) in global time order, ties broken by insertion order;
  * the RNG stream — every stochastic model in a co-simulation
    (``CompletionTimeModel``, channel fading, energy harvest) draws from
    ``engine.rng`` so a single seed reproduces the whole epoch.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Any, Callable, Optional

import numpy as np

__all__ = ["Event", "EventEngine", "COMPUTE_DONE", "SLOT_TICK", "STOP"]

COMPUTE_DONE = "compute-done"
SLOT_TICK = "slot-tick"

#: Sentinel a handler returns from :meth:`EventEngine.run` to stop the loop.
STOP = object()


@dataclasses.dataclass(frozen=True)
class Event:
    time: float
    seq: int                       # insertion order, breaks time ties
    kind: str
    payload: Any = None

    def __lt__(self, other: "Event") -> bool:
        return (self.time, self.seq) < (other.time, other.seq)


class EventEngine:
    """Monotonic-clock event heap + shared RNG stream."""

    def __init__(self, seed: int = 0):
        self._heap: list[Event] = []
        self._seq = itertools.count()
        self.now = 0.0
        self.rng = np.random.default_rng(seed)
        self.processed = 0

    # ------------------------------------------------------------------ #
    def schedule(self, time: float, kind: str, payload: Any = None) -> Event:
        """Schedule an event at absolute ``time`` (must not be in the past)."""
        if time < self.now:
            raise ValueError(f"cannot schedule into the past "
                             f"({time} < now={self.now})")
        ev = Event(time=float(time), seq=next(self._seq), kind=kind,
                   payload=payload)
        heapq.heappush(self._heap, ev)
        return ev

    def after(self, delay: float, kind: str, payload: Any = None) -> Event:
        return self.schedule(self.now + float(delay), kind, payload)

    # ------------------------------------------------------------------ #
    def peek(self) -> Optional[Event]:
        return self._heap[0] if self._heap else None

    def pop(self) -> Optional[Event]:
        """Pop the next event and advance the clock to it."""
        if not self._heap:
            return None
        ev = heapq.heappop(self._heap)
        self.now = ev.time
        self.processed += 1
        return ev

    def pop_until(self, time: float) -> list[Event]:
        """Pop (in time order) every event with ``ev.time <= time``."""
        out = []
        while self._heap and self._heap[0].time <= time:
            out.append(self.pop())
        return out

    def empty(self) -> bool:
        return not self._heap

    def clear(self) -> None:
        self._heap.clear()

    def reset_clock(self) -> None:
        """Rewind to t=0 between epochs (heap must be drained first)."""
        if self._heap:
            raise RuntimeError("cannot reset clock with pending events")
        self.now = 0.0

    # ------------------------------------------------------------------ #
    def run(self, handler: Callable[[Event], Any],
            until: float = math.inf) -> float:
        """Dispatch events in time order until the heap drains, ``until``
        is passed, or the handler returns :data:`STOP`.  Handlers may
        schedule further events.  Returns the final clock."""
        while self._heap and self._heap[0].time <= until:
            if handler(self.pop()) is STOP:
                break
        return self.now

    # ------------------------------------------------------------------ #
    def sample_completion(self, model, worker_ids: np.ndarray,
                          n_tasks: np.ndarray) -> np.ndarray:
        """Delegated completion-time sampling (one RNG stream per sim)."""
        return model.sample(worker_ids, n_tasks, self.rng)
