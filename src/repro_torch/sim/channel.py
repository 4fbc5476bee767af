"""Per-slot uplink rate models for the co-simulator.

The torch port of ``repro.sim.channel``, kept here so that the port never
imports the JAX package.  A channel model produces the (M,) vector of
per-worker uplink capacities (bytes per unit time) for each slot, in two
forms that share one source of truth:

  host core
      ``init_state_np`` / ``step_np`` — pure per-slot stepping for the
      event-driven ``EdgeCluster``'s host loop (numpy float64).

  batched core
      ``rates_for_slots`` — whole rate blocks of the stateless models;
      ``batched_params`` / ``tape_arrays`` + ``step_batched`` — the
      Gilbert–Elliott chain stepped over ``(S, M)`` lanes on the device by
      the batched fleet engine (``repro_torch.sim.batched``).  The flips
      are resolved against the transition probabilities in float64 on the
      host (``tape_arrays``), so the device only selects booleans and the
      chain is bit-identical to the host core's.

All comm-phase randomness is drawn through :class:`CommTape` in fixed
blocks of :data:`TAPE_BLOCK` slots, so RNG consumption depends only on
the furthest slot block reached, and the seed's stream is left at the
reference's position for the next epoch.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["ChannelModel", "StaticChannel", "GilbertElliottChannel",
           "TraceChannel", "CommTape", "TAPE_BLOCK"]

#: Slots per randomness block (the reference's value: the draw order
#: depends on it).
TAPE_BLOCK = 256


class ChannelModel:
    """Base: per-slot uplink rates for M workers.

    Subclasses implement the pure core; the stateful ``reset``/
    ``slot_rates`` wrappers below are derived from it.
    """

    M: int
    #: True when per-slot rates depend on evolving *random* state (the
    #: batched engine then carries the state through its chunk loop).
    stateful = False

    def physics_key(self) -> tuple:
        """Hashable description of the channel physics — two channels with
        equal keys produce identical rate processes from identical draws
        (used to check spec↔channel equivalence; fleet lanes need only
        share the channel *class*, parameters stack per lane)."""
        raise NotImplementedError

    def nominal_rates(self):
        """(M,) typical per-worker rates, or None when unknown.

        A *heuristic* long-run rate estimate (stationary mean for Markov
        models, trace mean for traces) used only for sizing decisions,
        never for simulation arithmetic.
        """
        return None

    # -- randomness contract ------------------------------------------- #
    def draw_init(self, rng: np.random.Generator) -> Optional[np.ndarray]:
        """Uniforms needed to initialise state at epoch start (or None)."""
        return None

    def draw_slots(self, rng: np.random.Generator,
                   n: int) -> Optional[np.ndarray]:
        """(n, M) uniforms consumed by ``n`` slots of stepping (or None)."""
        return None

    # -- pure host-side core (oracle path) ------------------------------ #
    def init_state_np(self, u_init: Optional[np.ndarray]):
        """State at slot 0 from the init draw (None for stateless models)."""
        return None

    def step_np(self, state, u_row: Optional[np.ndarray], slot: int):
        """Pure step: ``(rates_f64, next_state)`` for slot ``slot``."""
        raise NotImplementedError

    # -- pure batched core (batched fleet engine) ----------------------- #
    def rates_for_slots(self, slots: np.ndarray) -> np.ndarray:
        """(len(slots), M) rate rows — stateless models only."""
        raise NotImplementedError(f"{type(self).__name__} is stateful; "
                                  "carry its state through the scan instead")

    def batched_params(self) -> dict:
        """Host float32 parameter rows handed to ``step_batched`` (the
        fleet stacks them over lanes and copies them to the device once)."""
        return {}

    def tape_arrays(self, u_block: np.ndarray) -> dict:
        """Preprocess a (n, M) uniform block into per-slot boolean rows.

        Thresholding against transition probabilities happens here in
        float64, so the device step only selects and is exact.
        """
        return {}

    @staticmethod
    def step_batched(params: dict, state, x_row: dict, slot):
        """Pure torch step: ``(rates_f32, next_state)`` — stateful
        models."""
        raise NotImplementedError

    # -- legacy stateful API (thin wrappers over the pure core) --------- #
    def reset(self, rng: np.random.Generator) -> None:
        """Re-initialize internal state at the start of an epoch."""
        self._state = self.init_state_np(self.draw_init(rng))

    def slot_rates(self, slot: int, rng: np.random.Generator) -> np.ndarray:
        """(M,) uplink capacities for slot ``slot`` (and advance state)."""
        u = self.draw_slots(rng, 1)
        row = u[0] if u is not None else None
        r, self._state = self.step_np(getattr(self, "_state", None), row,
                                      slot)
        return r


class StaticChannel(ChannelModel):
    """Time-invariant rates (the pre-co-sim behaviour, kept as a model)."""

    def __init__(self, rates: np.ndarray):
        self._rates = np.asarray(rates, np.float64)
        self.M = len(self._rates)

    def physics_key(self) -> tuple:
        return ("static", self._rates.tobytes())

    def nominal_rates(self) -> np.ndarray:
        return self._rates.copy()

    def step_np(self, state, u_row, slot):
        return self._rates.copy(), state

    def rates_for_slots(self, slots: np.ndarray) -> np.ndarray:
        return np.broadcast_to(self._rates, (len(slots), self.M)).copy()


class GilbertElliottChannel(ChannelModel):
    """Two-state Markov fading: each worker's link flips between a GOOD
    rate and a BAD (deep-fade) rate with per-slot transition probabilities
    ``p_gb`` (good→bad) and ``p_bg`` (bad→good) — the classic bursty-loss
    model, per worker independently.
    """

    stateful = True

    def __init__(self, rate_good: np.ndarray, rate_bad: np.ndarray,
                 p_gb: float = 0.1, p_bg: float = 0.3,
                 start_good: bool = True):
        self.rate_good = np.atleast_1d(np.asarray(rate_good, np.float64))
        self.rate_bad = np.broadcast_to(
            np.asarray(rate_bad, np.float64), self.rate_good.shape).copy()
        self.M = len(self.rate_good)
        self.p_gb = float(p_gb)
        self.p_bg = float(p_bg)
        self._start_good = start_good
        self._state = np.full(self.M, start_good, bool)

    def physics_key(self) -> tuple:
        return ("gilbert-elliott", self.rate_good.tobytes(),
                self.rate_bad.tobytes(), self.p_gb, self.p_bg,
                self._start_good)

    def nominal_rates(self) -> np.ndarray:
        # stationary mean of the two-state chain
        p_good = self.p_bg / max(self.p_gb + self.p_bg, 1e-12)
        return p_good * self.rate_good + (1.0 - p_good) * self.rate_bad

    def draw_init(self, rng: np.random.Generator) -> Optional[np.ndarray]:
        # start_good needs no draw; otherwise one uniform per worker for
        # the stationary-distribution initialisation.
        return None if self._start_good else rng.random(self.M)

    def draw_slots(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return rng.random((n, self.M))

    def init_state_np(self, u_init: Optional[np.ndarray]) -> np.ndarray:
        if u_init is None:
            return np.ones(self.M, bool)
        p_good = self.p_bg / max(self.p_gb + self.p_bg, 1e-12)
        return u_init < p_good

    def step_np(self, good, u_row, slot):
        r = np.where(good, self.rate_good, self.rate_bad)
        new_good = np.where(good, u_row >= self.p_gb, u_row < self.p_bg)
        return r, new_good

    def batched_params(self) -> dict:
        return {"rate_good": self.rate_good.astype(np.float32),
                "rate_bad": self.rate_bad.astype(np.float32)}

    def tape_arrays(self, u_block: np.ndarray) -> dict:
        # float64 comparisons on the host: the device step then only
        # selects booleans, so the chain is bit-identical to step_np's.
        return {"stay_good": u_block >= self.p_gb,
                "go_good": u_block < self.p_bg}

    @staticmethod
    def step_batched(params, good, x_row, slot):
        r = torch.where(good, params["rate_good"], params["rate_bad"])
        new_good = torch.where(good, x_row["stay_good"], x_row["go_good"])
        return r, new_good


class TraceChannel(ChannelModel):
    """Trace-driven rates: row ``t`` of a (T, M) trace is slot ``t``'s rate
    vector; the trace loops (or holds its last row with ``loop=False``).
    Models measured/adversarial conditions such as a flash-crowd collapse.
    """

    def __init__(self, trace: np.ndarray, loop: bool = True):
        self.trace = np.atleast_2d(np.asarray(trace, np.float64))
        self.M = self.trace.shape[1]
        self.loop = loop

    def physics_key(self) -> tuple:
        return ("trace", self.trace.tobytes(), self.loop)

    def nominal_rates(self) -> np.ndarray:
        return self.trace.mean(axis=0)

    def _index(self, slots):
        T = self.trace.shape[0]
        slots = np.asarray(slots)
        return slots % T if self.loop else np.minimum(slots, T - 1)

    def step_np(self, state, u_row, slot):
        return self.trace[int(self._index(slot))].copy(), state

    def rates_for_slots(self, slots: np.ndarray) -> np.ndarray:
        return self.trace[self._index(slots)].copy()


class CommTape:
    """Block-drawn randomness for one epoch's communication phase.

    Draw order per epoch (all from the one per-seed RNG stream): the
    channel's init uniforms, then for each block b the channel's
    ``(block, M)`` slot uniforms followed by the harvest ``(block, M)``
    uniforms.  Block b is drawn the first time any slot in
    ``[b·block, (b+1)·block)`` is requested via :meth:`ensure`, so an
    epoch that stops at the same slot as the reference's consumes
    identical randomness and leaves the stream at the same position for
    the next epoch's compute phase.
    """

    def __init__(self, channel: ChannelModel, rng: np.random.Generator,
                 harvest_mean: float, harvest_jitter: float,
                 block: int = TAPE_BLOCK):
        self.channel = channel
        self.rng = rng
        self.block = int(block)
        self._hm = float(harvest_mean)
        jit = float(harvest_jitter)
        self._lo, self._hi = max(1.0 - jit, 0.0), 1.0 + jit
        self.u_init = channel.draw_init(rng)
        self._u: list = []
        self._h: list = []
        self.n_drawn = 0
        self.ensure(0)

    def ensure(self, slot: int) -> None:
        """Draw blocks until ``slot`` is on the tape."""
        while slot >= self.n_drawn:
            u = self.channel.draw_slots(self.rng, self.block)
            if u is not None:
                self._u.append(u)
            self._h.append(self._hm * self.rng.uniform(
                self._lo, self._hi, (self.block, self.channel.M)))
            self.n_drawn += self.block

    # row access (oracle) ---------------------------------------------- #
    def channel_u(self, k: int) -> Optional[np.ndarray]:
        if not self._u:
            return None
        return self._u[k // self.block][k % self.block]

    def harvest(self, k: int) -> np.ndarray:
        return self._h[k // self.block][k % self.block]

    # chunk access (batched engine; chunks divide the tape block) ------ #
    def _rows(self, store: list, k0: int, n: int) -> np.ndarray:
        b, off = divmod(k0, self.block)
        assert off + n <= self.block, (
            f"chunk [{k0}, {k0 + n}) straddles tape block {b} — scan "
            f"chunks must stay block-aligned so RNG draws are unchanged")
        return store[b][off:off + n]

    def channel_rows(self, k0: int, n: int) -> Optional[np.ndarray]:
        """Channel uniforms for slots ``[k0, k0+n)`` (within one block)."""
        return self._rows(self._u, k0, n) if self._u else None

    def harvest_rows(self, k0: int, n: int) -> np.ndarray:
        """Harvest draws for slots ``[k0, k0+n)`` (within one block)."""
        return self._rows(self._h, k0, n)
