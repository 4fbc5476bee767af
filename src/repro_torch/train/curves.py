"""Loss-vs-simulated-wall-clock curves and time-to-target (Fig 5e/6e).

A plain copy of ``repro.train.curves``.

The paper's headline comparison is not loss-vs-epoch (all exact-recovery
schemes share that by construction) but loss-vs-*wall-clock*: schemes
differ in how much simulated time each epoch burns (straggler waits,
uplink drain, wasted no-op epochs).  These reductions turn a
:class:`~repro_torch.train.coded_trainer.TrainEpochLog` list into that view:

  * :func:`loss_curve` — ``(cumulative wall-clock, loss)`` points, NaN
    loss on no-op epochs (the gap convention from ``core/fel.py``);
  * :func:`running_best` — the best loss achieved by each point in time
    (monotone, NaN-skipping) — what "reaching a target" reads off;
  * :func:`time_to_target` — first cumulative wall-clock at which the
    loss reached the target, ``inf`` if it never did.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

__all__ = ["loss_curve", "running_best", "time_to_target", "curve_dict"]


def loss_curve(logs: Sequence) -> Tuple[List[float], List[float]]:
    """``(times, losses)``: cumulative simulated wall-clock at each
    epoch's end and that epoch's full-batch loss (NaN on no-op)."""
    times, losses, t = [], [], 0.0
    for log in logs:
        t += float(log.time)
        times.append(t)
        losses.append(float(log.loss))
    return times, losses


def running_best(losses: Sequence[float]) -> List[float]:
    """Best (lowest) loss seen so far at each point; NaN entries inherit
    the previous best (a failed epoch cannot improve the model)."""
    best, out = math.inf, []
    for v in losses:
        if not math.isnan(v):
            best = min(best, v)
        out.append(best)
    return out


def time_to_target(logs: Sequence, target: float) -> float:
    """Cumulative simulated wall-clock when the loss first reached
    ``target`` (at an epoch whose decode succeeded); ``inf`` if never."""
    times, losses = loss_curve(logs)
    for t, best in zip(times, running_best(losses)):
        if best <= target:
            return t
    return math.inf


def curve_dict(logs: Sequence) -> dict:
    """JSON-ready curve for benchmark artifacts (``BENCH_train.json``)."""
    times, losses = loss_curve(logs)
    return {
        "wall_clock": times,
        # NaN/inf → None so the artifact stays strict JSON
        "loss": [v if math.isfinite(v) else None for v in losses],
        "best_loss": [v if math.isfinite(v) else None
                      for v in running_best(losses)],
        "decode_ok": [bool(log.decode_ok) for log in logs],
        "noop_epochs": sum(1 for log in logs if not log.decode_ok),
    }
