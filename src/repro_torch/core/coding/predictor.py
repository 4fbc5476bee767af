"""Straggler prediction from historical completion times (paper §4.2).

A numpy copy of ``repro.core.coding.predictor``, kept so that the port
never imports the JAX package; bit-identical to it.

The paper conditions the coding decision on history:
``max E_{s<i> | s<i-1>}[D(τ, s, B1, B2)]`` — we estimate (a) per-worker
speeds ``W_m`` (tasks per unit time, Eq.-16 inputs), (b) the straggler count
``ŝ`` for the next epoch, and (c) per-worker completion-time quantiles used
to set the stage-1 deadline ``T_comp``.

Estimators are exponentially weighted (EWMA mean + variance) so the
coefficients adapt as worker behaviour drifts — the "dynamic" in TSDCFL.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

__all__ = ["StragglerPredictor"]


@dataclasses.dataclass
class _Ewma:
    mean: np.ndarray
    var: np.ndarray
    initialized: np.ndarray


class StragglerPredictor:
    """Per-worker completion-time statistics + straggler-count forecast.

    Args:
      M: number of workers.
      alpha: EWMA smoothing factor for per-worker time-per-task.
      s_alpha: EWMA smoothing for the straggler count.
      margin: safety margin added to the predicted straggler count
        (ŝ = ceil(EWMA + margin·std)).
    """

    def __init__(self, M: int, *, alpha: float = 0.3, s_alpha: float = 0.4,
                 margin: float = 1.0):
        self.M = M
        self.alpha = alpha
        self.s_alpha = s_alpha
        self.margin = margin
        self._t = _Ewma(mean=np.ones(M), var=np.zeros(M),
                        initialized=np.zeros(M, dtype=bool))
        self._s_mean: Optional[float] = None
        self._s_var: float = 0.0

    # ------------------------------------------------------------------ #
    def update_times(self, workers: np.ndarray, times_per_task: np.ndarray
                     ) -> None:
        """Record observed per-task completion times for ``workers``."""
        workers = np.asarray(workers, dtype=int)
        x = np.asarray(times_per_task, dtype=np.float64)
        a = self.alpha
        for w, t in zip(workers, x):
            if not np.isfinite(t) or t <= 0:
                continue
            if not self._t.initialized[w]:
                self._t.mean[w] = t
                self._t.var[w] = 0.0
                self._t.initialized[w] = True
            else:
                d = t - self._t.mean[w]
                self._t.mean[w] += a * d
                self._t.var[w] = (1 - a) * (self._t.var[w] + a * d * d)

    @staticmethod
    def update_times_batched(predictors: "Sequence[StragglerPredictor]",
                             workers: np.ndarray, times_per_task: np.ndarray,
                             mask: Optional[np.ndarray] = None) -> None:
        """One EWMA update for a whole seed stack — bit-exact vs S
        sequential :meth:`update_times` calls.

        Args:
          predictors: S per-seed predictors (equal ``M``; ``alpha`` may
            vary per lane).
          workers: (S, n) worker ids — **unique within each row** (one
            observation per worker per call, which is what every epoch
            code path produces; with duplicates the sequential oracle
            would chain EWMA steps that a scatter cannot express).
          times_per_task: (S, n) observed per-task times.
          mask: optional (S, n) bool — rows of observations to keep.

        The per-worker update is a single EWMA step, so with unique
        workers the sequential loop order is irrelevant and the masked
        (S, M)-scatter form below is an elementwise IEEE float64 twin of
        the oracle's scalar arithmetic.
        """
        S = len(predictors)
        if S == 0:
            return
        M = predictors[0].M
        workers = np.asarray(workers, dtype=int)
        x = np.asarray(times_per_task, dtype=np.float64)
        valid = np.isfinite(x) & (x > 0)
        if mask is not None:
            valid &= np.asarray(mask, dtype=bool)
        mean = np.stack([p._t.mean for p in predictors])
        var = np.stack([p._t.var for p in predictors])
        init = np.stack([p._t.initialized for p in predictors])
        a = np.array([p.alpha for p in predictors])[:, None]

        obs = np.full((S, M), np.nan)
        rows, cols = np.nonzero(valid)
        obs[rows, workers[rows, cols]] = x[rows, cols]
        upd = ~np.isnan(obs)
        first = upd & ~init
        cont = upd & init
        with np.errstate(invalid="ignore"):
            d = obs - mean                       # NaN where unobserved
            new_mean = np.where(first, obs,
                                np.where(cont, mean + a * d, mean))
            new_var = np.where(first, 0.0,
                               np.where(cont, (1 - a) * (var + a * d * d),
                                        var))
        for i, p in enumerate(predictors):
            p._t.mean[:] = new_mean[i]
            p._t.var[:] = new_var[i]
            p._t.initialized[:] = init[i] | upd[i]

    @staticmethod
    def predict_s_batched(predictors: "Sequence[StragglerPredictor]",
                          n_active: np.ndarray, s_min: int = 1
                          ) -> np.ndarray:
        """(S,) straggler forecasts — elementwise twin of
        :meth:`predict_s` over a predictor stack."""
        s_mean = np.array([np.nan if p._s_mean is None else p._s_mean
                           for p in predictors], np.float64)
        s_var = np.array([p._s_var for p in predictors], np.float64)
        margin = np.array([p.margin for p in predictors], np.float64)
        n_active = np.asarray(n_active, dtype=int)
        raw = np.ceil(s_mean + margin * np.sqrt(np.maximum(s_var, 0.0)))
        s_hat = np.where(np.isnan(s_mean), float(s_min), raw).astype(int)
        return np.clip(np.maximum(s_hat, s_min), 0,
                       np.maximum(n_active - 1, 0))

    def update_straggler_count(self, s_observed: int) -> None:
        if self._s_mean is None:
            self._s_mean = float(s_observed)
        else:
            d = s_observed - self._s_mean
            self._s_mean += self.s_alpha * d
            self._s_var = (1 - self.s_alpha) * (self._s_var
                                                + self.s_alpha * d * d)

    # ------------------------------------------------------------------ #
    def speeds(self) -> np.ndarray:
        """W_m — tasks per unit time (Eq.-16 weights)."""
        return 1.0 / np.maximum(self._t.mean, 1e-9)

    def time_quantile(self, q: float = 0.9) -> np.ndarray:
        """Per-worker q-quantile of time-per-task under a normal approx."""
        from math import sqrt
        z = {0.5: 0.0, 0.75: 0.674, 0.9: 1.282, 0.95: 1.645, 0.99: 2.326}
        zq = z.get(q, 1.282)
        return self._t.mean + zq * np.sqrt(np.maximum(self._t.var, 0.0))

    def suggest_deadline(self, tasks_per_worker: float, q: float = 0.75
                         ) -> float:
        """Stage-1 deadline T_comp: q-quantile worker finishes its share."""
        per_task = self.time_quantile(q)
        return float(np.median(per_task) * tasks_per_worker)

    def predict_s(self, n_active: int, s_min: int = 1) -> int:
        """ŝ for the next epoch: EWMA count + margin·std, clipped."""
        if self._s_mean is None:
            s_hat = s_min
        else:
            s_hat = int(np.ceil(self._s_mean
                                + self.margin * np.sqrt(max(self._s_var, 0.0))))
        return int(np.clip(max(s_hat, s_min), 0, max(n_active - 1, 0)))

    def straggler_probs(self, deadline_per_task: float) -> np.ndarray:
        """P(worker time-per-task > deadline), normal approx (Zelen & Severo)."""
        mu, var = self._t.mean, np.maximum(self._t.var, 1e-12)
        z = (deadline_per_task - mu) / np.sqrt(var)
        t = 1.0 / (1.0 + 0.2316419 * np.abs(z))
        poly = t * (0.319381530 + t * (-0.356563782 + t * (1.781477937
                    + t * (-1.821255978 + t * 1.330274429))))
        phi = 1.0 - np.exp(-z * z / 2.0) / np.sqrt(2 * np.pi) * poly
        cdf = np.where(z >= 0, phi, 1.0 - phi)
        return 1.0 - cdf
