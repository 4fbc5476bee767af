"""Span-condition verification (paper Lemma 1).

A numpy copy of ``repro.core.coding.span``, kept so that the port
never imports the JAX package; bit-identical to it.

The span condition: for every alive set I with |I| = M−s,
``1₁ₓK ∈ span{b_m : m ∈ I}`` — i.e. there exist decode weights a (supported
on I) with aᵀ B = 1ᵀ.
"""
from __future__ import annotations

import itertools
from typing import Iterable, Optional

import numpy as np

from .matrices import CodingScheme

__all__ = ["solve_decode", "satisfies_span", "straggler_patterns"]


def solve_decode(B: np.ndarray, alive: np.ndarray, *, tol: float = 1e-7
                 ) -> Optional[np.ndarray]:
    """Least-squares decode weights a (length M, zero on dead rows) with
    aᵀ B ≈ 1ᵀ, or None if the residual exceeds ``tol``.
    """
    B = np.asarray(B, dtype=np.float64)
    alive = np.asarray(alive, dtype=bool)
    M, K = B.shape
    sub = B[alive]  # (m_alive, K)
    # solve subᵀ x = 1  (K equations, m_alive unknowns)
    x, *_ = np.linalg.lstsq(sub.T, np.ones(K), rcond=None)
    resid = float(np.max(np.abs(sub.T @ x - 1.0))) if K else 0.0
    if resid > tol:
        return None
    a = np.zeros(M)
    a[alive] = x
    return a


def straggler_patterns(M: int, s: int, *, limit: Optional[int] = None,
                       rng: Optional[np.random.Generator] = None
                       ) -> Iterable[np.ndarray]:
    """All (or ``limit`` sampled) alive-masks with exactly s stragglers."""
    total = 1
    for i in range(s):
        total = total * (M - i) // (i + 1)
    if limit is not None and total > limit:
        rng = rng or np.random.default_rng(0)
        seen = set()
        while len(seen) < limit:
            dead = tuple(sorted(rng.choice(M, size=s, replace=False).tolist()))
            if dead in seen:
                continue
            seen.add(dead)
            mask = np.ones(M, dtype=bool)
            mask[list(dead)] = False
            yield mask
        return
    for dead in itertools.combinations(range(M), s):
        mask = np.ones(M, dtype=bool)
        mask[list(dead)] = False
        yield mask


def satisfies_span(scheme: CodingScheme, *, tol: float = 1e-7,
                   limit: Optional[int] = None) -> bool:
    """Exhaustively (or sampled, for large C(M,s)) verify Lemma 1."""
    for alive in straggler_patterns(scheme.M, scheme.s, limit=limit):
        if solve_decode(scheme.B, alive, tol=tol) is None:
            return False
    return True
