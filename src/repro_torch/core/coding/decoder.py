"""Decode-weight computation per straggler pattern (paper Eq. 3–4, T2/T3).

A numpy copy of ``repro.core.coding.decoder``, kept so that the port
never imports the JAX package; bit-identical to it.

Given the scheme and the realized alive mask, produce the weight vector
``a`` (length M, zero on stragglers) with ``aᵀ B = 1₁ₓK``.  The weighted sum
``Σ_m a_m ĝ_m`` then equals the exact full gradient.

Fast paths:
  * vandermonde — closed-form polynomial decode (T2): with worker nodes α_m
    and straggler set S, the degree-|S| polynomial p(x) = Π_{j∈S}(x−α_j)
    yields a_m = p(α_m)/p(1)·(row of D·A); since the code satisfies
    A·B = 1 exactly, a_m = p(α_m) normalized so that Σ-weights recover 1ᵀ.
  * fractional — one representative per FRS group, weight 1.
  * uncoded — requires all workers; weight 1 each.
  * generic — least-squares fallback.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np

from .matrices import CodingScheme
from .span import solve_decode

__all__ = ["decode_weights", "rs_decode_weights"]


def _rs_decode_np(nodes: np.ndarray, alive: np.ndarray, s: int) -> np.ndarray:
    """Uncached closed-form RS solve (see :func:`rs_decode_weights`)."""
    M = len(nodes)
    dead = np.flatnonzero(~alive)
    roots = list(nodes[dead])
    if len(roots) < s:
        # pad with alive nodes: their weight becomes 0, harmless (we still
        # satisfy the span equation using the remaining alive workers).
        alive_idx = np.flatnonzero(alive)
        for idx in alive_idx[: s - len(roots)]:
            roots.append(nodes[idx])
    p_at = np.ones(M)
    p_at_1 = 1.0
    for r in roots:
        p_at *= nodes - r
        p_at_1 *= 1.0 - r
    a = p_at / p_at_1
    a[~alive] = 0.0
    return a


@lru_cache(maxsize=4096)
def _rs_decode_cached(nodes_b: bytes, alive_b: bytes, s: int) -> np.ndarray:
    """Memoized RS solve keyed on the exact ``(nodes, alive, s)`` bytes.

    The decode gate of the co-simulated uplink re-evaluates the same
    straggler pattern every time an arrival flips a mask bit, and a
    batched fleet evaluates the same handful of patterns across hundreds
    of lanes per epoch — so the solve cache hit rate is high.  The cached
    array is frozen (``writeable=False``); callers get a copy so a
    mutated result can never corrupt later hits.
    """
    a = _rs_decode_np(np.frombuffer(nodes_b, np.float64),
                      np.frombuffer(alive_b, np.bool_), s)
    a.setflags(write=False)
    return a


def rs_decode_weights(nodes: np.ndarray, alive: np.ndarray, s: int) -> np.ndarray:
    """Closed-form RS decode (paper property T2), LRU-cached per pattern.

    Builds p(x) = Π_{j ∈ dead}(x − α_j), padded with extra alive roots if
    fewer than s workers actually straggled (keeps deg p ≤ s while zeroing
    exactly the dead coordinates — extra zeroed alive workers are simply
    not used).  Weights are a_m = p(α_m) / p(1); then
    aᵀB = (D·A·B)/p(1) = p(1)·1ᵀ/p(1) = 1ᵀ.

    Results are memoized on ``(nodes, alive, s)`` value bytes; the
    returned array is always a fresh writable copy (no aliasing of the
    cache — mutating a result does not change future calls).
    """
    nodes = np.ascontiguousarray(nodes, dtype=np.float64)
    alive = np.ascontiguousarray(alive, dtype=bool)
    n_dead = int((~alive).sum())
    if n_dead > s:
        raise ValueError(f"{n_dead} stragglers exceed tolerance s={s}")
    return _rs_decode_cached(nodes.tobytes(), alive.tobytes(),
                             int(s)).copy()


def _frs_decode(scheme: CodingScheme, alive: np.ndarray) -> Optional[np.ndarray]:
    g = scheme.group_size
    M = scheme.M
    a = np.zeros(M)
    for grp in range(M // g):
        rows = np.arange(grp * g, (grp + 1) * g)
        alive_rows = rows[alive[rows]]
        if len(alive_rows) == 0:
            return None  # whole group straggled — unrecoverable
        a[alive_rows[0]] = 1.0
    return a


def decode_weights(scheme: CodingScheme, alive: np.ndarray, *,
                   tol: float = 1e-7) -> np.ndarray:
    """Decode weights for the realized straggler pattern.

    Raises ValueError when the pattern is unrecoverable (more stragglers
    than the code tolerates) — callers treat that as a failed epoch and
    fall back to re-execution (fault-tolerance path).
    """
    alive = np.asarray(alive, dtype=bool)
    if alive.shape != (scheme.M,):
        raise ValueError(f"alive mask shape {alive.shape} != ({scheme.M},)")
    n_dead = int((~alive).sum())
    if scheme.kind == "uncoded":
        if n_dead:
            raise ValueError("uncoded scheme cannot tolerate stragglers")
        return np.ones(scheme.M)
    if scheme.kind == "fractional":
        a = _frs_decode(scheme, alive)
        if a is None:
            raise ValueError("FRS: an entire group straggled")
        return a
    if scheme.kind == "vandermonde" and n_dead <= scheme.s:
        a = rs_decode_weights(scheme.nodes, alive, scheme.s)
        resid = float(np.max(np.abs(a @ scheme.B - 1.0)))
        if resid <= max(tol, 1e-6 * max(1.0, np.max(np.abs(a)))):
            return a
        # numerically ill-conditioned pattern — fall through to LS
    a = solve_decode(scheme.B, alive, tol=tol)
    if a is None:
        raise ValueError(
            f"unrecoverable straggler pattern ({n_dead} dead, s={scheme.s})")
    return a
