"""Gradient-coding matrix constructions (paper §III.1, §4.2).

A numpy copy of ``repro.core.coding.matrices``, kept so that the port
never imports the JAX package; bit-identical to it.

A coding scheme assigns each worker ``m`` a row ``b_m`` of a coefficient
matrix ``B ∈ R^{M×K}``; the worker returns the *coded* partial gradient
``ĝ_m = Σ_k B[m,k] · g_k``.  Recovery of the full gradient ``Σ_k g_k`` from
any ``M−s`` workers requires the span condition (Lemma 1):

    for every alive-set ``I`` with ``|I| = M−s``:  ``1₁ₓK ∈ span{b_m : m∈I}``

Constructions implemented:
  * ``cyclic_repetition``      — CRS baseline (Tandon-style, paper's baseline)
  * ``fractional_repetition``  — FRS baseline (paper's baseline)
  * ``vandermonde_code``       — Reed–Solomon-style code over an arbitrary
    support structure; this is the concrete realization of the paper's
    Lemma-2 construction (T1: any s+1 columns of the Vandermonde auxiliary
    matrix A are linearly independent; T2: the decode vector D is the
    coefficient vector of the polynomial vanishing on the stragglers;
    T3: the uncoded stage-1 rows decode with C = 1).

All control-plane math is host-side numpy (float64); only the resulting
coefficient/decode vectors are shipped to devices as runtime data.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "CodingScheme",
    "build_static_scheme",
    "cyclic_repetition",
    "fractional_repetition",
    "uncoded",
    "vandermonde_code",
    "allocate_supports",
    "default_nodes",
]


@dataclasses.dataclass(frozen=True)
class CodingScheme:
    """A concrete coding matrix plus the metadata needed to decode it.

    Attributes:
      B:          (M, K) dense coefficient matrix (zeros = unassigned).
      s:          number of stragglers tolerated among the M rows.
      kind:       'cyclic' | 'fractional' | 'uncoded' | 'vandermonde'.
      nodes:      per-worker evaluation nodes for RS decode (None unless
                  kind == 'vandermonde').
      workers:    global worker ids for the rows (len M).
      partitions: global partition ids for the columns (len K).
      group_size: FRS group size (s+1) when kind == 'fractional'.
    """

    B: np.ndarray
    s: int
    kind: str
    nodes: Optional[np.ndarray] = None
    workers: Optional[np.ndarray] = None
    partitions: Optional[np.ndarray] = None
    group_size: int = 0

    def __post_init__(self):
        object.__setattr__(self, "B", np.asarray(self.B, dtype=np.float64))
        if self.workers is None:
            object.__setattr__(self, "workers", np.arange(self.M))
        if self.partitions is None:
            object.__setattr__(self, "partitions", np.arange(self.K))

    @property
    def M(self) -> int:
        return self.B.shape[0]

    @property
    def K(self) -> int:
        return self.B.shape[1]

    @property
    def support(self) -> np.ndarray:
        """Boolean (M, K) assignment mask."""
        return self.B != 0.0

    @property
    def copies_per_worker(self) -> np.ndarray:
        return self.support.sum(axis=1)

    @property
    def redundancy(self) -> float:
        """Total partition copies / K  (1.0 = no redundancy)."""
        return float(self.support.sum()) / max(self.K, 1)


def build_static_scheme(name: str, M: int, K: int, s: int) -> "CodingScheme":
    """The paper's single-stage baselines by name (shared by the trainer
    and the co-simulator so their preconditions cannot drift)."""
    if name == "cyclic":
        if K != M:
            raise ValueError("CRS baselines use K == M partitions")
        return cyclic_repetition(M, s)
    if name == "fractional":
        return fractional_repetition(M, s)
    if name == "uncoded":
        return uncoded(M, K)
    raise ValueError(f"unknown static scheme {name!r}")


def default_nodes(n: int) -> np.ndarray:
    """Distinct evaluation nodes, all != 1 and != 0, well conditioned.

    Chebyshev-like points in (-1, 1) scaled away from 1; float64 RS decode
    stays well-conditioned for the worker counts we target (M ≤ a few
    hundred rows per coding group).
    """
    k = np.arange(n)
    nodes = np.cos((2 * k + 1) * np.pi / (2 * n)) * 0.9 - 2.0  # in (-2.9, -1.1)
    return nodes


def uncoded(M: int, K: int, *, workers=None, partitions=None) -> CodingScheme:
    """Disjoint round-robin assignment, coefficient 1 (stage-1 scheme).

    Worker m is responsible for partitions {k : k ≡ m (mod M)}.  Recovery
    requires *all* M workers (s = 0); the sum of returned coded gradients is
    exactly Σ_k g_k.
    """
    B = np.zeros((M, K))
    for k in range(K):
        B[k % M, k] = 1.0
    return CodingScheme(B=B, s=0, kind="uncoded", workers=workers, partitions=partitions)


def cyclic_repetition(M: int, s: int, *, K: Optional[int] = None) -> CodingScheme:
    """Cyclic Repetition Scheme (CRS): worker m covers partitions
    m, m+1, …, m+s (mod K), K = M by convention.

    Coefficients are from the Vandermonde (RS) solve on the cyclic support so
    the span condition holds deterministically for any s stragglers.
    """
    if K is None:
        K = M
    if K != M:
        raise ValueError("CRS assumes K == M")
    if not 0 <= s < M:
        raise ValueError(f"need 0 <= s < M, got s={s} M={M}")
    support = [[(k + j) % M for j in range(s + 1)] for k in range(K)]
    # support[k] = worker list for partition k -> worker m covers m-j mod M
    nodes = default_nodes(M)
    B = _solve_columns(M, K, support, nodes, s)
    return CodingScheme(B=B, s=s, kind="vandermonde", nodes=nodes)


def fractional_repetition(M: int, s: int) -> CodingScheme:
    """Fractional Repetition Scheme (FRS).  Requires (s+1) | M.

    Workers are split into M/(s+1) groups of (s+1); every worker in group g
    computes the same block of (s+1) partitions with coefficient 1.  Any
    M−s alive workers contain ≥1 worker per group; decode picks one
    representative per group with weight 1.
    """
    if (s + 1) <= 0 or M % (s + 1) != 0:
        raise ValueError(f"FRS needs (s+1) | M, got M={M}, s={s}")
    K = M
    g = s + 1
    n_groups = M // g
    B = np.zeros((M, K))
    per_group = K // n_groups  # = g
    for grp in range(n_groups):
        rows = range(grp * g, (grp + 1) * g)
        cols = range(grp * per_group, (grp + 1) * per_group)
        for r in rows:
            for c in cols:
                B[r, c] = 1.0
    return CodingScheme(B=B, s=s, kind="fractional", group_size=g)


def _solve_columns(M: int, K: int, support: Sequence[Sequence[int]],
                   nodes: np.ndarray, s: int) -> np.ndarray:
    """Per-column coefficient solve: b_k = A[:, S_k]^{-1} · 1.

    A[i, m] = nodes[m]**i is the (s+1)×M Vandermonde auxiliary matrix
    (paper's T1 matrix).  Any (s+1) columns are linearly independent, so the
    (s+1)×(s+1) subsystem is invertible and A @ B == 1_{(s+1)×K} exactly.
    """
    B = np.zeros((M, K))
    A = np.vander(nodes, N=s + 1, increasing=True).T  # (s+1, M)
    ones = np.ones(s + 1)
    for k, S_k in enumerate(support):
        S_k = list(S_k)
        if len(S_k) != s + 1:
            raise ValueError(f"partition {k}: support size {len(S_k)} != s+1={s + 1}")
        sub = A[:, S_k]
        b = np.linalg.solve(sub, ones)
        B[S_k, k] = b
    return B


def allocate_supports(K: int, s: int, capacities: np.ndarray) -> list[list[int]]:
    """Assign each of K partitions to exactly (s+1) distinct workers, with
    worker m receiving ≈ capacities[m] total copies (Eq. 16 loads).

    Greedy largest-remaining-capacity selection; feasible whenever
    Σ capacities ≥ (s+1)·K (capacities are scaled up if short) and
    M ≥ s+1.  Deterministic.
    """
    capacities = np.asarray(capacities, dtype=np.float64).copy()
    M = len(capacities)
    if M < s + 1:
        raise ValueError(f"need at least s+1={s + 1} workers, got {M}")
    need = (s + 1) * K
    total = capacities.sum()
    if total <= 0:
        capacities = np.ones(M)
        total = float(M)
    if total < need:
        capacities = capacities * (need / total)
    remaining = capacities.astype(np.float64)
    support: list[list[int]] = []
    for _ in range(K):
        # pick the s+1 workers with most remaining capacity (ties by index)
        order = np.lexsort((np.arange(M), -remaining))
        chosen = sorted(order[: s + 1].tolist())
        support.append(chosen)
        remaining[chosen] -= 1.0
    return support


def vandermonde_code(K: int, s: int, capacities: np.ndarray, *,
                     workers: Optional[np.ndarray] = None,
                     partitions: Optional[np.ndarray] = None,
                     nodes: Optional[np.ndarray] = None) -> CodingScheme:
    """RS-style code over a capacity-weighted support (Lemma 2 realization).

    ``capacities[m]`` is the Eq.-16 load n_m for worker m; each partition is
    covered by exactly s+1 workers.
    """
    M = len(capacities)
    support = allocate_supports(K, s, capacities)
    if nodes is None:
        nodes = default_nodes(M)
    B = _solve_columns(M, K, support, nodes, s)
    return CodingScheme(B=B, s=s, kind="vandermonde", nodes=nodes,
                        workers=workers, partitions=partitions)
