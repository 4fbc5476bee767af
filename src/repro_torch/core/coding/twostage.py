"""Two-stage dynamic coded strategy (paper §III.2 + §4.2).

A numpy copy of ``repro.core.coding.twostage``, kept so that the port
never imports the JAX package; bit-identical to it.

Stage 1: ``M₁`` of ``M`` workers start **uncoded** on a disjoint split of the
K partitions for a deadline ``T_comp``.  When the deadline fires, ``M_c``
workers have finished, covering ``K_c`` partitions.

Stage 2: the ``M₁−M_c`` unfinished workers continue, and the ``M−M₁`` fresh
workers start, under a Vandermonde (Lemma-2) code over only the ``K−K_c``
uncovered partitions, robust to any ``s`` stragglers among the active
workers.  Per-worker load follows Eq. 16:

    n_m = ((K−K_c)(s+1) − Σ_l n_l) · W_m / Σ_{l∈fresh} W_l

where Σ_l n_l are the copies the continuing workers already hold.  If
``K_c == K`` the code is never triggered (paper's fast path).

Deviation (documented in DESIGN.md §2): continuing workers participate in
the stage-2 *coefficient solve* (their rows are re-coded over their remaining
partitions) rather than keeping raw coefficient-1 rows as in the paper's
Example 1; this makes the span condition hold deterministically for every
straggler pattern instead of generically.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .matrices import CodingScheme, default_nodes, uncoded, vandermonde_code

__all__ = ["Stage1Plan", "Stage2Plan", "TwoStagePlanner"]


@dataclasses.dataclass(frozen=True)
class Stage1Plan:
    scheme: CodingScheme          # uncoded, rows = stage-1 workers
    workers: np.ndarray           # global ids of the M1 stage-1 workers
    partitions: np.ndarray        # global ids (= arange(K))

    @property
    def M1(self) -> int:
        return len(self.workers)


@dataclasses.dataclass(frozen=True)
class Stage2Plan:
    scheme: Optional[CodingScheme]  # None when K_c == K (code not triggered)
    active_workers: np.ndarray      # global ids, rows of scheme.B
    uncovered_partitions: np.ndarray
    covered_partitions: np.ndarray
    finished_workers: np.ndarray    # the M_c stage-1 finishers

    @property
    def triggered(self) -> bool:
        return self.scheme is not None


class TwoStagePlanner:
    """Builds stage-1 and stage-2 plans for each epoch.

    Args:
      M:  total workers.
      K:  data partitions.
      M1: stage-1 worker count (paper: randomly selected; we rotate the
          selection deterministically by epoch for fairness, or take the
          predicted-fastest M1 when speeds are provided).
      select: 'rotate' | 'fastest'.
    """

    def __init__(self, M: int, K: int, M1: int, *, select: str = "rotate",
                 seed: int = 0):
        if not 1 <= M1 <= M:
            raise ValueError(f"need 1 <= M1 <= M, got M1={M1}, M={M}")
        self.M, self.K, self.M1 = M, K, M1
        self.select = select
        self._rng = np.random.default_rng(seed)

    # ------------------------------------------------------------------ #
    def plan_stage1(self, epoch: int, speeds: Optional[np.ndarray] = None
                    ) -> Stage1Plan:
        if self.select == "fastest" and speeds is not None:
            order = np.argsort(-np.asarray(speeds))
            workers = np.sort(order[: self.M1])
        else:  # rotate through the pool so stage-1 duty is shared
            start = (epoch * self.M1) % self.M
            workers = (start + np.arange(self.M1)) % self.M
            workers = np.sort(workers)
        partitions = np.arange(self.K)
        scheme = uncoded(self.M1, self.K, workers=workers,
                         partitions=partitions)
        if speeds is not None:
            # heterogeneity-aware disjoint split: partition counts ∝ W_m
            # (the paper's Eq-16 load principle, applied at stage 1 so slow
            #  workers aren't structurally doomed to miss the deadline)
            from .matrices import allocate_supports
            caps = np.asarray(speeds, np.float64)[workers]
            caps = caps / max(caps.sum(), 1e-12) * self.K
            support = allocate_supports(self.K, 0, caps)
            B = np.zeros((self.M1, self.K))
            for k, (m,) in enumerate(support):
                B[m, k] = 1.0
            scheme = dataclasses.replace(scheme, B=B)
        return Stage1Plan(scheme=scheme, workers=workers,
                          partitions=partitions)

    # ------------------------------------------------------------------ #
    def plan_stage1_batched(self, epoch: int, speeds: np.ndarray
                            ) -> "list[Stage1Plan]":
        """S seeds' stage-1 plans at once from an (S, M) speed stack —
        bitwise identical to S :meth:`plan_stage1` calls.

        The per-seed greedy Eq.-16 split (``allocate_supports`` with
        ``s = 0``) is re-expressed as K vectorized argmax steps over the
        whole stack: ``np.lexsort((arange, -remaining))[0]`` is exactly
        "first index attaining the max", which is ``np.argmax`` row-wise.
        """
        speeds = np.asarray(speeds, np.float64)
        S = speeds.shape[0]
        M1, K = self.M1, self.K
        if self.select == "fastest":
            workers = np.stack([
                np.sort(np.argsort(-speeds[i])[:M1]) for i in range(S)])
        else:
            start = (epoch * M1) % self.M
            w = np.sort((start + np.arange(M1)) % self.M)
            workers = np.broadcast_to(w, (S, M1))
        partitions = np.arange(K)

        # allocate_supports(K, 0, caps), vectorized across seeds
        caps = np.take_along_axis(speeds, workers, axis=1)
        caps = caps / np.maximum(caps.sum(axis=1), 1e-12)[:, None] * K
        total = caps.sum(axis=1)
        caps = np.where((total <= 0)[:, None], np.ones((S, M1)), caps)
        total = np.where(total <= 0, float(M1), total)
        need = float(K)
        caps = np.where((total < need)[:, None],
                        caps * (need / total)[:, None], caps)
        remaining = caps.astype(np.float64)
        rows = np.arange(S)
        B = np.zeros((S, M1, K))
        for k in range(K):
            m = np.argmax(remaining, axis=1)    # ties → lowest index
            B[rows, m, k] = 1.0
            remaining[rows, m] -= 1.0

        return [Stage1Plan(
            scheme=CodingScheme(B=B[i], s=0, kind="uncoded",
                                workers=workers[i], partitions=partitions),
            workers=workers[i], partitions=partitions) for i in range(S)]

    # ------------------------------------------------------------------ #
    def plan_stage2(self, stage1: Stage1Plan, finished_mask: np.ndarray,
                    s: int, speeds: np.ndarray) -> Stage2Plan:
        """Build the stage-2 code from the observed stage-1 completions.

        Args:
          finished_mask: bool (M1,) — which stage-1 workers finished by the
            deadline (the paper's M_c set).
          s: straggler tolerance for stage 2 (dynamically predicted).
          speeds: (M,) historical speeds W_m for Eq. 16.
        """
        finished_mask = np.asarray(finished_mask, dtype=bool)
        if finished_mask.shape != (stage1.M1,):
            raise ValueError("finished_mask must have shape (M1,)")
        speeds = np.asarray(speeds, dtype=np.float64)

        finished_workers = stage1.workers[finished_mask]
        continuing_workers = stage1.workers[~finished_mask]
        fresh_workers = np.setdiff1d(np.arange(self.M), stage1.workers)
        active_workers = np.concatenate([continuing_workers, fresh_workers])

        # Covered partitions: union of finished workers' stage-1 assignments.
        B1 = stage1.scheme.B  # (M1, K), rows aligned with stage1.workers
        covered_cols = (B1[finished_mask] != 0).any(axis=0)
        covered = stage1.partitions[covered_cols]
        uncovered = stage1.partitions[~covered_cols]
        K_rem = len(uncovered)

        if K_rem == 0 or len(active_workers) == 0:
            return Stage2Plan(scheme=None, active_workers=active_workers,
                              uncovered_partitions=uncovered,
                              covered_partitions=covered,
                              finished_workers=finished_workers)

        s = int(min(s, len(active_workers) - 1))
        s = max(s, 0)

        # Eq. 16 capacities. Continuing worker l: n_l = its count of still-
        # uncovered stage-1 partitions.  Fresh worker m: share of the
        # remaining copies proportional to W_m.
        n_cont = (B1[~finished_mask][:, ~covered_cols] != 0).sum(axis=1)
        n_cont = n_cont.astype(np.float64)
        total_copies = (K_rem) * (s + 1)
        remaining_copies = max(total_copies - float(n_cont.sum()), 0.0)
        W_fresh = speeds[fresh_workers] if len(fresh_workers) else np.zeros(0)
        if len(fresh_workers):
            W_sum = float(W_fresh.sum())
            if W_sum <= 0:
                W_fresh = np.ones(len(fresh_workers))
                W_sum = float(len(fresh_workers))
            n_fresh = remaining_copies * W_fresh / W_sum
        else:
            n_fresh = np.zeros(0)
        capacities = np.concatenate([n_cont, n_fresh])

        nodes = default_nodes(self.M)[active_workers]
        scheme = vandermonde_code(K_rem, s, capacities,
                                  workers=active_workers,
                                  partitions=uncovered, nodes=nodes)
        return Stage2Plan(scheme=scheme, active_workers=active_workers,
                          uncovered_partitions=uncovered,
                          covered_partitions=covered,
                          finished_workers=finished_workers)

    # ------------------------------------------------------------------ #
    def plan_stage2_batched(self, st1s: Sequence[Stage1Plan],
                            finished_masks: np.ndarray,
                            s_hats: np.ndarray,
                            speeds: np.ndarray) -> "List[Stage2Plan]":
        """S seeds' stage-2 plans at once — bitwise identical to S
        :meth:`plan_stage2` calls.

        Lanes are partitioned by their *ragged-shape signature*
        ``(K_rem, s, n_active)`` — lanes with equal signatures share every
        array shape of the stage-2 construction even though their covered
        sets, active ids and Eq.-16 capacities differ — and each group
        runs the expensive steps stacked:

          * the greedy capacity-weighted support allocation
            (``allocate_supports``) becomes ``K_rem`` vectorized
            stable-argsort steps over the group (``np.argsort(-remaining,
            kind='stable')`` is exactly ``np.lexsort((arange,
            -remaining))``, the scalar tie rule);
          * the per-column Vandermonde coefficient solves become one
            stacked ``np.linalg.solve`` over ``(G·K_rem)`` little
            ``(s+1)×(s+1)`` systems (the gufunc applies the same LAPACK
            routine per matrix, so rows are bitwise the scalar solves);
          * the Vandermonde powers are built with the same cumulative
            products ``np.vander`` uses (``multiply.accumulate``), not
            ``x**i`` — the two pair multiplications differently.

        Non-triggered lanes (``K_rem == 0`` or no active workers) take
        the scalar fast path unchanged.
        """
        finished_masks = np.asarray(finished_masks, dtype=bool)
        speeds = np.asarray(speeds, dtype=np.float64)
        S = len(st1s)
        if finished_masks.shape != (S, self.M1):
            raise ValueError(f"finished_masks must have shape "
                             f"({S}, {self.M1})")
        plans: List[Optional[Stage2Plan]] = [None] * S
        prep: Dict[int, Tuple] = {}
        groups: Dict[Tuple[int, int, int], List[int]] = {}
        all_workers = np.arange(self.M)
        for i, st1 in enumerate(st1s):
            fm = finished_masks[i]
            B1 = st1.scheme.B
            covered_cols = (B1[fm] != 0).any(axis=0)
            covered = st1.partitions[covered_cols]
            uncovered = st1.partitions[~covered_cols]
            finished_workers = st1.workers[fm]
            continuing = st1.workers[~fm]
            fresh = np.setdiff1d(all_workers, st1.workers)
            active = np.concatenate([continuing, fresh])
            K_rem = len(uncovered)
            if K_rem == 0 or len(active) == 0:
                plans[i] = Stage2Plan(scheme=None, active_workers=active,
                                      uncovered_partitions=uncovered,
                                      covered_partitions=covered,
                                      finished_workers=finished_workers)
                continue
            s = max(int(min(s_hats[i], len(active) - 1)), 0)
            n_cont = (B1[~fm][:, ~covered_cols] != 0).sum(axis=1)
            prep[i] = (active, uncovered, covered, finished_workers, fresh,
                       n_cont.astype(np.float64))
            groups.setdefault((K_rem, s, len(active)), []).append(i)

        nodes_all = default_nodes(self.M)
        for (K_rem, s, n_act), idxs in groups.items():
            G = len(idxs)
            active = np.stack([prep[i][0] for i in idxs])      # (G, n_act)
            fresh = np.stack([prep[i][4] for i in idxs])       # (G, n_fr)
            n_cont = np.stack([prep[i][5] for i in idxs])      # (G, n_ct)
            spd = speeds[idxs]

            # Eq.-16 capacities, stacked (same elementwise order of ops
            # as the scalar path: (copies · W) / ΣW)
            total_copies = K_rem * (s + 1)
            remaining_copies = np.maximum(
                total_copies - n_cont.sum(axis=1), 0.0)
            n_fr = fresh.shape[1]
            if n_fr:
                W = np.take_along_axis(spd, fresh, axis=1)
                W_sum = W.sum(axis=1)
                bad = W_sum <= 0
                W = np.where(bad[:, None], 1.0, W)
                W_sum = np.where(bad, float(n_fr), W_sum)
                n_fresh = remaining_copies[:, None] * W / W_sum[:, None]
                caps = np.concatenate([n_cont, n_fresh], axis=1)
            else:
                caps = n_cont

            # allocate_supports(K_rem, s, caps), vectorized over the group
            need = (s + 1) * K_rem
            total = caps.sum(axis=1)
            zero = total <= 0
            caps = np.where(zero[:, None], 1.0, caps)
            total = np.where(zero, float(n_act), total)
            caps = np.where((total < need)[:, None],
                            caps * (need / total)[:, None], caps)
            remaining = caps.astype(np.float64, copy=True)
            supports = np.empty((G, K_rem, s + 1), np.int64)
            g_rows = np.arange(G)[:, None]
            for k in range(K_rem):
                order = np.argsort(-remaining, axis=1,
                                   kind="stable")[:, : s + 1]
                chosen = np.sort(order, axis=1)    # distinct ids per row
                supports[:, k] = chosen
                remaining[g_rows, chosen] -= 1.0

            # Vandermonde powers exactly as np.vander builds them
            nd = nodes_all[active]                             # (G, n_act)
            V = np.empty((G, n_act, s + 1))
            V[..., 0] = 1.0
            if s > 0:
                V[..., 1:] = nd[..., None]
                np.multiply.accumulate(V[..., 1:], axis=-1,
                                       out=V[..., 1:])
            A = V.swapaxes(1, 2)                          # (G, s+1, n_act)
            subs = np.take_along_axis(A[:, None, :, :],
                                      supports[:, :, None, :],
                                      axis=3)         # (G, K, s+1, s+1)
            b = np.linalg.solve(
                subs, np.broadcast_to(np.ones(s + 1)[:, None],
                                      (G, K_rem, s + 1, 1)))[..., 0]
            B = np.zeros((G, n_act, K_rem))
            B[g_rows[:, :, None], supports,
              np.arange(K_rem)[None, :, None]] = b

            for g, i in enumerate(idxs):
                active_i, uncovered_i, covered_i, finished_i, _, _ = prep[i]
                scheme = CodingScheme(B=B[g], s=s, kind="vandermonde",
                                      nodes=nd[g], workers=active_i,
                                      partitions=uncovered_i)
                plans[i] = Stage2Plan(scheme=scheme,
                                      active_workers=active_i,
                                      uncovered_partitions=uncovered_i,
                                      covered_partitions=covered_i,
                                      finished_workers=finished_i)
        assert all(p is not None for p in plans), \
            "plan_stage2_batched left an unplanned lane"
        return plans
