"""Federated-edge-learning trainer: wires dataset + runtime + coded step.

The torch counterpart of ``repro.core.fel``.  It runs the paper's four
schemes under identical sampled worker behaviour:
  * 'two-stage'  — TSDCFL (the paper's contribution)
  * 'cyclic'     — Cyclic Repetition baseline
  * 'fractional' — Fractional Repetition baseline
  * 'uncoded'    — no redundancy (must wait for every worker)

All schemes recover the *exact* full gradient when enough workers return,
so epoch-based convergence is identical (paper Fig 5a/6a); wall-clock
differs (Fig 5e/6e).

Two epoch-simulation backends:

  * the instant-uplink path (default) — compute time only, the uplink is
    free, decode fires when enough workers have *computed*;
  * ``cluster=`` an ``repro_torch.sim.cluster.EdgeCluster`` or a
    declarative ``repro_torch.sim.spec.ScenarioSpec`` (built for this
    trainer's scheme and seed by ``build_cluster``) — the closed-loop
    co-simulator: coded partial gradients drain through the Lyapunov P4–P7
    scheduler and decode fires only once enough contributions have
    *arrived*, so every ``EpochLog`` carries a compute/comm breakdown.

Each epoch's host outcomes come from numpy in float64, bit-equal to the
reference's; the step runs on ``device`` (the card unless the caller asks
for ``"cpu"``), one backward over the weighted per-slot losses.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.coded_step import (build_slot_plan,
                                         make_coded_train_step, slot_batch,
                                         slot_weights)
from repro_torch.core.runtime import (build_epoch_backend,
                                      simulate_epoch_single_stage)
from repro_torch.optim.optimizers import tree_map

__all__ = ["EpochLog", "FELTrainer"]


@dataclasses.dataclass
class EpochLog:
    epoch: int
    loss: float
    time: float
    utilization: float
    n_stragglers: int
    redundancy: float
    efficiency: float = 0.0
    compute_time: float = 0.0
    comm_time: float = 0.0
    decode_ok: bool = True


class FELTrainer:
    """One object per (scheme × cluster) experiment.

    ``per_slot_loss(params, slot_batch) -> (M, n_slots)`` is the model's
    per-slot mean loss (``models.mlp.per_slot_mlp_loss`` for the paper's
    MLP); ``params`` is moved to ``device``.  The dataset may live on the
    host: each epoch's slot batch is stacked there and copied to ``device``
    once.

    ``phase_timer(name, epoch)``, when given, is a context-manager factory
    wrapped around each phase of :meth:`run_epoch`: ``plan`` (the epoch's
    simulation and slot weights), ``draw`` (the partitions), ``stack``,
    ``copy`` (to ``device``) and ``step``.
    """

    def __init__(self, scheme: str, M: int, K: int, dataset, per_slot_loss,
                 optimizer, params, *, M1: Optional[int] = None,
                 s: Optional[int] = None,
                 rates: Optional[np.ndarray] = None,
                 noise_scale: Optional[float] = None,
                 fault_prob: Optional[float] = None,
                 straggler_prob: Optional[float] = None,
                 straggler_slow: Optional[float] = None, seed: int = 0,
                 n_slots: Optional[int] = None, cluster=None,
                 device="cuda", phase_timer: Optional[Callable] = None):
        self.device = torch.device(device)
        self._phase_timer = phase_timer
        if self.device.type == "cuda":
            # the reference computes float32 products in full float32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.scheme_name = scheme
        self.dataset = dataset
        self.params = tree_map(lambda p: p.to(self.device), params)
        self.opt_state = optimizer.init(self.params)
        self.step_fn = make_coded_train_step(per_slot_loss, optimizer)
        self._rng = np.random.default_rng(seed + 99)
        self.logs: list = []
        if cluster is not None and not hasattr(cluster, "run_epoch"):
            # declarative path: a ScenarioSpec is resolved for this
            # trainer's scheme and seed through the one spec resolver
            from repro_torch.sim.spec import ScenarioSpec, build_cluster
            if not isinstance(cluster, ScenarioSpec):
                raise TypeError(f"cluster= wants an EdgeCluster or a "
                                f"ScenarioSpec, got {type(cluster).__name__}")
            cluster = build_cluster(cluster, scheme, seed,
                                    device=self.device)
        self.cluster = cluster

        if cluster is not None:
            # co-simulated path: the EdgeCluster owns compute + channel
            # sampling and produces the plan/weights per epoch — reject
            # simulation-physics kwargs instead of silently dropping them.
            conflicting = {k: v for k, v in dict(
                M1=M1, s=s, rates=rates, noise_scale=noise_scale,
                fault_prob=fault_prob, straggler_prob=straggler_prob,
                straggler_slow=straggler_slow, n_slots=n_slots).items()
                if v is not None}
            if conflicting:
                raise ValueError(
                    "cluster= owns the simulation physics; configure the "
                    "EdgeCluster/scenario instead of passing "
                    f"{sorted(conflicting)}")
            if (cluster.M, cluster.K) != (M, K):
                raise ValueError(
                    f"cluster is (M={cluster.M}, K={cluster.K}), trainer "
                    f"wants (M={M}, K={K})")
            if cluster.scheme != scheme:
                raise ValueError(f"cluster simulates {cluster.scheme!r}, "
                                 f"trainer is {scheme!r}")
            self.M, self.K, self.s = M, K, cluster.s
            self.runtime = cluster.runtime
            self.static_scheme = cluster.static_scheme
            self.rates = np.asarray(cluster.rates, np.float64)
            self.n_slots = cluster.n_slots
            return

        s = 1 if s is None else s
        self.M, self.K, self.s = M, K, s
        self.rates = np.asarray(rates if rates is not None else np.ones(M),
                                np.float64)
        self.runtime, self.static_scheme, self.time_model, self.n_slots = \
            build_epoch_backend(
                scheme, M, K, M1=M1, s=s, rates=self.rates,
                noise_scale=0.2 if noise_scale is None else noise_scale,
                fault_prob=fault_prob or 0.0,
                straggler_prob=straggler_prob or 0.0,
                straggler_slow=(8.0 if straggler_slow is None
                                else straggler_slow),
                seed=seed, n_slots=n_slots)

    # ------------------------------------------------------------------ #
    def _phase(self, name: str, epoch: int):
        if self._phase_timer is None:
            return contextlib.nullcontext()
        return self._phase_timer(name, epoch)

    def run_epoch(self, epoch: int) -> EpochLog:
        with self._phase("plan", epoch):
            plan, w, log = self._plan(epoch)
        batch = slot_batch(self.dataset, epoch, plan, self.device,
                           lambda name: self._phase(name, epoch))
        with self._phase("step", epoch):
            self.params, self.opt_state, aux = self.step_fn(
                self.params, self.opt_state, batch,
                torch.as_tensor(w, dtype=torch.float32, device=self.device))
            # failed decode ⟹ all-zero weights ⟹ aux['loss'] is a
            # meaningless 0.0 — log NaN so curves show a gap, not a dip
            log.loss = float(aux["loss"]) if log.decode_ok else float("nan")
        self.logs.append(log)
        return log

    def _plan(self, epoch: int):
        """The epoch's slot plan, its ``(M, n_slots)`` weights and its log
        (without the loss), from the co-sim, the two-stage runtime or the
        single-stage baseline."""
        compute_t = comm_t = 0.0
        decode_ok = True
        if self.cluster is not None or self.scheme_name == "two-stage":
            src = self.cluster if self.cluster is not None else self.runtime
            res = src.run_epoch(epoch)
            plan, w = res.plan, res.weights
            time, util = res.time, res.utilization
            n_str, red = res.n_stragglers, res.redundancy
            eff = res.compute_efficiency
            compute_t, comm_t = res.compute_time, res.comm_time
            decode_ok = res.decode_ok
        else:
            sim = simulate_epoch_single_stage(self.static_scheme,
                                              self.time_model, self._rng)
            plan = build_slot_plan([self.static_scheme], self.M,
                                   self.n_slots)
            w = slot_weights(plan, sim["decode_w"])
            time = sim["time"]
            util = min(sim["useful_task_time"]
                       / (self.M * max(sim["time"], 1e-12)), 1.0)
            n_str = int(self.M - sim["alive"].sum())
            red = sim["redundancy"]
            eff = min(self.K / max(sim["executed_tasks"], 1e-12), 1.0)
            compute_t, decode_ok = time, sim["ok"]
        return plan, np.asarray(w), EpochLog(
            epoch=epoch, loss=float("nan"), time=time, utilization=util,
            n_stragglers=n_str, redundancy=red, efficiency=eff,
            compute_time=compute_t, comm_time=comm_t, decode_ok=decode_ok)

    def run(self, n_epochs: int) -> list:
        return [self.run_epoch(e) for e in range(n_epochs)]
