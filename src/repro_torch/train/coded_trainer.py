"""CodedTrainer: a real torch model trained through the co-simulated uplink.

The torch counterpart of ``repro.train.coded_trainer``.  By default it
trains the transformer of its ``cfg`` (``repro_torch.models.transformer``);
a caller passes ``loss_fn=`` (or ``grad_fn=``) and ``params=`` with
``cfg=None`` for another model, such as the paper's MLP.  Per epoch:

  1. **shard gradients** — one backward pass per data shard k of the real
     model (``loss_fn(params, D_k)``), each flattened straight into row k
     of a preallocated ``G ∈ (K, D)`` f32;
  2. **co-sim epoch** — ``EdgeCluster.run_epoch`` samples the compute
     phase and drains each worker's *measured* payload (the flattened
     gradient's size) through the Lyapunov scheduler; decode is gated on
     byte arrival;
  3. **encode** — worker uploads ``ĝ_m = Σ_k B_eff[m,k]·g_k`` where
     ``B_eff`` is the epoch's effective coding matrix read off the slot
     plan (stage-1 + stage-2 rows for two-stage) — a plain matrix
     product;
  4. **decode** — the engine's ``(M, n_slots)`` weight matrix factors as
     ``w[m,s] = a_m·coeff[m,s]``, so the per-worker decode weights ``a``
     are recovered exactly and the arrived uploads are reduced by the
     hand-written ``coded_reduce`` kernel: ``Σ_m a_m ĝ_m = Σ_k g_k``, the
     exact full-batch gradient;
  5. **step** — one optimizer update on the decoded gradient, or the
     paper's *no-op step* when decode failed: params and optimizer state
     are left untouched (the same tensors), the epoch burned simulated
     wall-clock only.

The trainer turns TF32 off for matrix products and cuDNN on the card, as
the reference computes float32 products in full float32; a model whose
``compute_dtype`` is bfloat16 computes in bfloat16 all the same, as in the
reference.  The gradients, uploads and decode are float32.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch.core.coded_step import _value_and_grad
from repro_torch.core.runtime import EpochResult
from repro_torch.kernels.coded_reduce import coded_reduce
from repro_torch.models import transformer
from repro_torch.optim.optimizers import tree_map
from repro_torch.sim.spec import ScenarioSpec, build_cluster
from repro_torch.telemetry.recorder import FleetRecorder, phase_span
from repro_torch.train.partition import (DEFAULT_BYTES_PER_UNIT,
                                         GradPartition)

__all__ = ["CodedTrainer", "TrainEpochLog", "decode_weights_from_result",
           "effective_code_matrix"]


@dataclasses.dataclass
class TrainEpochLog:
    """One bridge epoch: losses are real-model, times are co-simulated."""
    epoch: int
    loss: float                 # pre-step full-batch loss (NaN on no-op)
    time: float                 # simulated epoch wall-clock
    compute_time: float
    comm_time: float
    decode_ok: bool
    n_slots: int                # comm slots this epoch
    grad_bytes: float           # measured payload (scenario units)
    n_uploads: int = 0          # rows the decode reduced (0 on no-op)


def effective_code_matrix(result: EpochResult, K: int) -> np.ndarray:
    """The epoch's effective ``(M, K)`` coding matrix off the slot plan:
    ``B_eff[m,k] = Σ_s coeff[m,s]·[slot_partition[m,s] == k]``."""
    plan = result.plan
    part, coeff = plan.slot_partition, plan.slot_coeff
    B = np.zeros((plan.M, K))
    m_idx, s_idx = np.nonzero((part >= 0) & (coeff != 0.0))
    np.add.at(B, (m_idx, part[m_idx, s_idx]), coeff[m_idx, s_idx])
    return B


def decode_weights_from_result(result: EpochResult) -> np.ndarray:
    """Per-worker decode weights ``a`` recovered from the engine's slot
    weight matrix: ``a_m = w[m,s*]/coeff[m,s*]`` at any slot with a
    nonzero coefficient — zero for workers that contribute nothing."""
    plan, w = result.plan, np.asarray(result.weights, np.float64)
    part, coeff = plan.slot_partition, plan.slot_coeff
    a = np.zeros(plan.M)
    for m in range(plan.M):
        live = np.flatnonzero((part[m] >= 0) & (coeff[m] != 0.0))
        if live.size:
            a[m] = w[m, live[0]] / coeff[m, live[0]]
    return a


class CodedTrainer:
    """One (model × scenario × scheme) coded-training experiment.

    ``cfg`` is a :class:`~repro_torch.configs.ModelConfig`; the model is
    its transformer, with ``params`` (default: :func:`transformer.init_params`
    from ``seed`` on ``device``) and ``transformer.loss_fn``.  For another
    model pass ``cfg=None``, its parameter tree as ``params`` and its scalar
    ``loss_fn(params, batch)`` (the MLP: ``init_mlp``/``params_from_numpy``
    and ``mlp_loss``), or a prebuilt ``grad_fn(params, batch) -> (loss,
    grads)`` that several trainers can share.  ``spec`` supplies the
    cluster physics; its synthetic ``grad_bytes`` is replaced by the
    payload measured from the model's flattened gradient, calibrated
    through ``bytes_per_unit``.  The spec the cluster was built from is
    ``self.spec``.

    ``phase_timer(name, epoch)``, when given, is a context-manager factory
    wrapped around each phase of :meth:`run_epoch` (``shard_grads``,
    ``cosim``, ``encode``, ``decode_reduce``, ``optimizer_step``).
    ``telemetry``, a :class:`~repro_torch.telemetry.recorder.
    FleetRecorder`, records the reference's wall-clock spans
    (``shard_grads``, ``encode``, ``decode_reduce``, ``optimizer_step``)
    and is handed to the cluster, which records its own (``compute_phase``,
    ``comm``, ``decode``, the runtime's ``stage1``/``stage2``), its
    per-slot series and its epoch events.  ``None`` (the default) records
    nothing.
    """

    def __init__(self, cfg, spec: ScenarioSpec, scheme: str, dataset,
                 optimizer, *, params: Optional[Any] = None, seed: int = 0,
                 bytes_per_unit: float = DEFAULT_BYTES_PER_UNIT,
                 loss_fn: Optional[Callable] = None,
                 grad_fn: Optional[Callable] = None, device="cuda",
                 phase_timer: Optional[Callable] = None,
                 telemetry: Optional[FleetRecorder] = None):
        if dataset.K != spec.K:
            raise ValueError(f"dataset has K={dataset.K} partitions, "
                             f"scenario wants K={spec.K}")
        if cfg is None and (params is None or
                            (loss_fn is None and grad_fn is None)):
            raise ValueError("without a cfg, pass the model's params and "
                             "its loss_fn (or grad_fn)")
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # the reference computes float32 products in full float32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.scheme = scheme
        self.dataset = dataset
        self.optimizer = optimizer
        if params is None:
            params = transformer.init_params(
                cfg, torch.Generator(device=self.device).manual_seed(seed),
                device=self.device)
        self.params = tree_map(lambda p: p.to(self.device), params)
        self.opt_state = optimizer.init(self.params)

        # measured payload: the flattened-gradient byte size, in scenario
        # units — the co-sim drains what the model actually uploads
        self.partition = GradPartition.from_params(self.params)
        self.grad_bytes = self.partition.grad_bytes(bytes_per_unit)
        self.spec = spec.with_overrides(grad_bytes=self.grad_bytes)
        self.cluster = build_cluster(self.spec, scheme, seed,
                                     device=self.device)
        self.telemetry = telemetry
        if telemetry is not None:
            self.cluster.telemetry = telemetry
        if grad_fn is None:
            grad_fn = _value_and_grad(
                loss_fn if loss_fn is not None else
                (lambda p, batch: transformer.loss_fn(p, batch, cfg)))
        self._shard_grad = grad_fn
        self._phase_timer = phase_timer
        self.logs: List[TrainEpochLog] = []
        self.noop_steps = 0
        # test/debug introspection, tensors on the trainer's device: last
        # epoch's decoded gradient and the uncoded full-batch reference it
        # must match when decode succeeds
        self.last_decoded: Optional[torch.Tensor] = None
        self.last_full_grad: Optional[torch.Tensor] = None

    def _phase(self, name: str, epoch: int, *, span: bool = True):
        """The phase timer's context and, where ``span``, the recorder's
        span, entered together."""
        stack = contextlib.ExitStack()
        if self._phase_timer is not None:
            stack.enter_context(self._phase_timer(name, epoch))
        if span:
            stack.enter_context(phase_span(self.telemetry, name,
                                           epoch=epoch))
        return stack

    # ------------------------------------------------------------------ #
    def shard_gradients(self, epoch: int):
        """``(losses (K,), G (K, D) f32)`` — one backward per data shard.

        ``G`` is allocated once and each shard's gradient is flattened
        straight into its row, then dropped: stacking a list of K
        flattened gradients would hold them twice (14.8 GB more at
        stablelm-1.6b's width with 4 layers, D = 616,581,120, K = 6).
        """
        K = self.dataset.K
        G = torch.empty((K, self.partition.D), dtype=torch.float32,
                        device=self.device)
        losses = []
        for k in range(K):
            loss, grads = self._shard_grad(
                self.params, self.dataset.partition(epoch, k))
            losses.append(loss)
            self.partition.flatten_into(grads, G[k])
            del grads
        return torch.stack(losses), G

    def _encode(self, result: EpochResult, G: torch.Tensor):
        """Worker-side encode: uploads of the contributing workers
        (rows of the epoch's effective code matrix applied to the shard
        gradients) plus their engine-recovered decode weights."""
        B_eff = effective_code_matrix(result, self.dataset.K)
        a = decode_weights_from_result(result)
        contrib = np.flatnonzero(a != 0.0)
        B = torch.tensor(B_eff[contrib], dtype=torch.float32,
                         device=self.device)
        uploads = torch.matmul(B, G)
        return uploads, torch.tensor(a[contrib], dtype=torch.float32,
                                     device=self.device)

    # ------------------------------------------------------------------ #
    def run_epoch(self, epoch: int) -> TrainEpochLog:
        self.last_decoded = self.last_full_grad = None   # free them first
        with self._phase("shard_grads", epoch):
            losses, G = self.shard_gradients(epoch)
        # the co-sim epoch always runs (it owns the per-seed RNG stream),
        # whether or not the decode below ends up succeeding
        with self._phase("cosim", epoch, span=False):
            result = self.cluster.run_epoch(epoch)
        self.last_full_grad = G.sum(dim=0)
        if result.decode_ok:
            with self._phase("encode", epoch):
                uploads, a = self._encode(result, G)
            del G
            with self._phase("decode_reduce", epoch):
                decoded = coded_reduce(uploads, a)
            n_uploads = uploads.shape[0]
            del uploads
            self.last_decoded = decoded
            with self._phase("optimizer_step", epoch):
                self.params, self.opt_state = self.optimizer.update(
                    self.partition.unflatten(decoded), self.opt_state,
                    self.params)
            loss = float(losses.sum())
        else:
            # the paper's no-op step: params and optimizer state are the
            # same tensors — nothing was applied.  Loss is NaN so curves
            # show a gap, not a dip.
            self.noop_steps += 1
            n_uploads = 0
            loss = float("nan")
        log = TrainEpochLog(
            epoch=epoch, loss=loss, time=float(result.time),
            compute_time=float(result.compute_time),
            comm_time=float(result.comm_time),
            decode_ok=bool(result.decode_ok),
            n_slots=int(result.comm.n_slots if result.comm else 0),
            grad_bytes=self.grad_bytes, n_uploads=n_uploads)
        self.logs.append(log)
        return log

    def run(self, n_epochs: int) -> List[TrainEpochLog]:
        return [self.run_epoch(e) for e in range(n_epochs)]
