"""Roofline terms of the (architecture × shape) grid on the NVIDIA H100:
the torch counterpart of ``repro.analysis.roofline``.

    compute term    = FLOPs_per_device / peak_FLOP/s
    memory term     = bytes_per_device / HBM_bw
    collective term = collective_bytes_per_device / link_bw

The reference reads its FLOPs and bytes off a compiled dry run of TPU
v5e meshes; on one card the port passes :func:`model_flops` and
:func:`analytic_hbm_bytes` (the reference's documented traffic model),
with no collective.  MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE)
measures how much of the compute is "useful".  Parameter counts come from
the port's ``model_specs``.

:data:`HW_H100` holds the card's published peaks (NVIDIA's data sheet, SXM
part, dense, at the 700 W limit); the card path uses it.
:data:`HW_V5E` is the reference's figures, kept only so the arithmetic can
be held against the reference's own; no figure of it is the card's.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.common import spec_leaves

__all__ = ["HW_H100", "HW_V5E", "RooflineTerms", "roofline_terms",
           "analytic_hbm_bytes", "model_flops", "param_counts",
           "dtype_size"]

HW_H100 = {
    "peak_flops_bf16": 989e12,     # dense bf16, tensor cores
    "peak_flops_f32": 67e12,       # float32 outside the tensor cores
    "hbm_bw": 3.35e12,             # bytes/s
    "ici_bw": 450e9,               # NVLink 4: bytes/s per direction
}

HW_V5E = {
    "peak_flops_bf16": 197e12,     # per chip
    "hbm_bw": 819e9,               # bytes/s per chip
    "ici_bw": 50e9,                # bytes/s per link direction
}


@dataclasses.dataclass
class RooflineTerms:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_ratio: float            # MODEL_FLOPS / (FLOPs × n_devices)
    peak_fraction: float           # useful flops/s at bound / peak

    def to_dict(self):
        return dataclasses.asdict(self)


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   coll_bytes_per_device: float, *, n_devices: int,
                   model_total_flops: float, hw: dict = HW_H100
                   ) -> RooflineTerms:
    c = flops_per_device / hw["peak_flops_bf16"]
    m = bytes_per_device / hw["hbm_bw"]
    k = coll_bytes_per_device / hw["ici_bw"]
    terms = {"compute": c, "memory": m, "collective": k}
    bottleneck = max(terms, key=terms.get)
    step_time = max(c, m, k)
    useful = model_total_flops / max(flops_per_device * n_devices, 1.0)
    peak_frac = (model_total_flops / n_devices / max(step_time, 1e-30)) \
        / hw["peak_flops_bf16"]
    return RooflineTerms(
        flops_per_device=flops_per_device,
        bytes_per_device=bytes_per_device,
        collective_bytes_per_device=coll_bytes_per_device,
        compute_s=c, memory_s=m, collective_s=k, bottleneck=bottleneck,
        model_flops=model_total_flops, useful_ratio=useful,
        peak_fraction=peak_frac)


# --------------------------------------------------------------------- #
def analytic_hbm_bytes(cfg, shape, mesh_shape: dict) -> float:
    """Per-device HBM traffic model (the reference's, term for term).

    train:   weights 3 passes (fwd, remat-recompute, bwd) + optimizer
             read/write (params, grads f32, m, v) + activations ≈ 4 passes
             of the per-layer residual + CE logits volume (2 passes).
    prefill: weights 1 pass + activations 2 passes + cache write.
    decode:  weights 1 pass + KV-cache 1 read + cache write (tiny).

    ``mesh_shape`` maps axis names (``pod``, ``data``, ``model``) to sizes;
    one card is ``{}``.
    """
    n_dev = int(np.prod(list(mesh_shape.values())))
    n_batch = int(np.prod([v for k, v in mesh_shape.items()
                           if k in ("pod", "data")]))
    total, _ = param_counts(cfg)
    p_dev = total / n_dev
    p_b = dtype_size(cfg.param_dtype)
    o_b = dtype_size(cfg.opt_state_dtype)
    B, S = shape.global_batch, shape.seq_len
    B_loc = max(B // n_batch, 1)
    d = cfg.d_model
    L = cfg.n_layers
    V_loc = cfg.vocab / (mesh_shape.get("model", 1))
    act_b = 2  # bf16 activations

    if shape.kind == "train":
        weights = p_dev * (3 * p_b + 2 * p_b + 2 * 4 + 4 * o_b)
        acts = 4 * L * B_loc * S * d * act_b
        ce = 2 * B_loc * S * V_loc * 4
        return weights + acts + ce
    if shape.kind == "prefill":
        weights = p_dev * p_b
        acts = 2 * L * B_loc * S * d * act_b
        cache = _cache_bytes(cfg, shape, n_dev, n_batch)
        return weights + acts + cache
    # decode
    weights = p_dev * p_b
    cache = _cache_bytes(cfg, shape, n_dev, n_batch)
    acts = 4 * L * B_loc * 1 * d * act_b
    return weights + cache + acts


def _cache_bytes(cfg, shape, n_dev, n_batch) -> float:
    """Per-device KV/state cache bytes (model-axis head padding included)."""
    B, S = shape.global_batch, shape.seq_len
    n_model = max(n_dev // max(n_batch, 1), 1)
    if B >= n_batch:          # batch-sharded cache
        b_loc, s_loc = B / n_batch, S
    else:                     # long-context: sequence-sharded cache
        b_loc, s_loc = B, S / n_batch
    total = 0.0
    for mixer, _ in cfg.layer_kinds():
        if mixer in ("attn", "local"):
            eff_S = s_loc if mixer == "attn" else min(cfg.window or S, S)
            kv_loc = max(cfg.n_kv_heads / n_model, 1.0)   # pad ≥ 1/shard
            total += b_loc * eff_S * kv_loc * cfg.head_dim * 2 * 2
        elif mixer == "rec":
            dr = cfg.d_rnn or cfg.d_model
            total += b_loc * dr * (4 + (cfg.conv_width - 1) * 2)
        elif mixer == "rwkv":
            H_loc = max((cfg.d_model // cfg.rwkv_head_dim) / n_model, 1.0)
            total += b_loc * H_loc * cfg.rwkv_head_dim ** 2 * 4 \
                + b_loc * cfg.d_model * 12
    return total


def dtype_size(dtype_name: str) -> int:
    """Bytes of one entry of the named type (``"bfloat16"`` -> 2)."""
    return torch.empty((), dtype=getattr(torch, dtype_name)).element_size()


def param_counts(cfg) -> tuple:
    """(total_params, active_params) from the model specs."""
    total = sum(math.prod(s.shape)
                for s in spec_leaves(tfm.model_specs(cfg)))
    if not cfg.n_experts:
        return total, total
    # active = replace the expert count with top_k in the expert stacks
    n_moe_layers = sum(1 for (mx, ff) in cfg.layer_kinds() if ff == "moe")
    per_expert = 3 * cfg.d_model * cfg.d_ff
    expert_total = n_moe_layers * cfg.n_experts * per_expert
    expert_active = n_moe_layers * cfg.top_k * per_expert
    return total, total - expert_total + expert_active


def model_flops(cfg, shape) -> float:
    """6·N·D for training; 2·N·D for prefill; 2·N_active·B per decode token.

    N = active params (MoE counts top-k experts only), D = tokens processed.
    """
    total, active = param_counts(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    # decode: one token per sequence
    return 2.0 * active * shape.global_batch
