"""Decoder transformer, dense path, for coded training.

The torch counterpart of ``repro.models.transformer`` for configs whose
layers are attention (``attn``/``local``) with a dense or gated FFN and
token inputs, such as ``stablelm-1.6b``.  The parameter tree is the
reference's: ``{"embed", "groups", "final_norm", "lm_head"}``, where
``"groups"`` is a list with one dict per repeating layer unit, each leaf
stacked on a leading layer axis; so :func:`~repro_torch.train.flatten_grads`
flattens a gradient in ``ravel_pytree``'s order and a decoded vector
compares with the reference's index by index.

Layers run in a Python loop over the stacked axis (the reference scans
them).  ``remat="full"`` wraps each layer unit in ``torch.utils.checkpoint``
as the reference wraps its scan body in ``jax.checkpoint``; ``"dots"``
(save only the matrix products) has no torch counterpart and is mapped to
the same full recompute, which changes memory and time, not the result.
The cross-entropy is chunked over the sequence with each chunk
checkpointed, as the reference's ``jax.checkpoint`` at ``chunked_ce``:
otherwise every chunk's (B, 512, V) float32 logits would stay live for
the backward.  The reference's sharding constraints and unroll switch
(``models/settings.py``) are identities on one card and have no
counterpart here.

Not here yet (each raises ``NotImplementedError``): the ``rec`` and
``rwkv`` mixers, mixture-of-experts FFNs and the audio/vision frontends
(ROADMAP.md, queue 1: "rglru and WKV kernels with their models"), and the
serving entry points ``prefill``/``decode_step``/``init_cache`` (ROADMAP.md,
queue 1: the serving slice).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import flash_attention
from repro_torch.models.common import (Spec, activation, apply_rope,
                                       init_from_specs, layer_norm, rms_norm,
                                       rope, spec_leaves,
                                       spec_template)
from repro_torch.optim.optimizers import tree_leaves, tree_unflatten

__all__ = ["GroupDef", "group_layout", "model_specs", "init_params",
           "params_from_numpy", "forward", "loss_fn", "chunked_ce"]

_LATER = ("not ported yet: see ROADMAP.md, queue 1, \"rglru and WKV "
          "kernels with their models\"")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.frontend != "none":
        raise NotImplementedError(f"the {cfg.frontend} frontend is {_LATER}")
    for mixer, ffn in cfg.layer_kinds():
        if mixer not in ("attn", "local"):
            raise NotImplementedError(f"the {mixer!r} mixer is {_LATER}")
        if ffn != "dense":
            raise NotImplementedError(f"the {ffn!r} FFN is {_LATER}")


# ===================================================================== #
# layer layout
# ===================================================================== #
@dataclasses.dataclass(frozen=True)
class GroupDef:
    kinds: tuple           # ((mixer, ffn), ...) pattern unit
    n_repeat: int
    first_layer: int


def group_layout(cfg: ModelConfig) -> list:
    kinds = cfg.layer_kinds()
    L = len(kinds)
    P = len(cfg.layer_pattern)
    if cfg.n_experts and cfg.moe_every > 1:
        P = P * cfg.moe_every // math.gcd(P, cfg.moe_every)
    P = min(P, L)
    n_full, tail = divmod(L, P)
    groups = [GroupDef(kinds=tuple(kinds[:P]), n_repeat=n_full,
                       first_layer=0)]
    if tail:
        groups.append(GroupDef(kinds=tuple(kinds[n_full * P:]), n_repeat=1,
                               first_layer=n_full * P))
    return groups


# ===================================================================== #
# parameter specs
# ===================================================================== #
def _norm_spec(cfg):
    d = cfg.d_model
    if cfg.norm == "layer":
        return {"w": Spec((d,), (None,), "ones"),
                "b": Spec((d,), (None,), "zeros")}
    return {"w": Spec((d,), (None,), "zeros")}


def _attn_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    qd, kd = cfg.attn_dim, cfg.n_kv_heads * cfg.head_dim
    p = {
        "ln": _norm_spec(cfg),
        "wq": Spec((d, qd), ("embed", "qkv")),
        "wk": Spec((d, kd), ("embed", "kv")),
        "wv": Spec((d, kd), ("embed", "kv")),
        "wo": Spec((qd, d), ("qkv", "embed"), "normal",
                   1.0 / math.sqrt(2 * cfg.n_layers)),
    }
    if cfg.qk_norm:
        p["q_norm"] = Spec((cfg.head_dim,), (None,), "zeros")
        p["k_norm"] = Spec((cfg.head_dim,), (None,), "zeros")
    return p


def _ffn_specs(cfg: ModelConfig, ffn: str) -> dict:
    d, f = cfg.d_model, cfg.ffn_width(ffn)
    p = {"ln": _norm_spec(cfg),
         "wu": Spec((d, f), ("embed", "mlp")),
         "wd": Spec((f, d), ("mlp", "embed"), "normal",
                    1.0 / math.sqrt(2 * cfg.n_layers))}
    if cfg.gated_ffn:
        p["wg"] = Spec((d, f), ("embed", "mlp"))
    return p


def _stack_specs(specs: Any, n: int) -> Any:
    if isinstance(specs, Spec):
        return Spec((n,) + specs.shape, ("layers",) + specs.axes, specs.init,
                    specs.scale)
    return {k: _stack_specs(v, n) for k, v in specs.items()}


def model_specs(cfg: ModelConfig) -> dict:
    """The parameter tree of ``cfg`` as ``Spec`` leaves (shapes only, no
    allocation), the reference's tree key for key."""
    _check_supported(cfg)
    d, V = cfg.d_model, cfg.vocab
    specs: dict = {"embed": Spec((V, d), ("vocab", "embed"), "embed")}
    groups = []
    for g in group_layout(cfg):
        unit = {f"l{j}": {"mixer": _attn_specs(cfg),
                          "ffn": _ffn_specs(cfg, ffn)}
                for j, (_, ffn) in enumerate(g.kinds)}
        groups.append(_stack_specs(unit, g.n_repeat))
    specs["groups"] = groups
    specs["final_norm"] = _norm_spec(cfg)
    if not cfg.tie_embeddings:
        specs["lm_head"] = Spec((d, V), ("embed", "vocab"))
    return specs


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> dict:
    """Random weights of ``cfg`` in ``cfg.param_dtype`` on ``device``,
    drawn from ``generator`` (default: seed 0 on ``device``)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return init_from_specs(model_specs(cfg), _dtype(cfg.param_dtype),
                           generator, device)


def params_from_numpy(tree: Any, cfg: ModelConfig, device="cuda") -> dict:
    """The reference's parameters of ``cfg`` (the same tree, numpy leaves,
    e.g. ``jax.tree.map(np.asarray, init_params(cfg, key))``) as tensors
    in ``cfg.param_dtype`` on ``device``, value for value.  Every leaf's
    shape is checked against :func:`model_specs`."""
    specs = spec_leaves(model_specs(cfg))
    leaves = tree_leaves(tree)
    if len(leaves) != len(specs):
        raise ValueError(f"{len(leaves)} leaves, but {cfg.name} has "
                         f"{len(specs)} parameters")
    out = []
    for i, (x, s) in enumerate(zip(leaves, specs)):
        x = np.asarray(x)
        if tuple(x.shape) != tuple(s.shape):
            raise ValueError(f"leaf {i} ({s.axes}) has shape "
                             f"{tuple(x.shape)}, {cfg.name} wants "
                             f"{tuple(s.shape)}")
        out.append(torch.from_numpy(np.array(x, np.float32)).to(
            device, _dtype(cfg.param_dtype)))
    return tree_unflatten(spec_template(model_specs(cfg)), out)


# ===================================================================== #
# layer application
# ===================================================================== #
def _norm(x, p, cfg):
    if cfg.norm == "layer":
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    return rms_norm(x, p["w"], cfg.norm_eps)


def _sincos(cfg: ModelConfig, positions, mixer: str):
    theta = cfg.rope_theta
    if mixer == "local" and cfg.rope_theta_local:
        theta = cfg.rope_theta_local
    return rope(positions, cfg.head_dim, theta)


def _qkv(h, p, cfg: ModelConfig):
    B, S, _ = h.shape
    KV, G, hd = cfg.n_kv_heads, cfg.group_size, cfg.head_dim
    q = (h @ p["wq"]).reshape(B, S, KV, G, hd)
    k = (h @ p["wk"]).reshape(B, S, KV, hd)
    v = (h @ p["wv"]).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _attn_train(x, p, cfg: ModelConfig, mixer, positions):
    B, S, _ = x.shape
    h = _norm(x, p["ln"], cfg)
    q, k, v = _qkv(h, p, cfg)
    sin, cos = _sincos(cfg, positions, mixer)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    window = cfg.window if mixer == "local" else 0
    o = flash_attention(q, k, v, causal=cfg.causal, window=window,
                        q_chunk=1024, kv_chunk=1024)
    return x + o.reshape(B, S, cfg.attn_dim) @ p["wo"]


def _ffn_apply(x, p, cfg: ModelConfig):
    act = activation(cfg.act)
    h = _norm(x, p["ln"], cfg)
    if cfg.gated_ffn:
        out = (act(h @ p["wg"]) * (h @ p["wu"])) @ p["wd"]
    else:
        out = act(h @ p["wu"]) @ p["wd"]
    return x + out


def _apply_unit(x, unit_params, cfg: ModelConfig, kinds, positions):
    """One pattern unit (a list of layers) on the residual stream."""
    for j, (mixer, _) in enumerate(kinds):
        lp = unit_params[f"l{j}"]
        x = _attn_train(x, lp["mixer"], cfg, mixer, positions)
        x = _ffn_apply(x, lp["ffn"], cfg)
    return x


# ===================================================================== #
# embedding / head / loss
# ===================================================================== #
def _embed_inputs(params, batch, cfg: ModelConfig):
    emb = params["embed"].to(_dtype(cfg.compute_dtype))
    return F.embedding(batch["tokens"].long(), emb)


def _lm_head(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def chunked_ce(x, head_w, labels, weights, cfg: ModelConfig,
               chunk: int = 512):
    """Σ weights ⊙ CE without materializing the full (B, S, V) logits.

    x: (B, S, d) final hidden; labels: (B, S) integer; weights: (B, S)
    float32 (zero = masked).  Each chunk is recomputed in the backward.
    """
    S = x.shape[1]
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    dt = _dtype(cfg.compute_dtype)

    def chunk_loss(x_c, head, labels_c, w_c):
        logits = (x_c.to(dt) @ head).float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels_c[..., None].long())[..., 0]
        return torch.sum((lse - ll) * w_c)

    total = torch.zeros((), device=x.device)
    for i in range(0, S, chunk):
        total = total + checkpoint(
            chunk_loss, x[:, i:i + chunk], head_w, labels[:, i:i + chunk],
            weights[:, i:i + chunk], use_reentrant=False)
    return total


# ===================================================================== #
# forward pass
# ===================================================================== #
def forward(params, batch, cfg: ModelConfig):
    """Full-sequence forward.  Returns ``(hidden (B, S, d), aux)``; aux
    (the MoE balance loss in the reference) is zero on the dense path."""
    _check_supported(cfg)
    dt = _dtype(cfg.compute_dtype)
    x = _embed_inputs(params, batch, cfg).to(dt)
    positions = torch.arange(x.shape[1], device=x.device)
    remat = cfg.remat in ("full", "dots")
    for g, gp in zip(group_layout(cfg), params["groups"]):
        # one unbind per stacked leaf: its backward stacks the layers'
        # gradients once, where indexing would add a full-size zero
        # tensor per layer
        layers = [torch.unbind(t) for t in tree_leaves(gp)]

        def unit(x, *leaves, kinds=g.kinds, gp=gp):
            up = tree_unflatten(gp, [t.to(dt) for t in leaves])
            return _apply_unit(x, up, cfg, kinds, positions)

        for r in range(g.n_repeat):
            leaves = [layer[r] for layer in layers]
            x = (checkpoint(unit, x, *leaves, use_reentrant=False)
                 if remat else unit(x, *leaves))
    x = _norm(x, params["final_norm"], cfg)
    return x, torch.zeros((), device=x.device)


def loss_fn(params, batch, cfg: ModelConfig):
    """Weighted CE training loss.

    batch: ``tokens`` (B, S) + ``labels`` (B, S) + ``weights`` (B, S).
    """
    x, aux = forward(params, batch, cfg)
    head = _lm_head(params, cfg).to(_dtype(cfg.compute_dtype))
    loss = chunked_ce(x, head, batch["labels"], batch["weights"], cfg)
    return loss + 0.01 * aux
