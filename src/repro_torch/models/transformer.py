"""The composable transformer of every config: dense, MoE, hybrid
(RG-LRU), ssm (RWKV6), vision and audio, for training and serving.

The torch counterpart of ``repro.models.transformer``: layers of attention
(``attn``/``local``), the RG-LRU recurrent block (``rec``) or RWKV6 time
mix (``rwkv``, with its channel mix), each with a dense or gated FFN or the
mixture-of-experts FFN (``models/moe.py``, with an optional shared
expert); token inputs, or the vision frontend (projected patches before
the tokens) or the audio frontend (projected frames plus a sinusoidal
position table), each through the linear ``adapter``.  The parameter tree
is the reference's: ``{"adapter", "embed", "groups", "final_norm",
"lm_head"}``, where
``"groups"`` is a list with one dict per repeating layer unit, each leaf
stacked on a leading layer axis; so :func:`~repro_torch.train.flatten_grads`
flattens a gradient in ``ravel_pytree``'s order and a decoded vector
compares with the reference's index by index.  Decode caches have the
reference's layout too (one dict per group, leaves stacked on the layer
axis).

Layers run in a Python loop over the stacked axis (the reference scans
them).  ``remat="full"`` wraps each layer in ``torch.utils.checkpoint``,
where the reference wraps its scan body, a whole layer unit, in
``jax.checkpoint``: the same values, but one layer's activations live at
a time in the backward (gemma3-12b's unit is six layers, which at 30 x
2,048 tokens would not fit beside its weights on one card).  ``"dots"``
(save only the matrix products) has no torch counterpart and is mapped to
the same full recompute, which changes memory and time, not the result.
The cross-entropy is chunked over the sequence with each chunk
checkpointed, as the reference's ``jax.checkpoint`` at ``chunked_ce``:
otherwise every chunk's (B, 512, V) float32 logits would stay live for
the backward.  The reference's sharding constraints and unroll switch
(``models/settings.py``) are identities on one card and have no
counterpart here.

The RWKV6 time mix runs the WKV recurrence through
``repro_torch.kernels.rwkv6_wkv.wkv``: the CUDA kernels (forward and
backward) on the card, the plain sequential recurrence and its
written-out backward on the CPU.  The reference's ``wkv_chunked`` is not
ported (``models/rwkv6.py`` says why), so the port's prefill is exact
where the reference's is not, and so is its gradient (the reference
trains through autodiff of ``wkv_chunked``).

The ``rec`` block (``_rec_train``) runs its scan through
``repro_torch.kernels.rglru_scan`` by way of ``models/rglru.py``: the CUDA
kernels (forward, and the reverse scan backward) on the card, the plain
recurrence and its written-out backward on the CPU.  Its conv state keeps
the last ``conv_width - 1`` pre-conv inputs, left-padded with zeros for a
prompt shorter than that (the reference keeps fewer rows, and its decode
step then fails on them).  Every family trains on the card
(``launch/train.py``); attention's backward takes head widths up to 256.

Every entry point sums the MoE balance loss ``aux`` over the layers as
the reference does, and takes the reference's ``dp_shards`` (tokens are
routed per shard).  A layer unit's weights are cast to the compute type
before it runs, but an MoE layer's expert stacks are left as stored:
``moe_ffn`` casts them a block of experts at a time.

Serving: ``prefill`` (a forward that collects the caches), ``pad_cache``,
``init_cache`` and ``decode_step`` (one token, attention over the k/v
cache in plain PyTorch as the reference's ``decode_attention`` is plain
jnp; RG-LRU through ``rglru_step``; RWKV6 through ``wkv_step``).  A
``local`` layer's cache holds min(tokens, window) slots: ``pad_cache``
grows it up to the window, so that decode never overwrites a slot still
inside the window (the reference keeps a prompt shorter than the window
at its length, and its decode then drops tokens that are in the window).
An audio (encoder-only) config has no decode step.
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
from repro_torch.kernels.rwkv6_wkv import wkv
from repro_torch.models import rglru
from repro_torch.models.attention import decode_attention, flash_attention
from repro_torch.models.common import (Spec, activation, apply_rope,
                                       init_from_specs, layer_norm, rms_norm,
                                       rope, spec_leaves,
                                       spec_template)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.rwkv6 import wkv_step
from repro_torch.optim.optimizers import tree_leaves, tree_map, tree_unflatten

__all__ = ["GroupDef", "group_layout", "model_specs", "init_params",
           "params_from_numpy", "forward", "loss_fn", "chunked_ce",
           "prefill", "decode_step", "init_cache", "pad_cache"]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


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


def _rec_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    dr = cfg.d_rnn or d
    hr = cfg.rnn_heads
    dh = dr // hr
    return {
        "ln": _norm_spec(cfg),
        "w_in": Spec((d, dr), ("embed", "rnn")),
        "w_gate": Spec((d, dr), ("embed", "rnn")),
        "conv_w": Spec((cfg.conv_width, dr), (None, "rnn"), "normal", 0.3),
        "conv_b": Spec((dr,), ("rnn",), "zeros"),
        "w_a": Spec((hr, dh, dh), ("rnn_heads", None, None)),
        "b_a": Spec((hr, dh), ("rnn_heads", None), "zeros"),
        "w_x": Spec((hr, dh, dh), ("rnn_heads", None, None)),
        "b_x": Spec((hr, dh), ("rnn_heads", None), "zeros"),
        "lam": Spec((hr, dh), ("rnn_heads", None), "ones"),
        "w_out": Spec((dr, d), ("rnn", "embed"), "normal",
                      1.0 / math.sqrt(2 * cfg.n_layers)),
    }


def _rwkv_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    H, hd, r = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim, cfg.lora_rank
    return {
        "ln": _norm_spec(cfg),
        "mu": Spec((5, d), (None, None), "zeros"),      # r,k,v,w,g lerps
        "w0": Spec((d,), (None,), "zeros"),
        "w_lora_a": Spec((d, r), ("embed", None)),
        "w_lora_b": Spec((r, d), (None, "embed"), "zeros"),
        "wr": Spec((d, d), ("embed", "qkv")),
        "wk": Spec((d, d), ("embed", "qkv")),
        "wv": Spec((d, d), ("embed", "qkv")),
        "wg": Spec((d, d), ("embed", "qkv")),
        "u": Spec((H, hd), ("heads", None), "zeros"),
        "gn": Spec((H, hd), ("heads", None), "zeros"),
        "wo": Spec((d, d), ("qkv", "embed"), "normal",
                   1.0 / math.sqrt(2 * cfg.n_layers)),
    }


def _mixer_specs(cfg: ModelConfig, mixer: str) -> dict:
    if mixer == "rec":
        return _rec_specs(cfg)
    return _rwkv_specs(cfg) if mixer == "rwkv" else _attn_specs(cfg)


def _ffn_specs(cfg: ModelConfig, ffn: str, mixer: str) -> dict:
    d = cfg.d_model
    if mixer == "rwkv":                       # rwkv channel mix
        return {
            "ln": _norm_spec(cfg),
            "mu": Spec((2, d), (None, None), "zeros"),      # k, r lerps
            "wk": Spec((d, cfg.d_ff), ("embed", "mlp")),
            "wv": Spec((cfg.d_ff, d), ("mlp", "embed"), "normal",
                       1.0 / math.sqrt(2 * cfg.n_layers)),
            "wr": Spec((d, d), ("embed", "qkv")),
        }
    if ffn == "moe":
        f, E = cfg.d_ff, cfg.n_experts
        p = {
            "ln": _norm_spec(cfg),
            "router": Spec((d, E), ("embed", None)),
            "wg": Spec((E, d, f), ("experts", "embed", "expert_mlp")),
            "wu": Spec((E, d, f), ("experts", "embed", "expert_mlp")),
            "wd": Spec((E, f, d), ("experts", "expert_mlp", "embed"),
                       "normal", 1.0 / math.sqrt(2 * cfg.n_layers)),
        }
        if cfg.shared_expert:
            p["ws_g"] = Spec((d, f), ("embed", "mlp"))
            p["ws_u"] = Spec((d, f), ("embed", "mlp"))
            p["ws_d"] = Spec((f, d), ("mlp", "embed"), "normal",
                             1.0 / math.sqrt(2 * cfg.n_layers))
        return p
    f = cfg.ffn_width(ffn)
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
    d, V = cfg.d_model, cfg.vocab
    specs: dict = {"embed": Spec((V, d), ("vocab", "embed"), "embed")}
    if cfg.frontend in ("audio", "vision"):
        specs["adapter"] = Spec((d, d), ("embed", None))
    groups = []
    for g in group_layout(cfg):
        unit = {f"l{j}": {"mixer": _mixer_specs(cfg, mixer),
                          "ffn": _ffn_specs(cfg, ffn, mixer)}
                for j, (mixer, ffn) in enumerate(g.kinds)}
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
    return x + o.reshape(B, S, cfg.attn_dim) @ p["wo"], (k, v)


def _attn_decode(x, p, cfg: ModelConfig, mixer, cache, pos: int):
    """x: (B, 1, d); cache: {'k', 'v': (B, cap, KV, hd)}; pos: the new
    token's position.  Returns the new cache, the old one untouched."""
    B = x.shape[0]
    h = _norm(x, p["ln"], cfg)
    q, k, v = _qkv(h, p, cfg)
    sin, cos = _sincos(cfg, torch.tensor([pos], device=x.device), mixer)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    cap = cache["k"].shape[1]
    window = cfg.window if mixer == "local" else 0
    ring = bool(window) and cap <= window         # ring buffer cache
    slot = pos % cap if ring else min(pos, cap - 1)
    k_cache, v_cache = cache["k"].clone(), cache["v"].clone()
    k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
    idx = torch.arange(cap, device=x.device)
    # a ring's slots are all valid after warm-up; only slots <= pos before
    valid = (idx <= pos) | (pos >= cap) if ring else idx <= pos
    o = decode_attention(q, k_cache.to(q.dtype), v_cache.to(q.dtype),
                         valid[None].expand(B, cap))
    o = o.reshape(B, 1, cfg.attn_dim) @ p["wo"]
    return x + o, {"k": k_cache, "v": v_cache}


def _rec_train(x, p, cfg: ModelConfig):
    """The RG-LRU block over a whole sequence; its scan is the kernel on
    the card and the plain recurrence on the CPU."""
    B, S, d = x.shape
    dr = cfg.d_rnn or d
    hr = cfg.rnn_heads
    W = cfg.conv_width
    h = _norm(x, p["ln"], cfg)
    xb = h @ p["w_in"]
    gate = activation("gelu")(h @ p["w_gate"])
    # the last W - 1 pre-conv inputs, zeros before the first token
    tail = F.pad(xb, (0, 0, max(0, W - 1 - S), 0))
    conv_state = tail[:, tail.shape[1] - (W - 1):]
    xb = rglru.causal_conv1d(xb, p["conv_w"], p["conv_b"])
    y, h_last = rglru.rglru_scan(xb.reshape(B, S, hr, dr // hr), p)
    o = (y.reshape(B, S, dr) * gate) @ p["w_out"]
    return x + o, {"h": h_last.float(), "conv": conv_state}


def _rec_decode(x, p, cfg: ModelConfig, cache):
    B, _, d = x.shape
    dr = cfg.d_rnn or d
    hr = cfg.rnn_heads
    h = _norm(x, p["ln"], cfg)[:, 0]
    xb = h @ p["w_in"]
    gate = activation("gelu")(h @ p["w_gate"])
    xb, conv_state = rglru.conv1d_step(xb, cache["conv"].to(xb.dtype),
                                       p["conv_w"], p["conv_b"])
    y, h_new = rglru.rglru_step(xb.reshape(B, hr, dr // hr), cache["h"], p)
    o = (y.reshape(B, dr) * gate) @ p["w_out"]
    return x + o[:, None], {"h": h_new.float(), "conv": conv_state}


def _rwkv_mix(h, prev, mu):
    """Token-shift lerp; h: (B, S, d), prev: (B, d) state; mu: (d,)."""
    hh = torch.cat([prev[:, None].to(h.dtype), h[:, :-1]], dim=1)
    return h + (hh - h) * mu


def _rwkv_decay(mix_w, p):
    """Data-dependent decay w = exp(-exp(w0 + lora(x))), float32."""
    lora = torch.tanh(mix_w @ p["w_lora_a"]) @ p["w_lora_b"]
    return torch.exp(-torch.exp(
        torch.clamp(p["w0"] + lora.float(), -8.0, 2.0)))


def _rwkv_train(x, p, cfg: ModelConfig):
    """RWKV6 time mix over a whole sequence; the WKV recurrence is the
    kernel on the card and the plain recurrence on the CPU."""
    B, S, d = x.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    h = _norm(x, p["ln"], cfg)
    prev = torch.zeros((B, d), dtype=h.dtype, device=h.device)
    mr, mk, mv, mw, mg = p["mu"].unbind(0)

    def heads(t):
        return t.reshape(B, S, H, hd).transpose(1, 2).contiguous()
    r = heads(_rwkv_mix(h, prev, mr) @ p["wr"])
    k = heads(_rwkv_mix(h, prev, mk) @ p["wk"])
    v = heads(_rwkv_mix(h, prev, mv) @ p["wv"])
    g = _rwkv_mix(h, prev, mg) @ p["wg"]
    w = heads(_rwkv_decay(_rwkv_mix(h, prev, mw), p))
    out, S_last = wkv(r, k, v, w, p["u"].contiguous())
    out = out.transpose(1, 2)                               # (B,S,H,hd)
    out = rms_norm(out, p["gn"], cfg.norm_eps).reshape(B, S, d)
    o = (out * F.silu(g)) @ p["wo"]
    return x + o, {"S": S_last, "tm": h[:, -1].float()}


def _rwkv_decode(x, p, cfg: ModelConfig, cache):
    B, _, d = x.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    h = _norm(x, p["ln"], cfg)[:, 0]
    prev = cache["tm"].to(h.dtype)
    mr, mk, mv, mw, mg = p["mu"].unbind(0)

    def mix(mu):
        return h + (prev - h) * mu
    r = (mix(mr) @ p["wr"]).reshape(B, H, hd)
    k = (mix(mk) @ p["wk"]).reshape(B, H, hd)
    v = (mix(mv) @ p["wv"]).reshape(B, H, hd)
    g = mix(mg) @ p["wg"]
    w = _rwkv_decay(mix(mw)[None], p)[0].reshape(B, H, hd)
    out, S_new = wkv_step(r.float(), k.float(), v.float(), w.float(),
                          p["u"].float(), cache["S"])
    out = rms_norm(out, p["gn"], cfg.norm_eps)
    o = (out.reshape(B, d).to(x.dtype) * F.silu(g)) @ p["wo"]
    return x + o[:, None], {"S": S_new, "tm": h.float()}


def _channel_mix(x, p, cfg: ModelConfig, cache=None):
    """RWKV channel mix (stateful); ``cache`` holds the previous token's
    normed input in decode, None in a full-sequence pass."""
    h = _norm(x, p["ln"], cfg)
    if cache is not None:
        prev = cache["cm"].to(h.dtype)[:, None]
    else:
        prev = torch.zeros((x.shape[0], 1, x.shape[-1]), dtype=h.dtype,
                           device=h.device)
    hh = torch.cat([prev, h[:, :-1]], dim=1) if h.shape[1] > 1 else prev
    mk, mr = p["mu"][0], p["mu"][1]
    xk = h + (hh - h) * mk
    xr = h + (hh - h) * mr
    kk = torch.square(F.relu(xk @ p["wk"]))
    out = torch.sigmoid(xr @ p["wr"]) * (kk @ p["wv"])
    return x + out, {"cm": h[:, -1].float()}


def _ffn_apply(x, p, cfg: ModelConfig, ffn: str, dp_shards: int):
    """A dense, gated or MoE FFN; returns ``(x, aux)``, aux the MoE
    balance loss (None for the others: no zero tensor, no launch)."""
    act = activation(cfg.act)
    h = _norm(x, p["ln"], cfg)
    if ffn == "moe":
        out, aux = moe_ffn(h, p, top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor, act=act,
                           dp_shards=dp_shards)
        if cfg.shared_expert:
            out = out + (act(h @ p["ws_g"]) * (h @ p["ws_u"])) @ p["ws_d"]
        return x + out, aux
    if cfg.gated_ffn:
        out = (act(h @ p["wg"]) * (h @ p["wu"])) @ p["wd"]
    else:
        out = act(h @ p["wu"]) @ p["wd"]
    return x + out, None


def _add(a, b):
    """a + b, where None stands for zero."""
    return b if a is None else a if b is None else a + b


#: an MoE layer's expert stacks, left in their stored type by _cast_unit
_EXPERT_STACKS = ("wg", "wu", "wd")


def _cast_unit(up: dict, kinds, dt) -> dict:
    """A unit's weights in the compute type ``dt``, but an MoE layer's
    expert stacks as stored: ``moe_ffn`` casts them a block of experts at
    a time, so no copy of all of them exists in ``dt``."""
    def cast(tree):
        return tree_map(lambda t: t.to(dt), tree)
    out = {}
    for j, (_, ffn) in enumerate(kinds):
        lp = up[f"l{j}"]
        out[f"l{j}"] = {
            "mixer": cast(lp["mixer"]),
            "ffn": {k: v if ffn == "moe" and k in _EXPERT_STACKS else cast(v)
                    for k, v in lp["ffn"].items()}}
    return out


def _apply_unit(x, unit_params, cfg: ModelConfig, kinds, positions,
                caches=None, pos=None, collect: bool = False,
                dp_shards: int = 1):
    """One pattern unit (a list of layers) on the residual stream: a
    full-sequence pass (``caches`` None) or one decode step at ``pos``.
    Returns ``(x, aux, new caches)``: aux summed over the unit's MoE
    layers (None without one), the caches in the reference's per-layer
    layout (``{"mix": ..., "ffn": ...}``; a full-sequence attention layer
    gives its ``(k, v)``) in decode or with ``collect``, else None: a
    training pass drops each layer's cache before its FFN runs, so that k
    and v do not stay alive through it."""
    decode = caches is not None
    keep = decode or collect
    new_caches = {}
    aux_total = None
    for j, (mixer, ffn) in enumerate(kinds):
        lp = unit_params[f"l{j}"]
        cache_j = caches[f"l{j}"] if decode else None
        if mixer == "rwkv":
            if decode:
                x, mix_cache = _rwkv_decode(x, lp["mixer"], cfg,
                                            cache_j["mix"])
            else:
                x, mix_cache = _rwkv_train(x, lp["mixer"], cfg)
        elif mixer == "rec":
            if decode:
                x, mix_cache = _rec_decode(x, lp["mixer"], cfg,
                                           cache_j["mix"])
            else:
                x, mix_cache = _rec_train(x, lp["mixer"], cfg)
        elif decode:
            x, mix_cache = _attn_decode(x, lp["mixer"], cfg, mixer,
                                        cache_j["mix"], pos)
        else:
            x, mix_cache = _attn_train(x, lp["mixer"], cfg, mixer, positions)
        if not keep:
            mix_cache = None
        if mixer == "rwkv":
            x, ffn_cache = _channel_mix(
                x, lp["ffn"], cfg, cache_j["ffn"] if decode else None)
            entry = {"mix": mix_cache, "ffn": ffn_cache}
        else:
            x, aux = _ffn_apply(x, lp["ffn"], cfg, ffn, dp_shards)
            aux_total = _add(aux_total, aux)
            entry = {"mix": mix_cache}
        if keep:
            new_caches[f"l{j}"] = entry
    return x, aux_total, (new_caches if keep else None)


def _stack(trees: list) -> Any:
    """Trees of one structure -> one tree, leaves stacked on a new axis 0
    (the layout of the reference's scanned caches)."""
    cols = zip(*(tree_leaves(t) for t in trees))
    return tree_unflatten(trees[0], [torch.stack(c) for c in cols])


# ===================================================================== #
# embedding / head / loss
# ===================================================================== #
def _embed_inputs(params, batch, cfg: ModelConfig):
    """Token embeddings; audio: frames @ adapter plus the sinusoidal
    position table; vision: patches @ adapter, then the tokens'."""
    dt = _dtype(cfg.compute_dtype)
    if cfg.frontend == "audio":
        x = batch["frames"].to(dt) @ params["adapter"].to(dt)
        S, half = x.shape[1], cfg.d_model // 2
        freq = 10000.0 ** (-torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
        ang = torch.arange(S, device=x.device)[:, None] * freq
        pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        return x + pe[None].to(dt)
    tok = F.embedding(batch["tokens"].long(), params["embed"].to(dt))
    if cfg.frontend == "vision":
        patches = batch["patches"].to(dt) @ params["adapter"].to(dt)
        return torch.cat([patches, tok], dim=1)
    return tok


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
def forward(params, batch, cfg: ModelConfig, *, dp_shards: int = 1,
            collect_cache: bool = False):
    """Full-sequence forward.  Returns ``(hidden (B, S, d), aux)``, aux
    the MoE balance loss summed over the layers (zero without MoE).  With
    ``collect_cache`` it returns ``(hidden, aux, caches)``: each group's
    per-layer caches stacked on the layer axis, as the reference's (and
    without ``remat``, as the reference's)."""
    dt = _dtype(cfg.compute_dtype)
    x = _embed_inputs(params, batch, cfg).to(dt)
    positions = torch.arange(x.shape[1], device=x.device)
    remat = cfg.remat in ("full", "dots") and not collect_cache
    aux, all_caches = None, []
    for g, gp in zip(group_layout(cfg), params["groups"]):
        # remat checkpoints a layer at a time: a unit's layers (six in
        # gemma3's) keep their activations together only outside remat
        pieces = [({"l0": gp[f"l{j}"]}, (kind,))
                  for j, kind in enumerate(g.kinds)] if remat else \
            [(gp, g.kinds)]
        # one unbind per stacked leaf: its backward stacks the layers'
        # gradients once, where indexing would add a full-size zero
        # tensor per layer
        split = [(tree, kinds, [torch.unbind(t) for t in tree_leaves(tree)])
                 for tree, kinds in pieces]

        def unit(x, *leaves, tree, kinds):
            up = _cast_unit(tree_unflatten(tree, list(leaves)), kinds, dt)
            return _apply_unit(x, up, cfg, kinds, positions,
                               collect=collect_cache, dp_shards=dp_shards)

        def unit_x(x, *leaves, tree, kinds):
            return unit(x, *leaves, tree=tree, kinds=kinds)[:2]

        caches = []
        for r in range(g.n_repeat):
            aux_u = None
            for tree, kinds, layers in split:
                leaves = [layer[r] for layer in layers]
                if collect_cache:
                    x, aux_p, c = unit(x, *leaves, tree=tree, kinds=kinds)
                    caches.append(c)
                elif remat:
                    x, aux_p = checkpoint(unit_x, x, *leaves, tree=tree,
                                          kinds=kinds, use_reentrant=False)
                else:
                    x, aux_p = unit_x(x, *leaves, tree=tree, kinds=kinds)
                aux_u = _add(aux_u, aux_p)
            aux = _add(aux, aux_u)
        if collect_cache:
            all_caches.append(_stack(caches))
    x = _norm(x, params["final_norm"], cfg)
    if aux is None:
        aux = torch.zeros((), device=x.device)
    return (x, aux, all_caches) if collect_cache else (x, aux)


def loss_fn(params, batch, cfg: ModelConfig, *, dp_shards: int = 1):
    """Weighted CE training loss plus 0.01 x the MoE balance loss.

    batch: ``tokens`` (B, S) (or ``frames`` (B, S, d), or ``patches``
    (B, P, d) + ``tokens`` (B, S - P)) + ``labels`` (B, S) + ``weights``
    (B, S).
    """
    x, aux = forward(params, batch, cfg, dp_shards=dp_shards)
    head = _lm_head(params, cfg).to(_dtype(cfg.compute_dtype))
    loss = chunked_ce(x, head, batch["labels"], batch["weights"], cfg)
    return loss + 0.01 * aux


# ===================================================================== #
# serving
# ===================================================================== #
def _layer_cache(cfg: ModelConfig, mixer, B: int, cap: int, n: int,
                 device) -> dict:
    """Empty decode caches of ``n`` stacked layers of kind ``mixer``."""
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros((n,) + shape, dtype=dtype, device=device)
    if mixer == "rwkv":
        d, hd = cfg.d_model, cfg.rwkv_head_dim
        return {"mix": {"S": zeros(B, d // hd, hd, hd), "tm": zeros(B, d)},
                "ffn": {"cm": zeros(B, d)}}
    if mixer == "rec":
        dr = cfg.d_rnn or cfg.d_model
        return {"mix": {"h": zeros(B, cfg.rnn_heads, dr // cfg.rnn_heads),
                        "conv": zeros(B, cfg.conv_width - 1, dr,
                                      dtype=_dtype(cfg.compute_dtype))}}
    c = min(cap, cfg.window) if (mixer == "local" and cfg.window) else cap
    shape, cdt = (B, c, cfg.n_kv_heads, cfg.head_dim), \
        _dtype(cfg.compute_dtype)
    return {"mix": {"k": zeros(*shape, dtype=cdt),
                    "v": zeros(*shape, dtype=cdt)}}


def init_cache(cfg: ModelConfig, B: int, cap: int, device="cuda") -> list:
    """Empty decode caches for ``B`` sequences of up to ``cap`` tokens,
    one dict per group, leaves stacked on the layer axis."""
    return [{f"l{j}": _layer_cache(cfg, mixer, B, cap, g.n_repeat, device)
             for j, (mixer, _) in enumerate(g.kinds)}
            for g in group_layout(cfg)]


@torch.no_grad()
def prefill(params, batch, cfg: ModelConfig, *, dp_shards: int = 1):
    """Forward + build decode caches.  Returns ``(last_logits (B, V)
    float32, caches, pos)`` with ``pos`` = S, the next token's position
    (a vision batch's S counts its patches)."""
    x, _, raw = forward(params, batch, cfg, dp_shards=dp_shards,
                        collect_cache=True)
    S = x.shape[1]
    cdt = _dtype(cfg.compute_dtype)
    caches = []
    for g, rc in zip(group_layout(cfg), raw):
        unit = {}
        for j, (mixer, _) in enumerate(g.kinds):
            src = rc[f"l{j}"]
            if mixer in ("attn", "local"):
                k, v = src["mix"]               # (R, B, S, KV, hd)
                if mixer == "local" and cfg.window and cfg.window < S:
                    W = cfg.window
                    ring = torch.arange(S - W, S, device=k.device) % W
                    k = torch.zeros_like(k[:, :, :W]).index_copy_(
                        2, ring, k[:, :, S - W:])
                    v = torch.zeros_like(v[:, :, :W]).index_copy_(
                        2, ring, v[:, :, S - W:])
                src = {"mix": {"k": k.to(cdt), "v": v.to(cdt)}}
            unit[f"l{j}"] = src
        caches.append(unit)
    head = _lm_head(params, cfg).to(cdt)
    last = x[:, -1].to(cdt) @ head
    return last.float(), caches, S


def pad_cache(caches: list, cfg: ModelConfig, extra: int) -> list:
    """Grow k/v caches for ``extra`` decode slots: a full-attention cache
    by ``extra``, a local-window cache up to ``min(cap + extra, window)``
    (a prompt shorter than the window keeps one slot per token, so decode
    writes position ``pos`` at slot ``pos`` until the window fills, and a
    ring after that); recurrent caches are fixed-size and kept."""
    out = []
    for g, gc in zip(group_layout(cfg), caches):
        unit = {}
        for j, (mixer, _) in enumerate(g.kinds):
            e = gc[f"l{j}"]
            grow = 0
            if mixer == "attn" or (mixer == "local" and not cfg.window):
                grow = extra
            elif mixer == "local":
                cap = e["mix"]["k"].shape[2]
                grow = max(0, min(cap + extra, cfg.window) - cap)
            if grow:
                e = {"mix": {n: F.pad(t, (0, 0, 0, 0, 0, grow))
                             for n, t in e["mix"].items()}}
            unit[f"l{j}"] = e
        out.append(unit)
    return out


@torch.no_grad()
def decode_step(params, tokens, caches: list, pos: int, cfg: ModelConfig,
                *, dp_shards: int = 1):
    """One serve step: ``tokens`` (B, 1) at position ``pos`` -> ``(logits
    (B, V) float32, new caches)``.  Full-attention layers write the token
    at ``pos`` (callers keep pos < cap); local layers write slot ``pos``
    until the cache holds ``window`` slots and use it as a ring after
    that; RG-LRU and RWKV layers step their state; MoE layers route the B
    tokens (the balance loss is dropped, as the reference drops it)."""
    if cfg.frontend == "audio":
        raise ValueError("encoder-only architecture has no decode step")
    dt = _dtype(cfg.compute_dtype)
    # gather, then cast: the reference's take of the cast table, cheaper
    x = F.embedding(tokens.long(), params["embed"]).to(dt)
    new_caches = []
    for g, gp, gc in zip(group_layout(cfg), params["groups"], caches):
        layers = [torch.unbind(t) for t in tree_leaves(gp)]
        cache_layers = [torch.unbind(t) for t in tree_leaves(gc)]
        outs = []
        for r in range(g.n_repeat):
            up = _cast_unit(tree_unflatten(gp, [t[r] for t in layers]),
                            g.kinds, dt)
            uc = tree_unflatten(gc, [t[r] for t in cache_layers])
            x, _, nc = _apply_unit(x, up, cfg, g.kinds, None, caches=uc,
                                   pos=pos, dp_shards=dp_shards)
            outs.append(nc)
        new_caches.append(_stack(outs))
    x = _norm(x, params["final_norm"], cfg)
    head = _lm_head(params, cfg).to(dt)
    return (x[:, 0] @ head).float(), new_caches
