"""Decoder transformer: dense, RG-LRU and RWKV6 layers, for training and
serving.

The torch counterpart of ``repro.models.transformer`` for configs whose
layers are attention (``attn``/``local``) or the RG-LRU recurrent block
(``rec``) with a dense or gated FFN, or RWKV6 time mix (``rwkv``) with its
channel mix, on token inputs: such as ``stablelm-1.6b``,
``recurrentgemma-2b`` and ``rwkv6-1.6b``.  The parameter tree is the
reference's: ``{"embed", "groups", "final_norm", "lm_head"}``, where
``"groups"`` is a list with one dict per repeating layer unit, each leaf
stacked on a leading layer axis; so :func:`~repro_torch.train.flatten_grads`
flattens a gradient in ``ravel_pytree``'s order and a decoded vector
compares with the reference's index by index.  Decode caches have the
reference's layout too (one dict per group, leaves stacked on the layer
axis).

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

The RWKV6 time mix runs the WKV recurrence through
``repro_torch.kernels.rwkv6_wkv.wkv``: the CUDA kernel on the card, the
plain sequential recurrence on the CPU.  The reference's ``wkv_chunked``
is not ported (``models/rwkv6.py`` says why), so the port's prefill is
exact where the reference's is not.  The kernel is forward-only:
training an ``rwkv`` config on the card raises (the reference trains it
through ``wkv_chunked``, whose backward has no kernel).

The ``rec`` block (``_rec_train``) runs its scan through
``repro_torch.kernels.rglru_scan`` by way of ``models/rglru.py``: the CUDA
kernel on the card, the plain recurrence on the CPU.  That kernel is
forward-only too, so training a ``rec`` config on the card raises.  Its
conv state keeps the last ``conv_width - 1`` pre-conv inputs, left-padded
with zeros for a prompt shorter than that (the reference keeps fewer rows,
and its decode step then fails on them).

Serving: ``prefill`` (a forward that collects the caches), ``pad_cache``,
``init_cache`` and ``decode_step`` (one token, attention over the k/v
cache in plain PyTorch as the reference's ``decode_attention`` is plain
jnp; RG-LRU through ``rglru_step``; RWKV6 through ``wkv_step``).  A
``local`` layer's cache holds min(tokens, window) slots: ``pad_cache``
grows it up to the window, so that decode never overwrites a slot still
inside the window (the reference keeps a prompt shorter than the window
at its length, and its decode then drops tokens that are in the window).

Not here yet (each raises ``NotImplementedError``): mixture-of-experts
FFNs and the audio/vision frontends (ROADMAP.md, queue 1).
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
from repro_torch.models.rwkv6 import wkv_step
from repro_torch.optim.optimizers import tree_leaves, tree_unflatten

__all__ = ["GroupDef", "group_layout", "model_specs", "init_params",
           "params_from_numpy", "forward", "loss_fn", "chunked_ce",
           "prefill", "decode_step", "init_cache", "pad_cache"]

_LATER = "not ported yet: see ROADMAP.md, queue 1"


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.frontend != "none":
        raise NotImplementedError(f"the {cfg.frontend} frontend is {_LATER}")
    for mixer, ffn in cfg.layer_kinds():
        if mixer not in ("attn", "local", "rec", "rwkv"):
            raise NotImplementedError(f"the {mixer!r} mixer is {_LATER}")
        if ffn != "dense" and mixer != "rwkv":
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
    _check_supported(cfg)
    d, V = cfg.d_model, cfg.vocab
    specs: dict = {"embed": Spec((V, d), ("vocab", "embed"), "embed")}
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


def _ffn_apply(x, p, cfg: ModelConfig):
    act = activation(cfg.act)
    h = _norm(x, p["ln"], cfg)
    if cfg.gated_ffn:
        out = (act(h @ p["wg"]) * (h @ p["wu"])) @ p["wd"]
    else:
        out = act(h @ p["wu"]) @ p["wd"]
    return x + out


def _apply_unit(x, unit_params, cfg: ModelConfig, kinds, positions,
                caches=None, pos=None, collect: bool = False):
    """One pattern unit (a list of layers) on the residual stream: a
    full-sequence pass (``caches`` None) or one decode step at ``pos``.
    Returns ``(x, new caches)`` in the reference's per-layer layout
    (``{"mix": ..., "ffn": ...}``; a full-sequence attention layer gives
    its ``(k, v)``) in decode or with ``collect``, else ``(x, None)``: a
    training pass drops each layer's cache before its FFN runs, so that
    k and v do not stay alive through it."""
    decode = caches is not None
    keep = decode or collect
    new_caches = {}
    for j, (mixer, _) in enumerate(kinds):
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
            x = _ffn_apply(x, lp["ffn"], cfg)
            entry = {"mix": mix_cache}
        if keep:
            new_caches[f"l{j}"] = entry
    return x, (new_caches if keep else None)


def _stack(trees: list) -> Any:
    """Trees of one structure -> one tree, leaves stacked on a new axis 0
    (the layout of the reference's scanned caches)."""
    cols = zip(*(tree_leaves(t) for t in trees))
    return tree_unflatten(trees[0], [torch.stack(c) for c in cols])


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
def forward(params, batch, cfg: ModelConfig, *, collect_cache: bool = False):
    """Full-sequence forward.  Returns ``(hidden (B, S, d), aux)``; aux
    (the MoE balance loss in the reference) is zero here.  With
    ``collect_cache`` it returns ``(hidden, aux, caches)``: each group's
    per-layer caches stacked on the layer axis, as the reference's (and
    without ``remat``, as the reference's)."""
    _check_supported(cfg)
    dt = _dtype(cfg.compute_dtype)
    x = _embed_inputs(params, batch, cfg).to(dt)
    positions = torch.arange(x.shape[1], device=x.device)
    remat = cfg.remat in ("full", "dots") and not collect_cache
    all_caches = []
    for g, gp in zip(group_layout(cfg), params["groups"]):
        # one unbind per stacked leaf: its backward stacks the layers'
        # gradients once, where indexing would add a full-size zero
        # tensor per layer
        layers = [torch.unbind(t) for t in tree_leaves(gp)]

        def unit(x, *leaves, kinds=g.kinds, gp=gp):
            up = tree_unflatten(gp, [t.to(dt) for t in leaves])
            return _apply_unit(x, up, cfg, kinds, positions,
                               collect=collect_cache)

        def unit_x(x, *leaves, unit=unit):
            return unit(x, *leaves)[0]

        caches = []
        for r in range(g.n_repeat):
            leaves = [layer[r] for layer in layers]
            if collect_cache:
                x, c = unit(x, *leaves)
                caches.append(c)
            elif remat:
                x = checkpoint(unit_x, x, *leaves, use_reentrant=False)
            else:
                x = unit_x(x, *leaves)
        if collect_cache:
            all_caches.append(_stack(caches))
    x = _norm(x, params["final_norm"], cfg)
    aux = torch.zeros((), device=x.device)
    return (x, aux, all_caches) if collect_cache else (x, aux)


def loss_fn(params, batch, cfg: ModelConfig):
    """Weighted CE training loss.

    batch: ``tokens`` (B, S) + ``labels`` (B, S) + ``weights`` (B, S).
    """
    x, aux = forward(params, batch, cfg)
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
    _check_supported(cfg)
    return [{f"l{j}": _layer_cache(cfg, mixer, B, cap, g.n_repeat, device)
             for j, (mixer, _) in enumerate(g.kinds)}
            for g in group_layout(cfg)]


@torch.no_grad()
def prefill(params, batch, cfg: ModelConfig):
    """Forward + build decode caches.  Returns ``(last_logits (B, V)
    float32, caches, pos)`` with ``pos`` = S, the next token's position."""
    x, _, raw = forward(params, batch, cfg, collect_cache=True)
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
def decode_step(params, tokens, caches: list, pos: int, cfg: ModelConfig):
    """One serve step: ``tokens`` (B, 1) at position ``pos`` -> ``(logits
    (B, V) float32, new caches)``.  Full-attention layers write the token
    at ``pos`` (callers keep pos < cap); local layers write slot ``pos``
    until the cache holds ``window`` slots and use it as a ring after
    that; RG-LRU and RWKV layers step their state."""
    _check_supported(cfg)
    dt = _dtype(cfg.compute_dtype)
    # gather, then cast: the reference's take of the cast table, cheaper
    x = F.embedding(tokens.long(), params["embed"]).to(dt)
    new_caches = []
    for g, gp, gc in zip(group_layout(cfg), params["groups"], caches):
        layers = [torch.unbind(t) for t in tree_leaves(gp)]
        cache_layers = [torch.unbind(t) for t in tree_leaves(gc)]
        outs = []
        for r in range(g.n_repeat):
            up = tree_unflatten(gp, [t[r].to(dt) for t in layers])
            uc = tree_unflatten(gc, [t[r] for t in cache_layers])
            x, nc = _apply_unit(x, up, cfg, g.kinds, None, caches=uc,
                                pos=pos)
            outs.append(nc)
        new_caches.append(_stack(outs))
    x = _norm(x, params["final_norm"], cfg)
    head = _lm_head(params, cfg).to(dt)
    return (x[:, 0] @ head).float(), new_caches
