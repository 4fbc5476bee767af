"""Shared model building blocks: parameter specs, norms, RoPE, activations.

The torch counterpart of ``repro.models.common`` for the dense path.
Parameters are declared as ``Spec`` (shape, logical axes, init) and made
by :func:`init_from_specs` from an explicit ``torch.Generator``.  Those
draws are not the reference's (``jax.random`` cannot be reproduced here):
parity tests carry the reference's weights across instead
(``transformer.params_from_numpy``).
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.optim.optimizers import tree_unflatten

__all__ = ["Spec", "init_from_specs", "is_spec", "spec_leaves",
           "spec_template", "rms_norm",
           "layer_norm", "activation", "rope", "apply_rope"]


class Spec(NamedTuple):
    shape: tuple
    axes: tuple                 # logical axis names (None = replicated dim)
    init: str = "normal"        # normal | zeros | ones | scaled | embed
    scale: float = 1.0


def is_spec(x) -> bool:
    return isinstance(x, Spec)


def spec_leaves(specs: Any) -> list:
    """The ``Spec`` leaves of a tree, in ``jax.tree.leaves`` order (a
    ``Spec`` is a tuple, so the generic walk must stop at it)."""
    if is_spec(specs):
        return [specs]
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    if isinstance(specs, (list, tuple)):
        return [x for t in specs for x in spec_leaves(t)]
    raise TypeError(f"not a spec tree: {type(specs)}")


def spec_template(specs: Any) -> Any:
    """``specs`` with every ``Spec`` replaced by ``None`` (the structure
    :func:`tree_unflatten` fills)."""
    if is_spec(specs):
        return None
    if isinstance(specs, dict):
        return {k: spec_template(v) for k, v in specs.items()}
    return type(specs)(spec_template(x) for x in specs)


#: Leaves of more entries than this are drawn a slice of ``_DRAW_SLICE``
#: entries at a time, so that no float32 copy of the whole leaf exists
#: (llama4's expert stacks are 5.4 G entries, 21.5 GB in float32).
_WHOLE_DRAW_MAX, _DRAW_SLICE = 1 << 30, 1 << 28


def _draw(n: int, std: float, dtype, generator, device) -> torch.Tensor:
    x = torch.empty(n, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (x * std).to(dtype)


def _init_one(spec: Spec, dtype, generator, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    fan_in = spec.shape[0] if len(spec.shape) >= 2 else spec.shape[-1]
    std = spec.scale / math.sqrt(max(fan_in, 1))
    if spec.init == "embed":
        std = 0.02 * spec.scale
    n = math.prod(spec.shape)
    if n <= _WHOLE_DRAW_MAX:
        return _draw(n, std, dtype, generator, device).reshape(spec.shape)
    out = torch.empty(n, dtype=dtype, device=device)
    for i in range(0, n, _DRAW_SLICE):
        m = min(_DRAW_SLICE, n - i)
        out[i:i + m] = _draw(m, std, dtype, generator, device)
    return out.reshape(spec.shape)


def init_from_specs(specs: Any, dtype, generator: Optional[torch.Generator],
                    device="cuda") -> Any:
    """A tree of ``Spec`` -> a tree of tensors: truncated normals in
    [-2, 2] times ``scale/sqrt(fan_in)`` (``0.02·scale`` for embeddings),
    zeros or ones, drawn in leaf order from ``generator`` (which lives on
    ``device``)."""
    vals = [_init_one(s, dtype, generator, device)
            for s in spec_leaves(specs)]
    return tree_unflatten(spec_template(specs), vals)


# --------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``x / rms(x) · (1 + w)``, in float32, back in x's type."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + w.float())
    return out.to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps) * w.float() + b.float()
    return out.to(dt)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {"silu": F.silu, "gelu": _gelu, "relu": F.relu}[name]


# --------------------------------------------------------------------- #
def rope(positions: torch.Tensor, head_dim: int, theta: float) -> tuple:
    """(sin, cos) tables for integer positions (…,): (…, head_dim/2)."""
    half = head_dim // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=positions.device) / half)
    angles = positions[..., None].float() * freq
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: (B, S, *head_axes, D); sin/cos: (S, D/2).  Head axes (any
    number, e.g. (KV, G) for grouped queries) are broadcast."""
    half = x.shape[-1] // 2
    shape = (1, sin.shape[0]) + (1,) * (x.dim() - 3) + (half,)
    sin, cos = sin.reshape(shape), cos.reshape(shape)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
