"""Optimizers on parameter trees of tensors: AdamW + SGD-momentum.

The torch counterpart of ``repro.optim.optimizers``, written out update
for update (not ``torch.optim``, which rounds differently: the reference
adds weight decay into ``u`` and puts ``eps`` outside the square root of
the bias-corrected ``v``).  Updates are functional — every call returns
new tensors and never writes in place, so a caller that skips a step
keeps its parameters and state untouched.

A parameter tree is a tensor, or a list/tuple/dict of trees; dict leaves
are visited in sorted key order, as ``jax.tree`` does.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

__all__ = ["OptState", "Optimizer", "adamw", "sgd_momentum",
           "clip_by_global_norm", "apply_updates", "tree_leaves",
           "tree_map", "tree_unflatten"]


def tree_leaves(tree) -> list:
    """Leaves of a parameter tree, in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(template, leaves) -> Any:
    """A tree shaped like ``template`` holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    return _build(template, iter(leaves))


def _build(t, it) -> Any:
    # a module-level recursion: a nested recursive closure would form a
    # reference cycle holding ``leaves`` (e.g. a layer's weights cast to
    # bf16) until the garbage collector runs
    if isinstance(t, dict):
        built = {k: _build(t[k], it) for k in sorted(t)}
        return {k: built[k] for k in t}
    if isinstance(t, tuple) and hasattr(t, "_fields"):     # a NamedTuple
        return type(t)(*(_build(x, it) for x in t))
    if isinstance(t, (list, tuple)):
        return type(t)(_build(x, it) for x in t)
    return next(it)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over matching leaves of trees of one structure."""
    return tree_unflatten(tree, [fn(*xs) for xs in zip(
        tree_leaves(tree), *(tree_leaves(r) for r in rest))])


class OptState(NamedTuple):
    step: torch.Tensor   # () int32
    m: Any
    v: Any               # () for sgd


class Optimizer(NamedTuple):
    init: Callable
    update: Callable     # (grads, state, params) -> (new_params, new_state)


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple:
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def adamw(lr: float | Callable = 1e-3, *, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          state_dtype: torch.dtype = torch.float32) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=state_dtype, device=p.device)
        step = torch.zeros((), dtype=torch.int32,
                           device=tree_leaves(params)[0].device)
        return OptState(step=step, m=tree_map(zeros, params),
                        v=tree_map(zeros, params))

    def update(grads, state: OptState, params):
        step = state.step + 1
        lr_t = lr(step) if callable(lr) else lr
        bc1 = 1.0 - b1 ** step.float()
        bc2 = 1.0 - b2 ** step.float()

        def upd(g, m, v, p):
            g32 = g.float()
            m32 = b1 * m.float() + (1 - b1) * g32
            v32 = b2 * v.float() + (1 - b2) * g32 * g32
            u = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            newp = (p.float() - lr_t * u).to(p.dtype)
            return newp, m32.to(state_dtype), v32.to(state_dtype)

        out = [upd(*xs) for xs in zip(
            tree_leaves(grads), tree_leaves(state.m), tree_leaves(state.v),
            tree_leaves(params))]
        return (tree_unflatten(grads, [o[0] for o in out]),
                OptState(step=step,
                         m=tree_unflatten(grads, [o[1] for o in out]),
                         v=tree_unflatten(grads, [o[2] for o in out])))

    return Optimizer(init=init, update=update)


def sgd_momentum(lr: float | Callable = 1e-2, *, momentum: float = 0.9,
                 state_dtype: torch.dtype = torch.float32) -> Optimizer:
    def init(params):
        step = torch.zeros((), dtype=torch.int32,
                           device=tree_leaves(params)[0].device)
        return OptState(step=step, m=tree_map(
            lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                  device=p.device), params), v=())

    def update(grads, state: OptState, params):
        step = state.step + 1
        lr_t = lr(step) if callable(lr) else lr

        def upd(g, m, p):
            m32 = momentum * m.float() + g.float()
            newp = (p.float() - lr_t * m32).to(p.dtype)
            return newp, m32.to(state_dtype)

        out = [upd(*xs) for xs in zip(
            tree_leaves(grads), tree_leaves(state.m), tree_leaves(params))]
        return (tree_unflatten(grads, [o[0] for o in out]),
                OptState(step=step,
                         m=tree_unflatten(grads, [o[1] for o in out]),
                         v=()))

    return Optimizer(init=init, update=update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype),
                    params, updates)
