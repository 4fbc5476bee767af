"""Optimizers on parameter trees of tensors: AdamW + SGD-momentum.

The torch counterpart of ``repro.optim.optimizers``, written out update
for update (not ``torch.optim``, which rounds differently: the reference
adds weight decay into ``u`` and puts ``eps`` outside the square root of
the bias-corrected ``v``).  ``update`` is functional — every call returns
new tensors and never writes in place, so a caller that skips a step
keeps its parameters and state untouched.  AdamW's ``update`` is its
``update_`` on copies: ``update_`` writes the parameters and both moments
in place, a slice at a time, and lets go of each gradient leaf once it is
applied, so old and new trees are never live together (the LM driver's
memory, ``launch/train.py``).  ``clip_by_global_norm`` is
``clip_by_global_norm_`` on copies likewise.

A parameter tree is a tensor, or a list/tuple/dict of trees; dict leaves
are visited in sorted key order, as ``jax.tree`` does.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

__all__ = ["OptState", "Optimizer", "adamw", "sgd_momentum",
           "clip_by_global_norm", "clip_by_global_norm_", "global_norm",
           "apply_updates", "tree_leaves", "tree_map", "tree_unflatten"]

#: entries of a leaf that an in-place update handles at once: it bounds
#: the float32 temporaries (a few of this size) that one leaf's update
#: makes
INPLACE_SLICE = 1 << 26


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
    #: (grad leaves, state, params) -> new_state, writing params and state
    #: in place and setting each entry of the list to None once applied
    update_: Optional[Callable] = None


def global_norm(leaves) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves))


def _copies(tree):
    with torch.no_grad():
        return tree_map(torch.clone, tree)


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple:
    """(``grads`` scaled to a global norm of at most ``max_norm``, the norm
    before clipping), leaving ``grads`` untouched."""
    leaves = tree_leaves(_copies(grads))
    gn = clip_by_global_norm_(leaves, max_norm)
    return tree_unflatten(grads, leaves), gn


@torch.no_grad()
def clip_by_global_norm_(leaves: list, max_norm: float) -> torch.Tensor:
    """Scale a list of gradient leaves, in place, to a global norm of at
    most ``max_norm``; returns the norm before clipping."""
    gn = global_norm(leaves)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in leaves:
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
    return gn


def _slices(*ts):
    """Matching flat slices of ``INPLACE_SLICE`` entries of tensors of one
    shape (the tensors themselves where one is not contiguous: a flat view
    of it would be a copy)."""
    if not all(t.is_contiguous() for t in ts):
        yield ts
        return
    flat = [t.view(-1) for t in ts]
    for i in range(0, max(flat[0].numel(), 1), INPLACE_SLICE):
        yield tuple(f[i:i + INPLACE_SLICE] for f in flat)


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

    @torch.no_grad()
    def update_(grads: list, state: OptState, params) -> OptState:
        """The step written into ``params``, ``state.m`` and ``state.v``,
        slice by slice, in float32.  ``grads`` is the list of gradient
        leaves in :func:`tree_leaves` order; each entry is set to None once
        its leaf is applied.  Returns the state with the new step."""
        step = state.step + 1
        lr_t = lr(step) if callable(lr) else lr
        bc1 = 1.0 - b1 ** step.float()
        bc2 = 1.0 - b2 ** step.float()
        for i, (m, v, p) in enumerate(zip(tree_leaves(state.m),
                                          tree_leaves(state.v),
                                          tree_leaves(params))):
            g, grads[i] = grads[i], None
            for gs, ms, vs, ps in _slices(g, m, v, p):
                g32 = gs.float()
                m32, v32 = ms.float(), vs.float()   # ms, vs if float32
                m32.mul_(b1).add_(g32 * (1 - b1))
                v32.mul_(b2).add_(g32 * (1 - b2) * g32)
                u = m32 / bc1
                u.div_((v32 / bc2).sqrt_().add_(eps))
                if weight_decay:
                    u.add_(ps.float() * weight_decay)
                u.mul_(lr_t)
                if ps.dtype == torch.float32:
                    ps.sub_(u)
                else:
                    ps.copy_(ps.float().sub_(u))
                if m32 is not ms:
                    ms.copy_(m32)
                    vs.copy_(v32)
            del g
        return OptState(step=step, m=state.m, v=state.v)

    def update(grads, state: OptState, params):
        params = _copies(params)
        state = update_(tree_leaves(grads), OptState(
            step=state.step, m=_copies(state.m), v=_copies(state.v)), params)
        return params, state

    return Optimizer(init=init, update=update, update_=update_)


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
