"""Gradient compression for the cross-worker reduce (beyond-paper).

The torch counterpart of ``repro.compress.quantize``, equal to it value for
value: the same int8 codes, scales, residuals and masks from the same
key (``tests/test_torch_compress.py``).

  * int8 stochastic-rounding quantization with one scale per block of
    256 values, unbiased: E[deq(q(x))] = x.  The noise is
    ``jax.random.uniform(key, (n_blocks, 256))``, drawn on the tensor's
    device by :func:`repro_torch.sim.threefry.uniform_device`, a slice of
    ``DRAW_SLICE`` entries at a time (its int64 temporaries are the
    route's memory).
  * error feedback (EF-SGD): the residual from compression is carried and
    added to the next step's gradient, preserving convergence.
  * top-k sparsification with EF (mask-based: fixed k; ties at the k-th
    largest magnitude are all kept).

Keys are host ``uint32[2]`` arrays (``threefry.prng_key``, ``split``,
``fold_in``).  :class:`ErrorFeedback` wraps a compressor into the
``grads -> grads`` hook of ``repro_torch.launch.steps.make_train_step``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.optim.optimizers import tree_leaves, tree_unflatten
from repro_torch.sim import threefry

__all__ = ["quantize_int8", "dequantize_int8", "make_ef_quantizer",
           "topk_mask", "make_ef_topk", "ErrorFeedback"]

_BLOCK = 256
#: entries of a leaf whose noise is drawn at once
DRAW_SLICE = 1 << 24


def quantize_int8(x: torch.Tensor, key) -> tuple:
    """Per-block-scaled int8 stochastic-rounding quantization: ``(q
    (n_blocks, 256) int8, scale (n_blocks, 1) float32)`` on x's device."""
    flat = F.pad(x.float().reshape(-1), (0, (-x.numel()) % _BLOCK))
    blocks = flat.view(-1, _BLOCK)
    scale = torch.clamp_min(blocks.abs().amax(dim=1, keepdim=True) / 127.0,
                            1e-12)
    q = torch.empty(blocks.shape, dtype=torch.int8, device=x.device)
    rows = DRAW_SLICE // _BLOCK
    for r0 in range(0, blocks.shape[0], rows):
        y = blocks[r0:r0 + rows] / scale[r0:r0 + rows]
        noise = threefry.uniform_device(key, r0 * _BLOCK, y.numel(),
                                        x.device).view(y.shape)
        q[r0:r0 + rows] = torch.clamp(torch.floor(y.add_(noise)), -127, 127)
        del y, noise
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    size: int) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)[:size]
    return flat.reshape(shape)


def _zeros(params, device=None):
    return tree_unflatten(params, [
        torch.zeros(p.shape, dtype=torch.float32,
                    device=p.device if device is None else device)
        for p in tree_leaves(params)])


def make_ef_quantizer():
    """Returns (init, transform): error-feedback int8 gradient compressor.

    ``init(params, device=None)`` gives float32 zero residuals (on each
    leaf's device, or on ``device``).  ``transform(grads, errors, key) ->
    (compressed_grads, new_errors)``: each leaf is quantized and
    dequantized (what the wire would carry) with its own key of
    ``split(key, n_leaves)``, and the residual is carried to the next step.
    """
    def transform(grads, errors, key):
        leaves = tree_leaves(grads)
        keys = threefry.split(key, len(leaves))
        outs, new_errs = [], []
        for g, e, k in zip(leaves, tree_leaves(errors), keys):
            corrected = g.float() + e
            q, s = quantize_int8(corrected, k)
            deq = dequantize_int8(q, s, corrected.shape, corrected.numel())
            del q, s
            outs.append(deq.to(g.dtype))
            new_errs.append(corrected.sub_(deq))
            del deq
        return tree_unflatten(grads, outs), tree_unflatten(grads, new_errs)

    return _zeros, transform


def topk_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """1 where ``|x|`` is at least its k-th largest value, else 0, in x's
    type."""
    flat = x.reshape(-1).abs()
    thresh = torch.topk(flat, k, sorted=False).values.min()
    return (x.abs() >= thresh).to(x.dtype)


def make_ef_topk(fraction: float = 0.05):
    """Error-feedback top-k sparsifier (k = fraction · size per leaf):
    ``(init, transform)`` with ``transform(grads, errors) ->
    (sent_grads, new_errors)``."""
    def transform(grads, errors):
        outs, new_errs = [], []
        for g, e in zip(tree_leaves(grads), tree_leaves(errors)):
            corrected = g.float() + e
            k = max(int(corrected.numel() * fraction), 1)
            sent = corrected * topk_mask(corrected, k)
            outs.append(sent.to(g.dtype))
            new_errs.append(corrected.sub_(sent))
            del sent
        return tree_unflatten(grads, outs), tree_unflatten(grads, new_errs)

    return _zeros, transform


class ErrorFeedback:
    """A compressor as a ``grads -> grads`` hook that carries its residuals
    from call to call: ``compressor`` is ``(init, transform)`` of
    :func:`make_ef_quantizer` (then ``key`` is required, and call ``n``
    draws with ``fold_in(key, n)``) or of :func:`make_ef_topk`.
    ``errors`` holds the residuals after the last call."""

    def __init__(self, compressor: tuple, params, key=None):
        init, self.transform = compressor
        self.errors = init(params)
        self.key = key
        self.calls = 0

    def __call__(self, grads):
        if self.key is None:
            out, errors = self.transform(grads, self.errors)
        else:
            out, errors = self.transform(grads, self.errors, threefry.fold_in(
                self.key, self.calls))
        self.errors = errors
        self.calls += 1
        return out

