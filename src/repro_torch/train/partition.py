"""Gradient partitioning for the coded-training bridge (paper §III.1).

The torch counterpart of ``repro.train.partition``.  The paper codes over
K *data* shards: worker m's upload is the coded combination
ĝ_m = Σ_k B[m,k]·g_k of per-shard partial gradients.  This module
supplies:

  * :func:`flatten_grads` / :class:`GradPartition` — a gradient tree
    flattened to one ``(D,)`` float32 payload vector and back, in
    ``jax.flatten_util.ravel_pytree``'s order (list index, then dict keys
    sorted: ``[b0, w0, b1, w1, …]`` for the MLP), so decoded vectors
    compare with the reference's index by index;
  * :func:`shard_assignment` — which data shards each worker computes,
    read off the coding matrix ``B``;
  * :func:`payload_units` — the *measured* per-upload payload, derived
    from the flattened gradient's byte size.

Payload calibration: scenario channel rates are in abstract payload units
per slot; ``DEFAULT_BYTES_PER_UNIT`` (4 MiB) maps measured bytes onto that
scale, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Tuple

import numpy as np
import torch

from repro_torch.core.coding import CodingScheme
from repro_torch.optim.optimizers import (tree_leaves, tree_map,
                                          tree_unflatten)

__all__ = ["DEFAULT_BYTES_PER_UNIT", "GradPartition", "flatten_grads",
           "shard_assignment", "payload_units"]

#: Bytes of flattened gradient per scenario payload unit (4 MiB).
DEFAULT_BYTES_PER_UNIT = float(4 * 2 ** 20)


def flatten_grads(tree: Any) -> torch.Tensor:
    """Flatten a gradient tree into one ``(D,)`` float32 payload vector."""
    return torch.cat([x.reshape(-1).float() for x in tree_leaves(tree)])


def shard_assignment(scheme: CodingScheme) -> List[np.ndarray]:
    """Per-worker data-shard assignment read off the coding matrix: entry
    ``m`` lists the global partition ids worker ``m`` computes (the
    nonzero columns of ``B[m]``, mapped through ``scheme.partitions``)."""
    parts = np.asarray(scheme.partitions)
    return [parts[np.flatnonzero(scheme.B[r] != 0.0)]
            for r in range(scheme.B.shape[0])]


def payload_units(n_bytes: float,
                  bytes_per_unit: float = DEFAULT_BYTES_PER_UNIT) -> float:
    """Measured payload bytes → scenario payload units (``grad_bytes``)."""
    if n_bytes <= 0 or bytes_per_unit <= 0:
        raise ValueError(f"need positive payload and scale, got "
                         f"n_bytes={n_bytes}, "
                         f"bytes_per_unit={bytes_per_unit}")
    return float(n_bytes) / float(bytes_per_unit)


@dataclasses.dataclass(frozen=True)
class GradPartition:
    """Flattening contract for one model's gradients.

    Captured once from a parameter template; every per-shard gradient of
    the same model flattens to the same ``(D,)`` layout, so shard
    gradients stack into the ``(K, D)`` matrix the coded pipeline
    multiplies with ``B`` and the decode kernel reduces.  ``unflatten``
    is the exact inverse; its leaves are views of the flat vector.
    """
    D: int                                 # flattened gradient length
    payload_bytes: float                   # one upload's size in bytes
    template: Any = dataclasses.field(repr=False, compare=False,
                                      default=None)   # structure only
    shapes: Tuple[Tuple[int, ...], ...] = dataclasses.field(
        repr=False, compare=False, default=())

    @classmethod
    def from_params(cls, params: Any) -> "GradPartition":
        shapes = tuple(tuple(x.shape) for x in tree_leaves(params))
        D = sum(math.prod(s) for s in shapes)
        return cls(D=D, payload_bytes=float(D * 4),     # f32 payload
                   template=tree_map(lambda x: None, params),
                   shapes=shapes)

    def unflatten(self, flat: torch.Tensor) -> Any:
        sizes = [math.prod(s) for s in self.shapes]
        parts = torch.split(flat, sizes)
        return tree_unflatten(self.template, [
            p.view(s) for p, s in zip(parts, self.shapes)])

    def flatten_into(self, tree: Any, out: torch.Tensor) -> torch.Tensor:
        """Write ``tree``'s leaves, flattened in :func:`flatten_grads`'
        order and cast to float32, into ``out`` (a ``(D,)`` float32 tensor,
        e.g. a row of the shard-gradient matrix), with no intermediate
        copy of the whole vector; returns ``out``."""
        off = 0
        for x in tree_leaves(tree):
            n = x.numel()
            out[off:off + n].copy_(x.reshape(-1))
            off += n
        if off != self.D or out.shape != (self.D,):
            raise ValueError(f"tree of {off} entries into a "
                             f"{tuple(out.shape)} row; this partition has "
                             f"D={self.D}")
        return out

    def grad_bytes(self,
                   bytes_per_unit: float = DEFAULT_BYTES_PER_UNIT) -> float:
        """This model's per-upload payload in scenario units."""
        return payload_units(self.payload_bytes, bytes_per_unit)
