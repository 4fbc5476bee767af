"""Fault-tolerant checkpointing: atomic, retained, asynchronous.

The torch counterpart of ``repro.checkpoint.checkpointer``, on the same
on-disk format, so a checkpoint written by either package restores in the
other:

  * one ``.npz`` per step: leaf ``i`` stored as its raw bytes under
    ``a{i}`` (``uint8``), plus ``__meta__``, the JSON of ``keys`` (the
    reference's ``jax.tree_util.keystr`` of each leaf's path, in its leaf
    order), ``step``, ``shapes`` and ``dtypes`` (numpy names:
    ``"float32"``, ``"bfloat16"``, ``"int32"``, ...);
  * save = write ``.tmp`` then atomic ``os.replace`` — a crash mid-save
    never corrupts the latest checkpoint;
  * ``latest_step`` + ``restore`` give crash-restart semantics;
  * retention keeps the last N checkpoints;
  * ``async_save`` copies the tree to host memory, then writes it on a
    thread while training goes on.

bfloat16 leaves travel as ``torch.uint8`` views of their bytes, so no numpy
bfloat16 type is needed.  Restore matches leaves to the template in order,
checks the count and each shape, and casts each leaf to the template's
dtype and device.
"""
from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.optim.optimizers import tree_leaves, tree_unflatten

__all__ = ["Checkpointer", "save_pytree", "restore_pytree"]

_DTYPES = {torch.float32: "float32", torch.float64: "float64",
           torch.float16: "float16", torch.bfloat16: "bfloat16",
           torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
           torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool"}
_TORCH = {name: dt for dt, name in _DTYPES.items()}


def _key_paths(tree, prefix: str = "") -> list:
    """``jax.tree_util.keystr`` of each leaf's path, in
    :func:`tree_leaves` order: ``['key']`` for a dict entry, ``.name`` for
    a named-tuple field, ``[i]`` for a list or tuple item."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _key_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [p for name, t in zip(tree._fields, tree)
                for p in _key_paths(t, f"{prefix}.{name}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree)
                for p in _key_paths(t, f"{prefix}[{i}]")]
    return [prefix]


def _as_tensor(leaf) -> torch.Tensor:
    return leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(
        np.asarray(leaf))


def save_pytree(path: str, tree: Any, *, step: Optional[int] = None) -> None:
    keys = _key_paths(tree)
    arrays, shapes, dtypes = {}, [], []
    for i, leaf in enumerate(tree_leaves(tree)):
        t = _as_tensor(leaf).detach().cpu().contiguous()
        arrays[f"a{i}"] = t.reshape(-1).view(torch.uint8).numpy()
        shapes.append(list(t.shape))
        dtypes.append(_DTYPES[t.dtype])
    meta = {"keys": keys, "step": step, "shapes": shapes, "dtypes": dtypes}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8), **arrays)
    os.replace(tmp, path)


def restore_pytree(path: str, template: Any) -> Any:
    """The checkpoint at ``path`` as a tree shaped like ``template``, each
    leaf cast to the template leaf's dtype on its device."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = [
            torch.from_numpy(np.array(z[f"a{i}"], np.uint8)).view(
                _TORCH[meta["dtypes"][i]]).reshape(meta["shapes"][i])
            for i in range(len(meta["keys"]))]
    flat_t = tree_leaves(template)
    if len(flat_t) != len(arrays):
        raise ValueError(f"checkpoint has {len(arrays)} leaves, template "
                         f"expects {len(flat_t)}")
    out = []
    for arr, t in zip(arrays, flat_t):
        t = _as_tensor(t)
        if tuple(t.shape) != tuple(arr.shape):
            raise ValueError(f"shape mismatch: ckpt {tuple(arr.shape)} vs "
                             f"template {tuple(t.shape)}")
        out.append(arr.to(device=t.device, dtype=t.dtype))
    return tree_unflatten(template, out)


class Checkpointer:
    """Directory-of-steps checkpoint manager with retention + async save."""

    _PAT = re.compile(r"step_(\d+)\.npz$")

    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}.npz")

    def all_steps(self) -> list:
        steps = []
        for f in os.listdir(self.dir):
            m = self._PAT.search(f)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any) -> None:
        save_pytree(self._path(step), tree, step=step)
        self._retain()

    def async_save(self, step: int, tree: Any) -> None:
        """Snapshot to host memory synchronously, write in background."""
        host = tree_unflatten(tree, [_as_tensor(x).detach().to(
            "cpu", copy=True) for x in tree_leaves(tree)])
        self.wait()
        self._thread = threading.Thread(
            target=lambda: self.save(step, host), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, template: Any, step: Optional[int] = None) -> tuple:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return step, restore_pytree(self._path(step), template)

    def _retain(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            try:
                os.remove(self._path(s))
            except OSError:
                pass
