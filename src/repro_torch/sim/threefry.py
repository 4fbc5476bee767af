"""Counter-based draws: numpy copies of ``jax.random``'s threefry pieces.

The soak harness (``repro_torch.sim.soak``) draws each slot's uniforms as
the reference does, ``jax.random.uniform(jax.random.fold_in(key, k),
(3, M), float32)`` — a pure function of the seed and the absolute slot
index ``k``.  The port computes the same bits on the host, in numpy
integer arithmetic, so the draws are identical on the CPU and on the card
and equal ``jax.random``'s bit for bit (``tests/test_torch_threefry.py``):

  * :func:`threefry2x32` is the Threefry-2x32 block cipher (20 rounds,
    key schedule every four), as ``jax._src.prng`` lowers it;
  * :func:`prng_key` is the legacy ``jax.random.PRNGKey(seed)``, a
    ``uint32[2]`` pair ``(seed >> 32, seed & 0xFFFFFFFF)`` of a 32-bit
    seed (so the high word is 0);
  * :func:`fold_in` is ``threefry2x32(key, (0, data))``;
  * :func:`uniform_bits` follows the partitionable counter layout (jax's
    ``jax_threefry_partitionable``, on by default since jax 0.5): the
    element at flat index ``i`` of the output is ``y0 ^ y1`` of
    ``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``;
  * :func:`bits_to_unit_float32` maps 32 random bits to ``[0, 1)`` as
    ``jax.random.uniform`` does: keep the top 23 bits as the mantissa of a
    float in ``[1, 2)``, subtract 1;
  * :func:`split` is ``jax.random.split`` in the same layout: key ``i`` of
    the result is both output words of ``threefry2x32(key, (i >> 32,
    i & 0xFFFFFFFF))``.

:func:`uniform_device` draws the same float32 uniforms on any torch
device, for draws too many for the host (one per gradient entry, in the
compressors of ``repro_torch.compress``): on the card the cipher runs in
int64 tensors whose words are masked to 32 bits after every add and
rotation (:func:`uniform_tensors`), so its bits are the host's.

:func:`slot_uniforms` draws a whole chunk of slots at once, ``(n, 3, M)``
float32, in one vectorised pass; the rows depend on ``(seed, k)`` only,
never on how the slots are split into chunks.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["threefry2x32", "prng_key", "fold_in", "split", "uniform_bits",
           "bits_to_unit_float32", "slot_uniforms", "uniform_device",
           "uniform_tensors"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 of the count words ``(x0, x1)`` under ``key = (k0,
    k1)``; every word is a uint32 array and they broadcast, so one call
    hashes many counters under many keys.  Returns the two output words."""
    k0, k1 = (np.asarray(k, np.uint32) for k in key)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32)
    x1 = np.asarray(x1, np.uint32)
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed that fits int32: the
    ``uint32[2]`` key ``(0, seed mod 2**32)``."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed must fit int32, got {seed}")
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def fold_in(key, data) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the key hashed with the counter
    ``(0, data mod 2**32)``.  ``data`` may be an array of counters; the
    result then has shape ``data.shape + (2,)``."""
    d = (np.asarray(data).astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)
    y0, y1 = threefry2x32(np.asarray(key, np.uint32), np.zeros_like(d), d)
    return np.stack([y0, y1], axis=-1)


def split(key, num=2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``num`` (an int or a shape) new keys,
    ``(*shape, 2)`` uint32; key ``i`` (flat index) is the cipher of the
    counter ``(i >> 32, i & 0xFFFFFFFF)``."""
    shape = (int(num),) if np.ndim(num) == 0 else tuple(int(n) for n in num)
    i = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64)
    hi = (i >> np.uint64(32)).astype(np.uint32)
    lo = (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    y0, y1 = threefry2x32(np.asarray(key, np.uint32).reshape(2), hi, lo)
    return np.stack([y0, y1], axis=-1).reshape(shape + (2,))


def _bits_for_keys(keys: np.ndarray, size: int) -> np.ndarray:
    """``(…, size)`` uint32 random bits of each ``(…, 2)`` key, in the
    partitionable counter layout."""
    i = np.arange(size, dtype=np.uint64)
    hi = (i >> np.uint64(32)).astype(np.uint32)
    lo = (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    y0, y1 = threefry2x32((keys[..., 0:1], keys[..., 1:2]), hi, lo)
    return y0 ^ y1


def uniform_bits(key, shape) -> np.ndarray:
    """The 32-bit words ``jax.random.uniform(key, shape, float32)`` turns
    into floats (``jax.random.bits(key, shape, uint32)``)."""
    shape = tuple(int(s) for s in shape)
    size = int(np.prod(shape, dtype=np.int64))
    keys = np.asarray(key, np.uint32).reshape(2)
    return _bits_for_keys(keys, size).reshape(shape)


def bits_to_unit_float32(bits: np.ndarray) -> np.ndarray:
    """jax's map of uint32 words to float32 in ``[0, 1)``:
    ``(bits >> 9) | 0x3f800000`` read as a float, minus 1."""
    b = (np.asarray(bits, np.uint32) >> np.uint32(9)) | np.uint32(0x3F800000)
    return b.view(np.float32) - np.float32(1.0)


def slot_uniforms(seed: int, k0: int, n: int, M: int) -> np.ndarray:
    """``(n, 3, M)`` float32: row ``j`` is ``uniform(fold_in(PRNGKey(seed),
    k0 + j), (3, M))`` — the arrival, harvest and channel uniforms of
    absolute slot ``k0 + j``, drawn for the whole chunk in one pass."""
    keys = fold_in(prng_key(seed), np.arange(k0, k0 + n, dtype=np.int64))
    bits = _bits_for_keys(keys, 3 * M)                      # (n, 3M)
    return bits_to_unit_float32(bits).reshape(n, 3, M)


_MASK = 0xFFFFFFFF


def _threefry_tensors(key, x0: torch.Tensor, x1: torch.Tensor) -> tuple:
    """:func:`threefry2x32` of int64 tensors holding uint32 words, in
    place: every sum and rotation is masked back to 32 bits."""
    k0, k1 = (int(k) for k in np.asarray(key, np.uint32).reshape(2))
    ks = (k0, k1, k0 ^ k1 ^ int(_PARITY))
    x0.add_(ks[0]).bitwise_and_(_MASK)
    x1.add_(ks[1]).bitwise_and_(_MASK)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_MASK)
            high = x1 << r
            x1.bitwise_right_shift_(32 - r).bitwise_or_(high)
            x1.bitwise_and_(_MASK).bitwise_xor_(x0)
            del high
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_MASK)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_MASK)
    return x0, x1


def uniform_device(key, start: int, count: int, device) -> torch.Tensor:
    """Flat entries ``[start, start + count)`` of ``jax.random.uniform(key,
    shape, float32)`` (for any shape of more than ``start + count``
    entries), computed on ``device``: ``count`` float32 values, bit-equal
    to :func:`uniform_bits` and :func:`bits_to_unit_float32`.  On the CPU
    the host's numpy words are the faster route (one thread, uint32) and
    are taken; elsewhere :func:`uniform_tensors`."""
    if torch.device(device).type != "cpu":
        return uniform_tensors(key, start, count, device)
    i = np.arange(int(start), int(start) + int(count), dtype=np.uint64)
    y0, y1 = threefry2x32(np.asarray(key, np.uint32).reshape(2),
                          (i >> np.uint64(32)).astype(np.uint32),
                          (i & np.uint64(_MASK)).astype(np.uint32))
    return torch.from_numpy(bits_to_unit_float32(y0 ^ y1))


def uniform_tensors(key, start: int, count: int, device) -> torch.Tensor:
    """:func:`uniform_device`'s values by the cipher in int64 torch tensors
    on ``device`` (its route on the card)."""
    i = torch.arange(int(start), int(start) + int(count), dtype=torch.int64,
                     device=device)
    x0 = i >> 32
    x1 = i.bitwise_and_(_MASK)
    y0, y1 = _threefry_tensors(key, x0, x1)
    bits = y0.bitwise_xor_(y1).bitwise_right_shift_(9).bitwise_or_(
        0x3F800000)
    return bits.to(torch.int32).view(torch.float32) - 1.0
