"""Wrapper of the RG-LRU scan kernel: ``h_t = a_t ⊙ h_{t-1} + b_t``,
forward only.

``rglru_scan(a, b)`` launches the hand-written kernel of
``csrc/rglru_scan.cu`` (built with nvcc at first use) on the current stream
for CUDA tensors, or raises; for CPU tensors it computes the plain version
(:func:`~repro_torch.kernels.rglru_scan.ref.rglru_ref`).
``rglru_scan.launches`` counts the kernel's launches, not the CPU path's
calls.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import load_library
from .ref import rglru_ref

__all__ = ["SOURCE", "rglru_ref", "rglru_scan", "smem_bytes"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(str(SOURCE))
    lib.rglru_scan_fwd.argtypes = [_I] + [_P] * 4 + [_I] * 3 + [_P]
    lib.rglru_scan_fwd.restype = _I
    lib.rglru_scan_smem_bytes.argtypes = [_I]
    lib.rglru_scan_smem_bytes.restype = _I
    lib.rglru_scan_error_string.argtypes = [_I]
    lib.rglru_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(a, b) -> None:
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"want a and b of one shape (B, S, D), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"a and b must share float32 or bfloat16, got "
                        f"{a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rglru_scan runs on cuda or cpu, not {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    if 0 in a.shape:
        raise ValueError(f"empty input {tuple(a.shape)}")


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """a, b: (B, S, D), one type (float32 or bfloat16), contiguous, on one
    device.  Returns ``(out (B, S, D) in a's type, h_last (B, D) float32)``
    of the recurrence from a zero state.  On the card the call is
    forward-only and refuses inputs that need a gradient; on the CPU the
    plain recurrence is differentiable."""
    _check(a, b)
    if a.device.type == "cpu":
        return rglru_ref(a, b)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise NotImplementedError(
            "the RG-LRU scan kernel is forward-only: training a 'rec' layer "
            "on the card needs a backward kernel, a reverse linear scan "
            "(ROADMAP.md)")
    return _launch(a, b)


rglru_scan.launches = 0


def _launch(a, b):
    """One launch on checked CUDA inputs, counted in
    ``rglru_scan.launches``: the copy ring where ``a`` and ``b`` are
    16-byte aligned and a row of D elements is a multiple of 16 bytes,
    else the register-fed rows kernel (``csrc/rglru_scan.cu``)."""
    B, S, D = a.shape
    out = torch.empty_like(a)
    h_last = torch.empty((B, D), dtype=torch.float32, device=a.device)
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.rglru_scan_fwd(_DTYPES[a.dtype], a.data_ptr(),
                                 b.data_ptr(), out.data_ptr(),
                                 h_last.data_ptr(), B, S, D, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {err} "
                           f"({lib.rglru_scan_error_string(err).decode()})")
    rglru_scan.launches += 1
    return out, h_last


def smem_bytes(dtype: torch.dtype) -> int:
    """Dynamic shared memory a block of the ring takes (builds it)."""
    return _library().rglru_scan_smem_bytes(_DTYPES[dtype])
