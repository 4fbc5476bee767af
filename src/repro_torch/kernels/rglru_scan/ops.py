"""Wrapper of the RG-LRU scan kernels: ``h_t = a_t ⊙ h_{t-1} + b_t``,
forward and backward, as a ``torch.autograd.Function``.

``rglru_scan(a, b)`` launches the hand-written kernels of
``csrc/rglru_scan.cu`` (built with nvcc at first use) on the current stream
for CUDA tensors, or raises; for CPU tensors it computes the plain versions
(:func:`~repro_torch.kernels.rglru_scan.ref.rglru_ref` forward,
:func:`~repro_torch.kernels.rglru_scan.ref.rglru_bwd_ref` backward).
``rglru_scan.launches`` and ``.bwd_launches`` count the kernels' launches,
not the CPU path's calls.  A float32 forward saves its output, which is
the states the backward needs; a bfloat16 one saves a and b, and the
backward kernel recomputes the states in float32.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import load_library
from .ref import rglru_bwd_ref, rglru_ref

__all__ = ["SOURCE", "rglru_bwd", "rglru_bwd_ref", "rglru_ref", "rglru_scan",
           "smem_bytes"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(str(SOURCE))
    lib.rglru_scan_fwd.argtypes = [_I] + [_P] * 4 + [_I] * 3 + [_P]
    lib.rglru_scan_fwd.restype = _I
    lib.rglru_scan_bwd.argtypes = [_I] + [_P] * 7 + [_I] * 5 + [_P]
    lib.rglru_scan_bwd.restype = _I
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
    of the recurrence from a zero state; differentiable in a and b."""
    _check(a, b)
    return _RGLRUScan.apply(a, b)


rglru_scan.launches = 0
rglru_scan.bwd_launches = 0


class _RGLRUScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        out, h_last = rglru_ref(a, b) if a.device.type == "cpu" else \
            _launch(a, b)
        if a.dtype == torch.float32:     # out is the float32 states
            ctx.save_for_backward(a, out)
        else:
            ctx.save_for_backward(a, b)
        ctx.set_materialize_grads(False)
        return out, h_last

    @staticmethod
    def backward(ctx, dout, dh_last):
        a, x = ctx.saved_tensors
        h, b = (x, None) if a.dtype == torch.float32 else (None, x)
        if dout is None:
            dout = torch.zeros_like(a)
        return rglru_bwd(a, b, dout.to(a.dtype).contiguous(), dh_last, h)


def rglru_bwd(a, b, dout, dh_last=None, h=None) -> tuple:
    """The gradients ``(da, db)`` in a's type of :func:`rglru_scan`, given
    those of its outputs (``dh_last`` may be None) and its float32 states
    ``h`` (or None, when ``b`` is given: they are recomputed).  The kernel
    for CUDA tensors, counted in ``rglru_scan.bwd_launches``; the plain
    :func:`rglru_bwd_ref` for CPU tensors."""
    if a.device.type == "cpu":
        return rglru_bwd_ref(a, b, dout, dh_last, h)
    B, S, D = a.shape
    if dout.shape != a.shape or dout.dtype != a.dtype or \
            not dout.is_contiguous():
        raise ValueError(f"dout: want a contiguous {tuple(a.shape)} "
                         f"{a.dtype} tensor, got {tuple(dout.shape)} "
                         f"{dout.dtype}")
    if dh_last is not None:
        dh_last = dh_last.float().contiguous()
    recompute = h is None
    if recompute:
        h = torch.empty((B, S, D), dtype=torch.float32, device=a.device)
    da, db = torch.empty_like(a), torch.empty_like(a)
    lib = _library()
    err = lib.rglru_scan_bwd(
        _DTYPES[a.dtype], a.data_ptr(), 0 if b is None else b.data_ptr(),
        h.data_ptr(), dout.data_ptr(),
        0 if dh_last is None else dh_last.data_ptr(), da.data_ptr(),
        db.data_ptr(), B, S, D, int(recompute), a.device.index,
        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan backward launch failed: CUDA error "
                           f"{err} "
                           f"({lib.rglru_scan_error_string(err).decode()})")
    rglru_scan.bwd_launches += 1
    return da, db


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
