"""Wrapper of the coded decode-reduce kernel: ``out = Σ_s w_s · g_s``.

On a CUDA tensor it launches the hand-written kernel
(``csrc/coded_reduce.cu``, built with nvcc at first use) on the current
stream, or raises.  On a CPU tensor it computes the plain version
(:func:`~repro_torch.kernels.coded_reduce.ref.coded_reduce_ref`).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import load_library
from .ref import coded_reduce_ref

__all__ = ["MAX_SLOTS", "SOURCE", "coded_reduce", "coded_reduce_ref"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "coded_reduce.cu"

#: Most rows the kernel takes (its weights sit in shared memory).
MAX_SLOTS = 1024


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(str(SOURCE))
    for name in ("coded_reduce_f32", "coded_reduce_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.coded_reduce_error_string.argtypes = [ctypes.c_int]
    lib.coded_reduce_error_string.restype = ctypes.c_char_p
    return lib


def coded_reduce(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """g: (n_slots, D) float32 or bfloat16; w: (n_slots,) float32, both
    contiguous and on one device -> (D,) float32.

    ``coded_reduce.launches`` counts the kernel's launches (not the CPU
    path's calls).
    """
    if g.dim() != 2 or w.dim() != 1 or w.shape[0] != g.shape[0]:
        raise ValueError(f"want g (n_slots, D) and w (n_slots,), got "
                         f"{tuple(g.shape)} and {tuple(w.shape)}")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"g must be float32 or bfloat16, got {g.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32, got {w.dtype}")
    if g.device != w.device:
        raise ValueError(f"g on {g.device} but w on {w.device}")
    if not (g.is_contiguous() and w.is_contiguous()):
        raise ValueError("g and w must be contiguous")
    if g.device.type == "cpu":
        return coded_reduce_ref(g, w)
    if g.device.type != "cuda":
        raise ValueError(f"coded_reduce runs on cuda or cpu, not "
                         f"{g.device}")
    n_slots, D = g.shape
    if n_slots > MAX_SLOTS:
        raise ValueError(f"{n_slots} rows exceed the kernel's "
                         f"{MAX_SLOTS}")
    out = torch.empty((D,), dtype=torch.float32, device=g.device)
    if D == 0:
        return out
    lib = _library()
    fn = (lib.coded_reduce_f32 if g.dtype == torch.float32
          else lib.coded_reduce_bf16)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = fn(g.data_ptr(), w.data_ptr(), out.data_ptr(), n_slots, D,
                 stream)
    if err != 0:
        raise RuntimeError(f"coded_reduce launch failed: CUDA error {err} "
                           f"({lib.coded_reduce_error_string(err).decode()})")
    coded_reduce.launches += 1
    return out


coded_reduce.launches = 0
