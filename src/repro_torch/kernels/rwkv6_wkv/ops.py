"""Wrapper of the RWKV6 WKV kernels: the exact recurrence in chunks, and
its backward, as a ``torch.autograd.Function``.

``wkv(r, k, v, w, u)`` launches the hand-written kernels of
``csrc/rwkv6_wkv.cu`` (built with nvcc at first use) on the current stream
for CUDA tensors, or raises; for CPU tensors it computes the plain versions
(:func:`~repro_torch.kernels.rwkv6_wkv.ref.wkv_ref` forward,
:func:`~repro_torch.kernels.rwkv6_wkv.ref.wkv_bwd_ref` backward).
``wkv.launches`` and ``wkv.bwd_launches`` count the kernels' launches,
not the CPU path's calls.  The forward saves its inputs; the backward
kernel recomputes the states from them.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import load_library
from .ref import wkv_bwd_ref, wkv_ref

__all__ = ["BWD_CHUNK", "HEAD_DIMS", "SOURCE", "smem_bytes", "wkv",
           "wkv_bwd", "wkv_bwd_ref", "wkv_ref"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "rwkv6_wkv.cu"

#: The head widths (K and V) the kernels are built for.
HEAD_DIMS = (16, 32, 64)
#: Steps between the backward kernel's state checkpoints (``kBwdL``).
BWD_CHUNK = 16

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(str(SOURCE))
    lib.wkv_fwd.argtypes = [_I] + [_P] * 7 + [_I] * 5 + [_P]
    lib.wkv_fwd.restype = _I
    lib.wkv_bwd.argtypes = [_I] + [_P] * 14 + [_I] * 6 + [_P]
    lib.wkv_bwd.restype = _I
    lib.wkv_smem_bytes.argtypes = [_I] * 4
    lib.wkv_smem_bytes.restype = _I
    lib.wkv_error_string.argtypes = [_I]
    lib.wkv_error_string.restype = ctypes.c_char_p
    return lib


def _check(r, k, v, w, u) -> None:
    if r.dim() != 4 or k.shape != r.shape or w.shape != r.shape or \
            v.dim() != 4 or v.shape[:3] != r.shape[:3] or \
            tuple(u.shape) != (r.shape[1], r.shape[3]):
        raise ValueError(f"want r, k, w (B,H,S,K), v (B,H,S,V) and u (H,K), "
                         f"got r {tuple(r.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, w {tuple(w.shape)}, u "
                         f"{tuple(u.shape)}")
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype for t in (k, v, u)):
        raise TypeError(f"r, k, v, u must share float32 or bfloat16, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}, {u.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32, got {w.dtype}")
    if any(t.device != r.device for t in (k, v, w, u)):
        raise ValueError("r, k, v, w, u must lie on one device")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"wkv runs on cuda or cpu, not {r.device}")
    if not all(t.is_contiguous() for t in (r, k, v, w, u)):
        raise ValueError("r, k, v, w and u must be contiguous")
    if r.shape[2] == 0:
        raise ValueError("empty sequence")
    K, V = r.shape[3], v.shape[3]
    if r.device.type == "cuda" and (K not in HEAD_DIMS or V not in HEAD_DIMS):
        raise ValueError(f"the kernel takes K and V in {HEAD_DIMS}, not "
                         f"K={K}, V={V}")


def wkv(r, k, v, w, u, *, chunk: int = 32):
    """r, k, w: (B, H, S, K); v: (B, H, S, V); u: (H, K); r, k, v, u one
    type (float32 or bfloat16), w float32, all contiguous, on one device.
    Returns ``(out (B, H, S, V) in r's type, S_last (B, H, K, V) float32)``
    of the recurrence from a zero state.  ``chunk`` is the TPU kernel's
    tiling, kept for its signature: the kernel's own chunk is 16 steps
    whatever it says.  Differentiable in r, k, v, w and u."""
    _check(r, k, v, w, u)
    return _WKV.apply(r, k, v, w, u)


wkv.launches = 0
wkv.bwd_launches = 0


class _WKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u):
        out, s_last = wkv_ref(r, k, v, w, u) if r.device.type == "cpu" \
            else _launch(r, k, v, w, u)
        ctx.save_for_backward(r, k, v, w, u)
        ctx.set_materialize_grads(False)
        return out, s_last

    @staticmethod
    def backward(ctx, dout, ds_last):
        r, k, v, w, u = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros((*r.shape[:3], v.shape[3]), dtype=r.dtype,
                               device=r.device)
        return wkv_bwd(r, k, v, w, u, dout.to(r.dtype).contiguous(),
                       ds_last)


def wkv_bwd(r, k, v, w, u, dout, ds_last=None) -> tuple:
    """The gradients ``(dr, dk, dv, dw, du)`` of :func:`wkv` from its
    inputs and those of its outputs (``ds_last`` may be None): dw float32,
    the others in r's type.  The kernel for CUDA tensors, counted in
    ``wkv.bwd_launches``; the plain :func:`wkv_bwd_ref` for CPU tensors.
    An input whose storage is not 16-byte aligned is copied first, as for
    the forward."""
    if r.device.type == "cpu":
        return wkv_bwd_ref(r, k, v, w, u, dout, ds_last)
    B, H, S, K = r.shape
    V = v.shape[3]
    if tuple(dout.shape) != (B, H, S, V) or dout.dtype != r.dtype or \
            not dout.is_contiguous():
        raise ValueError(f"dout: want a contiguous {(B, H, S, V)} {r.dtype} "
                         f"tensor, got {tuple(dout.shape)} {dout.dtype}")
    if ds_last is not None:
        ds_last = ds_last.float().contiguous()
    r, k, v, w, dout = (t if t.data_ptr() % 16 == 0 else t.clone()
                        for t in (r, k, v, w, dout))
    f32 = dict(dtype=torch.float32, device=r.device)
    dr, dk = torch.empty_like(r), torch.empty_like(k)
    dv, du = torch.empty_like(v), torch.empty_like(u)
    dw = torch.empty_like(w)
    du_part = torch.empty((B, H, K), **f32)
    n_chunks = -(-S // BWD_CHUNK)
    ckpt = torch.empty((B, H, n_chunks, K, V), **f32)
    lib = _library()
    err = lib.wkv_bwd(
        _DTYPES[r.dtype], *(t.data_ptr() for t in (r, k, v, w, u, dout)),
        0 if ds_last is None else ds_last.data_ptr(),
        *(t.data_ptr() for t in (dr, dk, dv, dw, du, du_part, ckpt)),
        B, H, S, K, V, r.device.index,
        torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv backward launch failed: CUDA error {err} "
                           f"({lib.wkv_error_string(err).decode()})")
    wkv.bwd_launches += 1
    return dr, dk, dv, dw, du


def _launch(r, k, v, w, u):
    """One launch of the kernel on checked CUDA inputs, counted in
    ``wkv.launches``.  An input whose storage is not 16-byte aligned is
    copied first: the kernel's asynchronous copies move 16 bytes at a
    time."""
    r, k, v, w = (t if t.data_ptr() % 16 == 0 else t.clone()
                  for t in (r, k, v, w))
    B, H, S, K = r.shape
    V = v.shape[3]
    out = torch.empty((B, H, S, V), dtype=r.dtype, device=r.device)
    s_last = torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
    lib = _library()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.wkv_fwd(_DTYPES[r.dtype], r.data_ptr(), k.data_ptr(),
                          v.data_ptr(), w.data_ptr(), u.data_ptr(),
                          out.data_ptr(), s_last.data_ptr(), B, H, S, K, V,
                          stream)
    if err != 0:
        raise RuntimeError(f"wkv launch failed: CUDA error {err} "
                           f"({lib.wkv_error_string(err).decode()})")
    wkv.launches += 1
    return out, s_last


def smem_bytes(dtype: torch.dtype, K: int, V: int,
               backward: bool = False) -> int:
    """Dynamic shared memory a block of the forward (or backward) kernel
    takes (builds it)."""
    return _library().wkv_smem_bytes(_DTYPES[dtype], K, V, int(backward))
