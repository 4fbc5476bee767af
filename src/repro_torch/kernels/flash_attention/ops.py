"""Wrapper of the flash-attention kernel: forward, backward, autograd.

``flash_attention(q, k, v)`` is a ``torch.autograd.Function`` whose forward
and backward are the hand-written kernels of ``csrc/flash_attention.cu``
(built with nvcc at first use) on a CUDA tensor, launched on the current
stream, or an error; on a CPU tensor they are the plain versions of
:mod:`.ref`.  The input type picks the kernels (:func:`kernel_route`):
bfloat16 runs on the tensor cores (``wgmma`` fed by TMA), float32 on the
CUDA cores in full float32.  ``flash_attention.fwd_launches`` and
``.bwd_launches`` count the kernels' launches (one forward kernel per
forward call; the dq and dk/dv kernels of one backward call count once),
not the CPU path's calls; ``.fwd_windowed_launches`` counts those forward
launches that had a sliding window.  The forward takes a head width up to 256, the
backward up to 128 (``csrc/flash_attention.cu`` says why); a wider backward
on the card raises before any launch.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import load_library
from .ref import flash_attention_bwd_ref, flash_attention_fwd_ref

__all__ = ["MAX_BWD_HEAD_DIM", "MAX_HEAD_DIM", "ROUTES", "SOURCE",
           "flash_attention", "flash_attention_bwd", "flash_attention_fwd",
           "kernel_route"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

#: Widest head the forward kernel takes (its rows sit in shared memory).
MAX_HEAD_DIM = 256
#: Widest head the backward kernels take.
MAX_BWD_HEAD_DIM = 128

#: The kernels each input type runs: the name of the route, then the C
#: entry points of the forward and the backward.
ROUTES = {torch.bfloat16: ("tensor cores, bf16", "fa_fwd_bf16", "fa_bwd_bf16"),
          torch.float32: ("CUDA cores, float32", "fa_fwd_f32", "fa_bwd_f32")}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def kernel_route(dtype: torch.dtype, head_dim: int,
                 backward: bool = False) -> str:
    """The route that a CUDA tensor of ``dtype`` and head width
    ``head_dim`` takes: ``"tensor cores, bf16"`` or ``"CUDA cores,
    float32"``; raise where no kernel takes it."""
    if dtype not in ROUTES:
        raise TypeError(f"q, k, v must share float32 or bfloat16, not "
                        f"{dtype}")
    if head_dim % 8 or not 8 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes a head width that is a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}, not "
                         f"{head_dim}")
    if backward and head_dim > MAX_BWD_HEAD_DIM:
        raise NotImplementedError(
            f"the flash-attention backward kernels take a head width up to "
            f"{MAX_BWD_HEAD_DIM}, not {head_dim} (csrc/flash_attention.cu "
            f"says why); a wider backward is open work (ROADMAP.md)")
    return ROUTES[dtype][0]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(str(SOURCE))
    tail = [_I] * 5 + [_F, _I, _I, _I, _P]      # shape, scale, ..., stream
    for _, fwd, bwd in ROUTES.values():
        getattr(lib, fwd).argtypes = [_P] * 5 + tail
        getattr(lib, bwd).argtypes = [_P] * 10 + tail
        getattr(lib, fwd).restype = getattr(lib, bwd).restype = _I
    lib.fa_error_string.argtypes = [_I]
    lib.fa_error_string.restype = ctypes.c_char_p
    return lib


def _entry(q: torch.Tensor, backward: bool):
    """The C function that runs ``q``'s route."""
    kernel_route(q.dtype, q.shape[4], backward)
    return getattr(_library(), ROUTES[q.dtype][2 if backward else 1])


def _check(q, k, v) -> None:
    if q.dim() != 5 or k.dim() != 4 or v.shape != k.shape or \
            q.shape[:3] != k.shape[:3] or q.shape[4] != k.shape[3]:
        raise ValueError(f"want q (B,S,KV,G,D) and k, v (B,S,KV,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if q.device.type == "cuda":
        kernel_route(q.dtype, q.shape[4])
    if q.shape[1] == 0:
        raise ValueError("empty sequence")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"flash_attention {what} launch failed: CUDA "
                           f"error {err} "
                           f"({_library().fa_error_string(err).decode()})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        q_chunk: int = 1024, kv_chunk: int = 1024):
    """``(out (B,S,KV,G,D) in q's type, lse (B,KV,G,S) float32)``.  The
    chunk sizes shape only the plain version's tiles; the kernel's are
    64 x 64."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal=causal, window=window,
                                       q_chunk=q_chunk, kv_chunk=kv_chunk)
    B, S, KV, G, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, KV, G, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _entry(q, backward=False)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, S, KV, G, D, D ** -0.5, int(causal),
            int(window), q.device.index, _stream(q))
    _raise_on(err, "forward")
    flash_attention.fwd_launches += 1
    if window > 0:
        flash_attention.fwd_windowed_launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = True,
                        window: int = 0, q_chunk: int = 1024,
                        kv_chunk: int = 1024):
    """``(dq, dk, dv)`` in the inputs' types, from the forward's ``out``
    and ``lse`` and the output's gradient ``do``."""
    _check(q, k, v)
    B, S, KV, G, D = q.shape
    for name, t, dtype in (("out", out, q.dtype), ("do", do, q.dtype),
                           ("lse", lse, torch.float32)):
        want = (B, KV, G, S) if name == "lse" else tuple(q.shape)
        if tuple(t.shape) != want or t.dtype != dtype or \
                t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous {want} {dtype} "
                             f"tensor on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                       window=window, q_chunk=q_chunk,
                                       kv_chunk=kv_chunk)
    entry = _entry(q, backward=True)      # raises before any launch
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    dvec = torch.empty_like(lse)
    with torch.cuda.device(q.device):
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, S, KV, G, D, D ** -0.5,
            int(causal), int(window), q.device.index, _stream(q))
    _raise_on(err, "backward")
    flash_attention.bwd_launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Saves ``(q, k, v, out, lse)``, as the reference's ``_fa_fwd``; the
    backward recomputes the tiles from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_chunk, kv_chunk):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       q_chunk=q_chunk, kv_chunk=kv_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(causal=causal, window=window, q_chunk=q_chunk,
                        kv_chunk=kv_chunk)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, do.to(q.dtype).contiguous(), **ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_chunk: int = 1024, kv_chunk: int = 1024):
    """Exact attention, differentiable: q (B,S,KV,G,D), k and v (B,S,KV,D)
    of one type (float32 or bfloat16), contiguous -> (B,S,KV,G,D) in q's
    type.  ``scale = D**-0.5``; ``window > 0`` adds a sliding window."""
    return _FlashAttention.apply(q, k, v, causal, window, q_chunk, kv_chunk)


flash_attention.fwd_launches = 0
flash_attention.fwd_windowed_launches = 0
flash_attention.bwd_launches = 0
