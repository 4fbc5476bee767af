"""The port's flash attention (plain version, CPU) against the JAX package's.

Inputs are drawn with numpy from a seed and handed to both.  The forward
is held against the Pallas kernel in interpret mode and ``attention_ref``
on the cases of ``tests/test_kernels.py``, with its tolerances; the GQA
layout against ``repro.models.attention.flash_attention``; dq, dk and dv
against ``jax.vjp`` of the reference's custom-VJP attention on the cases
of ``tests/test_attention_vjp.py`` (float32: rtol 1e-4, atol 1e-5, as
both sum the same tiles in float32, in other orders; bfloat16: both
compute in float32 and round the result to bfloat16, so they differ by
at most a few bfloat16 ulps: rtol and atol 2e-2, the reference's bf16
kernel tolerance).  The CUDA kernel itself is held against the same plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref
from repro.models.attention import flash_attention as ref_flash
from repro.models.attention import flash_attention_vjp

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_fwd)
from repro_torch.kernels.flash_attention.ref import kv_band
from repro_torch.models.attention import flash_attention as port_model_fa

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
F32_FWD_TOL = dict(rtol=2e-5, atol=2e-5)
F32_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _tol(dtype):
    return BF16_TOL if dtype == "bfloat16" else F32_FWD_TOL


def _draw(rng, shape, dtype="float32"):
    """The same values for both frameworks: numpy float32, rounded to
    bfloat16 by each framework alike when asked."""
    x = rng.standard_normal(shape).astype(np.float32)
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _np(t):
    return t.detach().float().numpy()


# --------------------------------------------------------------------- #
# forward: the cases of tests/test_kernels.py, (B, H, S, D) layout
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("B,H,S,D", [(1, 2, 128, 32), (2, 1, 256, 64),
                                     (1, 2, 128, 80)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (False, 0)])
def test_plain_forward_matches_pallas_and_ref(B, H, S, D, dtype, causal,
                                              window):
    rng = np.random.default_rng(0)
    (qj, qt), (kj, kt), (vj, vt) = [_draw(rng, (B, H, S, D), dtype)
                                    for _ in range(3)]
    pallas = flash_attention_pallas(qj, kj, vj, causal=causal,
                                    window=window, block_q=64, block_k=64,
                                    interpret=True)
    ref = attention_ref(qj, kj, vj, causal=causal, window=window)
    # (B, H, S, D) -> the port's (B, S, KV=H, G=1, D) / (B, S, H, D)
    out, lse = flash_attention_fwd(
        qt.transpose(1, 2)[:, :, :, None].contiguous(),
        kt.transpose(1, 2).contiguous(), vt.transpose(1, 2).contiguous(),
        causal=causal, window=window, q_chunk=64, kv_chunk=64)
    assert out.dtype == qt.dtype and lse.dtype == torch.float32
    assert lse.shape == (B, H, 1, S)
    got = _np(out[:, :, :, 0].transpose(1, 2))
    for want in (pallas, ref):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   **_tol(dtype))


def test_gqa_layout_matches_model_path():
    rng = np.random.default_rng(1)
    B, S, KV, G, D = 2, 128, 2, 3, 32
    qj, qt = _draw(rng, (B, S, KV, G, D))
    kj, kt = _draw(rng, (B, S, KV, D))
    vj, vt = _draw(rng, (B, S, KV, D))
    want = ref_flash(qj, kj, vj, causal=True, q_chunk=64, kv_chunk=64)
    got = port_model_fa(qt, kt, vt, causal=True, q_chunk=64, kv_chunk=64)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_FWD_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mqa_head_dim_256_with_window_matches_model_path(dtype):
    """recurrentgemma-2b's local layers: one kv head for G = 10 query
    heads of width 256, a sliding window shorter than the sequence."""
    rng = np.random.default_rng(2)
    B, S, KV, G, D = 1, 192, 1, 10, 256
    qj, qt = _draw(rng, (B, S, KV, G, D), dtype)
    kj, kt = _draw(rng, (B, S, KV, D), dtype)
    vj, vt = _draw(rng, (B, S, KV, D), dtype)
    want = ref_flash(qj, kj, vj, causal=True, window=48, q_chunk=64,
                     kv_chunk=64)
    got = port_model_fa(qt, kt, vt, causal=True, window=48, q_chunk=64,
                        kv_chunk=64)
    assert got.dtype == qt.dtype
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **_tol(dtype))


def test_kernel_states_its_head_width_limits():
    from repro_torch.kernels.flash_attention.ops import (MAX_BWD_HEAD_DIM,
                                                         MAX_HEAD_DIM,
                                                         SOURCE)
    text = SOURCE.read_text()
    assert (MAX_HEAD_DIM, MAX_BWD_HEAD_DIM) == (256, 128)
    assert f"kMaxFwdD = {MAX_HEAD_DIM};" in text
    assert f"kMaxBwdD = {MAX_BWD_HEAD_DIM};" in text


# --------------------------------------------------------------------- #
# backward: the cases of tests/test_attention_vjp.py
# --------------------------------------------------------------------- #
def _grads_both(shape_q, shape_k, dtype, causal, window, qc, kc, seed):
    rng = np.random.default_rng(seed)
    qj, qt = _draw(rng, shape_q, dtype)
    kj, kt = _draw(rng, shape_k, dtype)
    vj, vt = _draw(rng, shape_k, dtype)
    tj, tt = _draw(rng, shape_q, dtype)
    out_j, vjp = jax.vjp(
        lambda q, k, v: flash_attention_vjp(q, k, v, causal, window, qc, kc),
        qj, kj, vj)
    want = vjp(tj)
    leaves = [x.detach().clone().requires_grad_(True) for x in (qt, kt, vt)]
    out_t = port_model_fa(*leaves, causal=causal, window=window, q_chunk=qc,
                          kv_chunk=kc)
    out_t.backward(tt)
    return (out_j, want), (out_t, [x.grad for x in leaves])


@pytest.mark.parametrize("causal,window,qc,kc", [
    (True, 0, 32, 32), (True, 48, 32, 32), (False, 0, 64, 32),
    (True, 0, 128, 128),
])
def test_plain_grads_match_reference_vjp(causal, window, qc, kc):
    B, S, KV, G, D = 2, 128, 2, 2, 16
    (out_j, want), (out_t, got) = _grads_both(
        (B, S, KV, G, D), (B, S, KV, D), "float32", causal, window, qc, kc,
        seed=0)
    np.testing.assert_allclose(_np(out_t), np.asarray(out_j), **F32_FWD_TOL)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), np.asarray(w), **F32_GRAD_TOL,
                                   err_msg=f"d{name}")


def test_plain_grads_gqa_groups_match_reference_vjp():
    """G = 3 query heads share each kv head: dk and dv sum over them."""
    (_, want), (_, got) = _grads_both((1, 64, 2, 3, 8), (1, 64, 2, 8),
                                      "float32", True, 0, 32, 32, seed=1)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **F32_GRAD_TOL,
                                   err_msg=f"d{name}")


def test_plain_grads_bf16_match_reference_vjp():
    (out_j, want), (out_t, got) = _grads_both(
        (1, 64, 1, 2, 16), (1, 64, 1, 16), "bfloat16", True, 0, 32, 32,
        seed=2)
    assert out_t.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out_t), np.asarray(out_j, np.float32),
                               **BF16_TOL)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                                   **BF16_TOL, err_msg=f"d{name}")


# --------------------------------------------------------------------- #
# ragged sequences: the kernel takes any S, so the plain version does too
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("S", [1, 50, 100])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0), (False, 30)])
def test_ragged_tail_matches_one_chunk(S, causal, window):
    """Chunks of 32 over S not a multiple of 32 give what one chunk of S
    gives in the reference (forward and gradients)."""
    B, KV, G, D = 1, 2, 2, 16
    rng = np.random.default_rng(3)
    qj, qt = _draw(rng, (B, S, KV, G, D))
    kj, kt = _draw(rng, (B, S, KV, D))
    vj, vt = _draw(rng, (B, S, KV, D))
    tj, tt = _draw(rng, (B, S, KV, G, D))
    out_j, vjp = jax.vjp(
        lambda q, k, v: flash_attention_vjp(q, k, v, causal, window, S, S),
        qj, kj, vj)
    leaves = [x.clone().requires_grad_(True) for x in (qt, kt, vt)]
    out_t = flash_attention(*leaves, causal=causal, window=window,
                            q_chunk=32, kv_chunk=32)
    out_t.backward(tt)
    np.testing.assert_allclose(_np(out_t), np.asarray(out_j), **F32_FWD_TOL)
    for g, w in zip(leaves, vjp(tj)):
        np.testing.assert_allclose(_np(g.grad), np.asarray(w),
                                   **F32_GRAD_TOL)


def test_kv_band_matches_reference_where_chunks_divide():
    from repro.models.attention import _kv_band
    for S, qc, kc in ((128, 32, 32), (256, 64, 32), (4096, 1024, 1024)):
        for causal in (True, False):
            for window in (0, 1, 48, 100):
                for qi in range(S // qc):
                    assert kv_band(qi, qc, kc, S, causal, window) == \
                        _kv_band(qi, qc, kc, S, causal, window)


# --------------------------------------------------------------------- #
# the wrapper
# --------------------------------------------------------------------- #
def test_cpu_path_counts_no_launches():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((1, 16, 1, 2, 8)).astype(
        np.float32)).requires_grad_(True)
    k = torch.from_numpy(rng.standard_normal((1, 16, 1, 8)).astype(
        np.float32)).requires_grad_(True)
    v = k.detach().clone().requires_grad_(True)
    before = (flash_attention.fwd_launches, flash_attention.bwd_launches)
    flash_attention(q, k, v).sum().backward()
    assert (flash_attention.fwd_launches,
            flash_attention.bwd_launches) == before
    assert q.grad.shape == q.shape and k.grad.shape == k.shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_path_counts_no_launches_on_either_route(dtype):
    """A CPU tensor of either type runs the plain version, forward and
    backward, and launches nothing."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((1, 24, 1, 2, 16)).astype(
        np.float32)).to(dtype).requires_grad_(True)
    k = torch.from_numpy(rng.standard_normal((1, 24, 1, 16)).astype(
        np.float32)).to(dtype).requires_grad_(True)
    v = k.detach().clone().requires_grad_(True)
    before = (flash_attention.fwd_launches,
              flash_attention.fwd_windowed_launches,
              flash_attention.bwd_launches)
    out = flash_attention(q, k, v, window=8)
    out.float().sum().backward()
    assert (flash_attention.fwd_launches,
            flash_attention.fwd_windowed_launches,
            flash_attention.bwd_launches) == before
    assert out.dtype == q.grad.dtype == k.grad.dtype == dtype


@pytest.mark.parametrize("dtype,D,backward,route", [
    (torch.bfloat16, 8, False, "tensor cores, bf16"),
    (torch.bfloat16, 64, True, "tensor cores, bf16"),
    (torch.bfloat16, 128, True, "tensor cores, bf16"),
    (torch.bfloat16, 256, False, "tensor cores, bf16"),
    (torch.float32, 40, True, "CUDA cores, float32"),
    (torch.float32, 256, False, "CUDA cores, float32"),
])
def test_route_by_type_and_width(dtype, D, backward, route):
    """bf16 takes the tensor-core kernels, float32 the CUDA-core ones, at
    every head width each direction takes; the entry points a route names
    are the source's."""
    from repro_torch.kernels.flash_attention.ops import (ROUTES, SOURCE,
                                                         kernel_route)
    assert kernel_route(dtype, D, backward) == route
    name, fwd, bwd = ROUTES[dtype]
    assert name == route
    text = SOURCE.read_text()
    assert f"int {bwd if backward else fwd}(" in text
    assert ("_tc_kernel" in text) and ("wgmma.mma_async" in text)


def test_route_refuses_what_no_kernel_takes():
    from repro_torch.kernels.flash_attention.ops import kernel_route
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            kernel_route(dtype, 256, backward=True)
        for D in (0, 12, 264):
            with pytest.raises(ValueError, match="multiple of 8"):
                kernel_route(dtype, D)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernel_route(torch.float16, 64)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros((1, 8, 2, 1, 16))
    k = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="want q"):
        flash_attention_fwd(q, k[:, :, :1], k[:, :, :1])
    with pytest.raises(TypeError, match="share"):
        flash_attention_fwd(q, k.double(), k)
    k_strided = torch.zeros((1, 2, 8, 16)).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q, k_strided, k)
    out, lse = flash_attention_fwd(q, k, k)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, k, out, lse[..., :4], out)
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention_fwd(q.to("meta"), k.to("meta"), k.to("meta"))
