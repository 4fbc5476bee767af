"""The written-out backwards beside the port's three backward kernels,
held against autograd of the port's plain forwards and against
``jax.vjp`` of the reference's functions, on inputs drawn with numpy.

* ``rglru_bwd_ref`` (the reverse linear scan): bit-equal to autograd of
  ``rglru_ref`` (the same products and sums in the same order); within
  rtol 1e-5, atol 1e-6 of ``jax.vjp`` of the reference's sequential
  ``rglru_ref`` (float32 sums in other orders over 24 steps), and
  of the reference's model scan, ``jax.lax.associative_scan`` with
  ``models/rglru.py``'s combine (rtol 1e-4, atol 1e-5: a log-depth tree
  rounds in another order).
* ``wkv_bwd_ref`` (the reverse sweep of dS): within rtol 1e-4, atol 1e-5
  of autograd of ``wkv_ref`` and of ``jax.vjp`` of the reference's
  ``wkv_sequential`` (float32 sums over K and V in other orders, carried
  over 40 steps).  The reference has no WKV backward of its own: its
  ``wkv_chunked`` is wrong past a cumulative log-decay of -30 in a chunk.
* ``flash_attention_bwd_ref`` at head width 256, GQA (G = 2), causal,
  with a window that bites and without: within rtol 1e-4, atol 1e-5 of
  autograd of ``flash_attention_fwd_ref`` and of ``jax.vjp`` of
  the reference's custom-VJP attention (the tolerance of
  ``tests/test_torch_flash_attention.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan.ref import rglru_ref as ref_rglru_seq
from repro.models.attention import flash_attention_vjp
from repro.models.rwkv6 import wkv_sequential as ref_wkv

from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_fwd_ref)
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.rglru_scan.ref import rglru_bwd_ref, rglru_ref
from repro_torch.kernels.rwkv6_wkv import wkv
from repro_torch.kernels.rwkv6_wkv.ref import wkv_bwd_ref, wkv_ref

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _grads(fn, inputs, cotangents):
    """torch autograd of ``fn`` at ``inputs`` (tensors), pulled back from
    ``cotangents`` (one per output)."""
    leaves = [x.clone().requires_grad_(True) for x in inputs]
    outs = fn(*leaves)
    torch.autograd.backward(outs, cotangents)
    return [x.grad for x in leaves]


def _close(got, want, tol, names):
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **tol,
                                   err_msg=f"d{name}")


# --------------------------------------------------------------------- #
# RG-LRU
# --------------------------------------------------------------------- #
def _scan_inputs(seed, shape=(2, 24, 16)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, shape).astype(np.float32)
    b, dout = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(2))
    dh = rng.standard_normal((shape[0], shape[2])).astype(np.float32)
    return a, b, dout, dh


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_bwd_ref_equals_autograd_of_the_plain_scan(dtype):
    a, b, dout, dh = (_t(x) for x in _scan_inputs(0))
    a, b, dout = a.to(dtype), b.to(dtype), dout.to(dtype)
    want = _grads(rglru_ref, (a, b), (dout, dh))
    got = rglru_bwd_ref(a, b, dout, dh)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)
    # the states handed over (a float32 forward's output) change nothing
    h = rglru_ref(a.float(), b.float())[0]
    for g, w in zip(rglru_bwd_ref(a, b, dout, dh, h=h), want):
        assert torch.equal(g, w)
    # and the wrapper's autograd on a CPU tensor is this backward
    for g, w in zip(_grads(rglru_scan, (a, b), (dout, dh)), want):
        assert torch.equal(g, w)


def test_rglru_bwd_ref_matches_reference_vjp():
    a, b, dout, dh = _scan_inputs(1)
    got = rglru_bwd_ref(*(_t(x) for x in (a, b, dout, dh)))
    _, vjp = jax.vjp(ref_rglru_seq, jnp.asarray(a), jnp.asarray(b))
    _close(got, vjp((jnp.asarray(dout), jnp.asarray(dh))),
           dict(rtol=1e-5, atol=1e-6), "ab")

    def model_scan(a, b):       # models/rglru.py's associative_scan
        _, h = jax.lax.associative_scan(
            lambda u, v: (u[0] * v[0], v[0] * u[1] + v[1]), (a, b), axis=1)
        return h, h[:, -1]
    _, vjp = jax.vjp(model_scan, jnp.asarray(a), jnp.asarray(b))
    _close(got, vjp((jnp.asarray(dout), jnp.asarray(dh))), GRAD_TOL, "ab")


# --------------------------------------------------------------------- #
# WKV
# --------------------------------------------------------------------- #
def _wkv_inputs(seed, B=2, H=3, S=40, K=8, V=16):
    rng = np.random.default_rng(seed)
    r, k = (rng.standard_normal((B, H, S, K)).astype(np.float32) * 0.5
            for _ in range(2))
    v = rng.standard_normal((B, H, S, V)).astype(np.float32) * 0.5
    w = np.exp(-np.exp(rng.uniform(-3.0, 1.0, (B, H, S, K)))).astype(
        np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32) * 0.5
    dout = rng.standard_normal((B, H, S, V)).astype(np.float32)
    ds = rng.standard_normal((B, H, K, V)).astype(np.float32)
    return (r, k, v, w, u), dout, ds


def test_wkv_bwd_ref_matches_autograd_and_reference_vjp():
    ins, dout, ds = _wkv_inputs(2)
    got = wkv_bwd_ref(*(_t(x) for x in ins), _t(dout), _t(ds))
    assert [g.dtype for g in got] == [torch.float32] * 5
    _close(got, _grads(wkv_ref, [_t(x) for x in ins], (_t(dout), _t(ds))),
           GRAD_TOL, "rkvwu")
    _, vjp = jax.vjp(ref_wkv, *(jnp.asarray(x) for x in ins))
    _close(got, vjp((jnp.asarray(dout), jnp.asarray(ds))), GRAD_TOL,
           "rkvwu")
    # without a gradient of S_last, and through the wrapper's autograd
    got = wkv_bwd_ref(*(_t(x) for x in ins), _t(dout))
    _close(got, _grads(lambda *x: wkv(*x)[0], [_t(x) for x in ins],
                       (_t(dout),)), dict(rtol=0, atol=0), "rkvwu")


def test_wkv_bwd_ref_in_bfloat16_keeps_the_input_types():
    ins, dout, ds = _wkv_inputs(3, S=24)
    r, k, v, w, u = (_t(x) for x in ins)
    r, k, v, u = (x.to(torch.bfloat16) for x in (r, k, v, u))
    dout = _t(dout).to(torch.bfloat16)
    got = wkv_bwd_ref(r, k, v, w, u, dout)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + \
        [torch.float32, torch.bfloat16]
    want = wkv_bwd_ref(*(x.float() for x in (r, k, v, w, u, dout)))
    for g, x in zip(got, want):
        assert torch.equal(g, x.to(g.dtype))


# --------------------------------------------------------------------- #
# attention at head width 256
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("causal,window", [(True, 40), (True, 0)])
def test_attention_bwd_ref_at_head_width_256(causal, window):
    rng = np.random.default_rng(4)
    B, S, KV, G, D = 1, 96, 2, 2, 256
    q = rng.standard_normal((B, S, KV, G, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KV, D)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((B, S, KV, G, D)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_chunk=32, kv_chunk=32)
    qt, kt, vt = _t(q), _t(k), _t(v)
    out, lse = flash_attention_fwd_ref(qt, kt, vt, **kw)
    got = flash_attention_bwd_ref(qt, kt, vt, out, lse, _t(do), **kw)
    want = _grads(lambda *x: flash_attention_fwd_ref(*x, **kw)[0],
                  (qt, kt, vt), (_t(do),))
    _close(got, want, GRAD_TOL, "qkv")
    _, vjp = jax.vjp(lambda q, k, v: flash_attention_vjp(
        q, k, v, causal, window, 32, 32), *(jnp.asarray(x)
                                           for x in (q, k, v)))
    _close(got, vjp(jnp.asarray(do)), GRAD_TOL, "qkv")
