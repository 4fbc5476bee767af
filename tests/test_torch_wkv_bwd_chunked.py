"""The WKV backward kernel's chunked algorithm, written out in plain torch
(``kernels/rwkv6_wkv/ref.py::wkv_bwd_chunked_exact``), against the
port's written-out sequential backward ``wkv_bwd_ref`` and against
``jax.vjp`` of the reference's sequential ``wkv_sequential``, on the CPU.

The kernel itself runs only on the card, where it is held to
``wkv_bwd_ref`` (``tests/test_torch_cuda.py``, ``chip_smoke.py``); this
file proves the equations it computes: interval products of w (no ratio,
no exp or log), the dS carried back chunk by chunk, dw as the four
products of the two parts of S_{t-1} and dS_t, and the split of V into
tiles with the tiles' partials summed in order.  Float32 throughout, held
at rtol 2e-4 and atol 2e-4·max(1, max|grad|): sums over K, V and the
chunk's steps in other orders than the sequential sweep's, carried back
over up to 1,000 steps.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.rwkv6 import wkv_sequential as ref_wkv

from repro_torch.kernels.rwkv6_wkv.ref import (wkv_bwd_chunked_exact,
                                               wkv_bwd_ref)

# (B, H, S, K, V), w, whether dS_last is given
CASES = {
    "ragged, K != V, dS_last": ((2, 2, 77, 16, 32), "uniform", True),
    "ragged, K != V, no dS_last": ((1, 2, 50, 64, 32), "uniform", False),
    "zeros and 1e-30 in w": ((1, 2, 100, 16, 32), "zeros", True),
    "the model's decays": ((1, 2, 64, 32, 32), "path", True),
    "w -> 1 over 1,000 steps": ((1, 1, 1000, 16, 32),
                                math.exp(-math.exp(-8.0)), True),
    "w = 1 over 1,000 steps": ((1, 1, 1000, 16, 32), 1.0, False),
}


def _inputs(name):
    """r, k, v, u, dout and dS_last normal, w as the kernel's card tests
    draw it ("path": exp(-exp(U(-8, 2))); "zeros": U(0.3, 0.99) with a
    tenth of the entries 0 and a tenth 1e-30), all float32 numpy."""
    (B, H, S, K, V), w, with_ds = CASES[name]
    rng = np.random.default_rng(21)
    r, k = (rng.standard_normal((B, H, S, K)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, H, S, V)).astype(np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32)
    if w == "uniform":
        wv = rng.uniform(0.3, 0.99, (B, H, S, K))
    elif w == "path":
        wv = np.exp(-np.exp(rng.uniform(-8.0, 2.0, (B, H, S, K))))
    elif w == "zeros":
        wv = rng.uniform(0.3, 0.99, (B, H, S, K))
        pick = rng.uniform(size=wv.shape)
        wv[pick < 0.1] = 0.0
        wv[(pick >= 0.1) & (pick < 0.2)] = 1e-30
    else:
        wv = np.full((B, H, S, K), w)
    dout = rng.standard_normal((B, H, S, V)).astype(np.float32)
    ds = rng.standard_normal((B, H, K, V)).astype(np.float32) \
        if with_ds else None
    return (r, k, v, wv.astype(np.float32), u), dout, ds


_WANT = {}


def _want(name):
    """``wkv_bwd_ref``'s gradients and the reference's ``jax.vjp``, once
    per case."""
    if name not in _WANT:
        ins, dout, ds = _inputs(name)
        port = wkv_bwd_ref(*map(torch.from_numpy, ins),
                           torch.from_numpy(dout),
                           None if ds is None else torch.from_numpy(ds))
        _, vjp = jax.vjp(ref_wkv, *map(jnp.asarray, ins))
        ct = np.zeros(ins[0].shape[:2] + (ins[0].shape[3], ins[2].shape[3]),
                      np.float32) if ds is None else ds
        ref = vjp((jnp.asarray(dout), jnp.asarray(ct)))
        _WANT[name] = ([g.numpy() for g in port],
                       [np.asarray(g, np.float32) for g in ref])
    return _WANT[name]


@pytest.mark.parametrize("v_tile", [16, 32])
@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("name", list(CASES))
def test_chunked_backward_matches_sequential(name, chunk, v_tile):
    ins, dout, ds = _inputs(name)
    got = wkv_bwd_chunked_exact(
        *map(torch.from_numpy, ins), torch.from_numpy(dout),
        None if ds is None else torch.from_numpy(ds), chunk=chunk,
        v_tile=v_tile)
    port, ref = _want(name)
    for grad, g, p, x in zip("rkvwu", got, port, ref):
        assert g.dtype == torch.float32 and g.shape == p.shape
        assert np.isfinite(g.numpy()).all()
        scale = max(1.0, float(np.abs(p).max()))
        for want in (p, x):
            np.testing.assert_allclose(g.numpy(), want, rtol=2e-4,
                                       atol=2e-4 * scale,
                                       err_msg=f"d{grad}")


def test_v_tile_must_divide_v():
    ins, dout, ds = _inputs("ragged, K != V, dS_last")
    with pytest.raises(ValueError, match="v_tile"):
        wkv_bwd_chunked_exact(*map(torch.from_numpy, ins),
                              torch.from_numpy(dout), v_tile=24)
