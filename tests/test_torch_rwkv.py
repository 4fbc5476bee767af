"""The port's RWKV6 path against the JAX package's, on the CPU.

The WKV recurrence: the port's plain version (what ``wkv`` computes for a
CPU tensor, and what the kernel is held to on the card) against the
reference's oracle ``wkv_ref`` (``wkv_sequential``) and its Pallas kernel
in interpret mode, on ``tests/test_kernels.py``'s cases, at 2e-4.

The model: rwkv6-1.6b REDUCED through the ``params_from_numpy`` bridge,
float32 compute: ``forward``, ``loss_fn``, ``prefill`` (last logits and
every cache leaf: the WKV state ``S``, the token-shift states ``tm`` and
``cm``) and 8 ``decode_step``s after ``pad_cache``, at rtol/atol 1e-4.
The reference initialises the token-shift mixes, the bonus ``u``, the
head norm ``gn`` and the decay's ``w0`` and LoRA output to zero, which
would hide an off-by-one token shift; the "perturbed" weights draw them
from numpy.

The reference's chunked WKV (``wkv_chunked`` and the Pallas kernel) is
wrong once the cumulative log-decay inside one chunk passes -30 (its
factored exponent is clamped at 30).  REDUCED's chunk of 16 at the initial
decay w = e^-1 stays above -16, so there the reference is exact and is
used as it is.  Where a chunk of 64 or stronger decays pass -30, the port
is held against the reference with ``repro.models.rwkv6.wkv_chunked``
replaced by ``wkv_sequential`` for the test (the JAX package itself is
not edited).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.base as ref_configs
ref_configs.list_archs()    # the whole registry first: it loads only if empty
import repro.configs.rwkv6_1_6b as ref_rwkv_cfg                   # noqa: E402
import repro.models.rwkv6 as ref_rwkv                             # noqa: E402
import repro.models.transformer as ref_tf                         # noqa: E402
from repro.kernels.rwkv6_wkv.ops import wkv_op                    # noqa: E402
from repro.kernels.rwkv6_wkv.ref import wkv_ref as ref_wkv_ref    # noqa: E402

import repro_torch.configs.rwkv6_1_6b as port_rwkv_cfg            # noqa: E402
import repro_torch.models.rwkv6 as port_rwkv                      # noqa: E402
import repro_torch.models.transformer as port_tf                  # noqa: E402
from torch_train_parity import FLAGS, run_against_reference        # noqa: E402
from repro_torch.kernels.rwkv6_wkv import wkv, wkv_ref            # noqa: E402
from repro_torch.kernels.rwkv6_wkv.ref import wkv_chunked_exact   # noqa: E402
from repro_torch.models.common import spec_leaves                 # noqa: E402
from repro_torch.optim.optimizers import tree_leaves              # noqa: E402

WKV_TOL = dict(rtol=2e-4, atol=2e-4)        # tests/test_kernels.py's bound
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)      # float32 compute, both sides


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _wkv_inputs(seed, B, H, S, K, V, w=None):
    """tests/test_kernels.py's draws: r, k, v, u normal, w ~ U(0.3, 0.99)
    unless given."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((B, H, S, K)).astype(np.float32)
    k = rng.standard_normal((B, H, S, K)).astype(np.float32)
    v = rng.standard_normal((B, H, S, V)).astype(np.float32)
    w = (rng.uniform(0.3, 0.99, (B, H, S, K)) if w is None
         else np.full((B, H, S, K), w)).astype(np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32)
    return r, k, v, w, u


# --------------------------------------------------------------------- #
# the WKV recurrence
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("B,H,S,K,V", [(1, 2, 64, 16, 16), (2, 1, 128, 32, 32),
                                       (1, 1, 96, 64, 64)])
@pytest.mark.parametrize("chunk", [16, 32])
def test_plain_wkv_matches_oracle_and_pallas(B, H, S, K, V, chunk):
    r, k, v, w, u = _wkv_inputs(5, B, H, S, K, V)
    out, s_last = wkv(*map(_t, (r, k, v, w, u)), chunk=chunk)
    assert out.dtype == torch.float32 and s_last.shape == (B, H, K, V)
    jr = [jnp.asarray(x) for x in (r, k, v, w, u)]
    for ref_out, ref_s in (ref_wkv_ref(*jr),
                           wkv_op(*jr, chunk=chunk, interpret=True)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                                   **WKV_TOL)
        np.testing.assert_allclose(s_last.numpy(), np.asarray(ref_s),
                                   **WKV_TOL)


def test_plain_wkv_bf16_inputs():
    """tests/test_kernels.py's bf16 case.  The port's w is float32 (the
    path's type); it is given the same bf16-rounded values.  Against the
    oracle, which sees the same rounded inputs, only float32 summation
    order differs, so the bf16 outputs agree to one rounding step (1e-2);
    against the Pallas kernel, at the reference's own bound (5e-2)."""
    rng = np.random.default_rng(6)
    B, H, S, K = 1, 2, 64, 16
    r, k = [jnp.asarray(rng.standard_normal((B, H, S, K)), jnp.bfloat16)
            for _ in range(2)]
    v = jnp.asarray(rng.standard_normal((B, H, S, K)), jnp.bfloat16)
    w = jnp.asarray(rng.uniform(0.5, 0.99, (B, H, S, K)), jnp.bfloat16)
    u = jnp.asarray(rng.standard_normal((H, K)), jnp.bfloat16)
    bf = [_t(np.asarray(x, np.float32), torch.bfloat16) for x in (r, k, v)]
    out, s_last = wkv(*bf, _t(np.asarray(w, np.float32)),
                      _t(np.asarray(u, np.float32), torch.bfloat16),
                      chunk=16)
    assert out.dtype == torch.bfloat16
    ref_out, ref_s = ref_wkv_ref(r, k, v, w, u)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref_out, np.float32),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(s_last.numpy(), np.asarray(ref_s), **WKV_TOL)
    pallas, _ = wkv_op(r, k, v, w, u, chunk=16, interpret=True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(pallas, np.float32),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("w", [math.exp(-1.0), math.exp(-math.e ** 2)])
def test_plain_wkv_is_exact_where_the_chunked_forms_are_not(w):
    """w = e^-1 (rwkv6-1.6b's initial decay: w0 and the LoRA output start
    at zero) and w = exp(-e²) (the floor of ``_rwkv_decay``'s clip), at
    chunk 64 and S = 128, (B, H, K, V) = (1, 2, 64, 64).  The port's plain
    WKV matches ``wkv_sequential`` at 2e-4.  The reference's
    ``wkv_chunked`` and its Pallas kernel do not: their output is off by up
    to 56.8 at e^-1 and 87.8 at exp(-e²) where |out| is at most ~85,
    because their intra-chunk exponent is clamped at 30; their final state
    is right (no clamp there)."""
    r, k, v, wv, u = _wkv_inputs(0, 1, 2, 128, 64, 64, w=w)
    out, s_last = wkv(*map(_t, (r, k, v, wv, u)), chunk=64)
    jr = [jnp.asarray(x) for x in (r, k, v, wv, u)]
    ref_out, ref_s = ref_rwkv.wkv_sequential(*jr)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **WKV_TOL)
    np.testing.assert_allclose(s_last.numpy(), np.asarray(ref_s), **WKV_TOL)
    for name, (o, s) in (
            ("wkv_chunked", ref_rwkv.wkv_chunked(*jr, chunk=64)),
            ("wkv_pallas", wkv_op(*jr, chunk=64, interpret=True))):
        off = float(np.abs(np.asarray(o) - np.asarray(ref_out)).max())
        assert off > 10.0, (name, off)              # the recorded fault
        np.testing.assert_allclose(np.asarray(s), np.asarray(ref_s),
                                   rtol=1e-4, atol=1e-4)


def test_plain_wkv_matches_chunked_reference_at_mild_decay():
    """At w = 0.9 the log-decay of a 64-step chunk stays above -7, and the
    reference's chunked form is right: all three agree."""
    r, k, v, w, u = _wkv_inputs(1, 1, 2, 128, 64, 64, w=0.9)
    out, _ = wkv(*map(_t, (r, k, v, w, u)))
    jr = [jnp.asarray(x) for x in (r, k, v, w, u)]
    for ref_out, _ in (ref_rwkv.wkv_sequential(*jr),
                       ref_rwkv.wkv_chunked(*jr, chunk=64)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                                   **WKV_TOL)


def test_wkv_result_does_not_depend_on_chunk():
    ins = list(map(_t, _wkv_inputs(2, 2, 2, 50, 16, 32)))
    a = wkv(*ins, chunk=8)
    b = wkv(*ins, chunk=64)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert wkv_ref is port_rwkv.wkv_sequential


# the cases of the kernel's chunked algorithm: (B, H, S, K, V) and w
CHUNKED_CASES = {
    "ref (1, 2, 64, 16, 16)": ((1, 2, 64, 16, 16), "uniform"),
    "ref (2, 1, 128, 32, 32)": ((2, 1, 128, 32, 32), "uniform"),
    "ref (1, 1, 96, 64, 64)": ((1, 1, 96, 64, 64), "uniform"),
    "w = e^-1": ((1, 2, 128, 64, 64), math.exp(-1.0)),
    "w = exp(-e^2)": ((1, 2, 128, 64, 64), math.exp(-math.e ** 2)),
    "w -> 1 at S = 1024": ((1, 1, 1024, 64, 64), math.exp(-math.exp(-8.0))),
    "w = 1": ((1, 2, 200, 32, 32), 1.0),
    "zeros and 1e-30 in w": ((1, 2, 200, 64, 64), "zeros"),
    "path draw": ((1, 2, 256, 64, 64), "path"),
    "ragged, K != V": ((2, 3, 77, 16, 64), "uniform"),
    "ragged S = 1023, K != V": ((1, 1, 1023, 16, 64), "path"),
}


def _chunked_inputs(name):
    """The case's inputs: r, k, v, u normal and w drawn as the kernel's
    card tests draw it ("path": exp(-exp(U(-8, 2))), the range the model's
    decay takes; "zeros": U(0.3, 0.99) with a tenth of the entries 0 and a
    tenth 1e-30)."""
    (B, H, S, K, V), w = CHUNKED_CASES[name]
    rng = np.random.default_rng(11)
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
    return r, k, v, wv.astype(np.float32), u


_SEQUENTIAL = {}


def _sequential(name):
    """The port's and the reference's sequential recurrence on the case,
    computed once per case."""
    if name not in _SEQUENTIAL:
        ins = _chunked_inputs(name)
        port = port_rwkv.wkv_sequential(*map(_t, ins))
        ref = ref_rwkv.wkv_sequential(*map(jnp.asarray, ins))
        _SEQUENTIAL[name] = (port, tuple(np.asarray(x) for x in ref))
    return _SEQUENTIAL[name]


@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("name", list(CHUNKED_CASES))
def test_chunked_exact_model_matches_sequential(name, chunk):
    """The kernel's algorithm in plain torch (interval products of w, the
    carried state) against the port's ``wkv_sequential`` and the
    reference's, at float32 rtol 2e-4 and atol 2e-4·max(1, max|out|): also
    where the reference's chunked form is off (w = e^-1, exp(-e²)), where
    a log-domain form would take log 0, at w -> 1 and w = 1 over long
    sequences, on ragged S with K != V, and at chunk 16, 32 and 64, whose
    results then agree with each other within the same bound."""
    (port_out, port_s), (ref_out, ref_s) = _sequential(name)
    out, s_last = wkv_chunked_exact(*map(_t, _chunked_inputs(name)),
                                    chunk=chunk)
    assert out.shape == port_out.shape and s_last.shape == port_s.shape
    scale = max(1.0, float(port_out.abs().max()))
    s_scale = max(1.0, float(port_s.abs().max()))
    for want_out, want_s in ((port_out.numpy(), port_s.numpy()),
                             (ref_out, ref_s)):
        np.testing.assert_allclose(out.numpy(), want_out, rtol=2e-4,
                                   atol=2e-4 * scale)
        np.testing.assert_allclose(s_last.numpy(), want_s, rtol=2e-4,
                                   atol=2e-4 * s_scale)
    assert torch.isfinite(out).all() and torch.isfinite(s_last).all()
    if chunk != 16:
        out16, s16 = wkv_chunked_exact(*map(_t, _chunked_inputs(name)),
                                       chunk=16)
        np.testing.assert_allclose(out.numpy(), out16.numpy(), rtol=2e-4,
                                   atol=2e-4 * scale)
        np.testing.assert_allclose(s_last.numpy(), s16.numpy(), rtol=2e-4,
                                   atol=2e-4 * s_scale)


@pytest.mark.parametrize("seed", range(3))
def test_wkv_step_and_sequential_with_state_match_reference(seed):
    rng = np.random.default_rng(seed)
    B, H, K, V = 2, 3, 16, 8
    r, k, w = (rng.standard_normal((B, H, K)).astype(np.float32)
               for _ in range(3))
    w = 1.0 / (1.0 + np.exp(-w))
    v = rng.standard_normal((B, H, V)).astype(np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32)
    S = rng.standard_normal((B, H, K, V)).astype(np.float32)
    out, S_new = port_rwkv.wkv_step(*map(_t, (r, k, v, w, u, S)))
    ref_out, ref_S = ref_rwkv.wkv_step(*map(jnp.asarray, (r, k, v, w, u, S)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(S_new.numpy(), np.asarray(ref_S),
                               rtol=1e-6, atol=1e-6)
    # the oracle continued from a state S0, as decoding continues a prefill
    seq = _wkv_inputs(seed, B, H, 20, K, V)
    o, s = port_rwkv.wkv_sequential(*map(_t, seq), S0=_t(S))
    ro, rs = ref_rwkv.wkv_sequential(*map(jnp.asarray, seq),
                                     S0=jnp.asarray(S))
    np.testing.assert_allclose(o.numpy(), np.asarray(ro), **WKV_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), **WKV_TOL)


@pytest.mark.parametrize("case", ["rank", "v_rows", "u_shape", "mixed_dtype",
                                  "w_dtype", "f16", "strided", "device",
                                  "empty"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    r = torch.ones(1, 2, 8, 16)
    v, w, u = torch.ones(1, 2, 8, 16), torch.ones(1, 2, 8, 16), \
        torch.ones(2, 16)
    args = {"rank": (r[0], r[0], v[0], w[0], u),
            "v_rows": (r, r, torch.ones(1, 2, 7, 16), w, u),
            "u_shape": (r, r, v, w, torch.ones(2, 8)),
            "mixed_dtype": (r, r.bfloat16(), v, w, u),
            "w_dtype": (r, r, v, w.double(), u),
            "f16": (r.half(), r.half(), v.half(), w, u.half()),
            "strided": (torch.ones(1, 2, 16, 8).transpose(2, 3), r, v, w, u),
            "device": tuple(t.to("meta") for t in (r, r, v, w, u)),
            "empty": (r[:, :, :0], r[:, :, :0], v[:, :, :0], w[:, :, :0],
                      u)}[case]
    with pytest.raises((ValueError, TypeError)):
        wkv(*args)


def test_cpu_path_counts_no_launch_and_is_differentiable():
    ins = [t.requires_grad_(True) for t in map(
        _t, _wkv_inputs(3, 1, 1, 12, 16, 16))]
    before = wkv.launches
    out, s_last = wkv(*ins)
    (out.sum() + s_last.sum()).backward()
    assert wkv.launches == before
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in ins)


# --------------------------------------------------------------------- #
# the model at REDUCED
# --------------------------------------------------------------------- #
def _cfgs(**over):
    over = dict(dict(compute_dtype="float32", remat="none"), **over)
    return (dataclasses.replace(ref_rwkv_cfg.REDUCED, **over),
            dataclasses.replace(port_rwkv_cfg.REDUCED, **over))


def _perturbed(tree, seed):
    """The reference's tree with every zero-initialised rwkv leaf drawn
    from numpy: mixes in [0, 1], decay bias in [-1, 0.5], small LoRA
    output, bonus and head-norm weights."""
    rng = np.random.default_rng(seed)
    draw = {"mu": lambda s: rng.uniform(0.0, 1.0, s),
            "w0": lambda s: rng.uniform(-1.0, 0.5, s),
            "w_lora_b": lambda s: 0.1 * rng.standard_normal(s),
            "u": lambda s: 0.5 * rng.standard_normal(s),
            "gn": lambda s: 0.1 * rng.standard_normal(s)}

    def walk(t):
        if isinstance(t, dict):
            return {k: (draw[k](np.shape(x)).astype(np.float32)
                        if k in draw and not isinstance(x, dict)
                        else walk(x)) for k, x in t.items()}
        if isinstance(t, list):
            return [walk(x) for x in t]
        return t
    return walk(tree)


def _params(rcfg, pcfg, variant, seed=0):
    tree = jax.tree.map(np.asarray,
                        ref_tf.init_params(rcfg, jax.random.PRNGKey(seed)))
    if variant == "perturbed":
        tree = _perturbed(tree, seed)
    return tree, port_tf.params_from_numpy(tree, pcfg, device="cpu")


def _tokens(vocab, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.fixture
def sequential_reference(monkeypatch):
    """The reference with its chunked WKV replaced by the exact oracle,
    for inputs where the chunked form's clamp would bite."""
    monkeypatch.setattr(
        ref_rwkv, "wkv_chunked",
        lambda r, k, v, w, u, S0=None, chunk=None:
        ref_rwkv.wkv_sequential(r, k, v, w, u, S0))


def _assert_tree_close(ref_tree, port_tree):
    """Every cache leaf at ``MODEL_TOL``, plus 1e-5 of the leaf's largest
    magnitude: a WKV state entry sums up to S products k·v of both sides'
    float32 projections, and at these weights the states reach ~60 while
    single entries cancel to ~0.1 (the largest such difference seen is
    3e-4, 5e-6 of the scale)."""
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    port_leaves = tree_leaves(port_tree)
    assert len(ref_leaves) == len(port_leaves)
    for (path, a), b in zip(ref_leaves, port_leaves):
        a = np.asarray(a, np.float32)
        assert tuple(b.shape) == a.shape, jax.tree_util.keystr(path)
        scale = float(np.abs(a).max()) if a.size else 0.0
        np.testing.assert_allclose(
            b.float().numpy(), a, rtol=MODEL_TOL["rtol"],
            atol=MODEL_TOL["atol"] + 1e-5 * scale,
            err_msg=jax.tree_util.keystr(path))


def test_model_specs_match_reference_full_and_reduced():
    for full, reduced in ((ref_rwkv_cfg.FULL, port_rwkv_cfg.FULL),
                          (ref_rwkv_cfg.REDUCED, port_rwkv_cfg.REDUCED)):
        ref_specs = jax.tree.leaves(
            ref_tf.model_specs(full),
            is_leaf=lambda x: isinstance(x, ref_tf.Spec))
        port_specs = spec_leaves(port_tf.model_specs(reduced))
        assert [(s.shape, s.axes, s.init, s.scale) for s in ref_specs] == \
            [(s.shape, s.axes, s.init, s.scale) for s in port_specs]
    n = sum(math.prod(s.shape)
            for s in spec_leaves(port_tf.model_specs(port_rwkv_cfg.FULL)))
    assert n == 1_583_941_632                   # rwkv6-1.6b, 24 layers


@pytest.mark.parametrize("variant", ["init", "perturbed"])
def test_forward_and_loss_match_reference(variant, sequential_reference):
    rcfg, pcfg = _cfgs()
    tree, params = _params(rcfg, pcfg, variant)
    toks = _tokens(rcfg.vocab, 2, 40)
    labels = np.roll(toks, -1, axis=1)
    weights = np.random.default_rng(1).uniform(0, 1, toks.shape).astype(
        np.float32)
    x_r, _, _ = ref_tf.forward(tree, {"tokens": jnp.asarray(toks)}, rcfg)
    x_p, aux = port_tf.forward(params, {"tokens": torch.from_numpy(toks)},
                               pcfg)
    np.testing.assert_allclose(x_p.numpy(), np.asarray(x_r), **MODEL_TOL)
    assert float(aux) == 0.0
    batch = {"tokens": toks, "labels": labels, "weights": weights}
    loss_r = ref_tf.loss_fn(tree, {k: jnp.asarray(v)
                                   for k, v in batch.items()}, rcfg)
    loss_p = port_tf.loss_fn(params, {k: torch.from_numpy(v)
                                      for k, v in batch.items()}, pcfg)
    np.testing.assert_allclose(float(loss_p), float(loss_r), rtol=1e-5)


def _prefill_and_decode(rcfg, pcfg, tree, params, S, n_steps=8, B=2):
    """Prefill S tokens, then ``n_steps`` teacher-forced decode steps, on
    both sides; every step's logits and the caches are compared."""
    toks = _tokens(rcfg.vocab, B, S + n_steps, seed=S)
    last_r, caches_r, pos_r = ref_tf.prefill(
        tree, {"tokens": jnp.asarray(toks[:, :S])}, rcfg)
    last_p, caches_p, pos_p = port_tf.prefill(
        params, {"tokens": torch.from_numpy(toks[:, :S])}, pcfg)
    assert pos_p == int(pos_r) == S
    assert last_p.dtype == torch.float32 and last_p.shape == (B, rcfg.vocab)
    np.testing.assert_allclose(last_p.numpy(), np.asarray(last_r),
                               **MODEL_TOL)
    _assert_tree_close(caches_r, caches_p)
    caches_r = ref_tf.pad_cache(caches_r, rcfg, extra=n_steps)
    caches_p = port_tf.pad_cache(caches_p, pcfg, extra=n_steps)
    _assert_tree_close(caches_r, caches_p)
    for i in range(n_steps):
        tok = toks[:, S + i:S + i + 1]
        lr, caches_r = ref_tf.decode_step(tree, jnp.asarray(tok), caches_r,
                                          pos_r + i, rcfg)
        lp, caches_p = port_tf.decode_step(params, torch.from_numpy(tok),
                                           caches_p, pos_p + i, pcfg)
        np.testing.assert_allclose(lp.numpy(), np.asarray(lr), **MODEL_TOL,
                                   err_msg=f"decode step {i}")
    _assert_tree_close(caches_r, caches_p)
    return toks, lp


@pytest.mark.parametrize("variant", ["init", "perturbed"])
def test_prefill_and_decode_match_reference(variant, request):
    """At the initial weights the reference runs as it is (REDUCED's chunk
    of 16 keeps its clamp out of reach); the perturbed decays pass it, so
    there the reference's WKV is the exact oracle."""
    if variant == "perturbed":
        request.getfixturevalue("sequential_reference")
    rcfg, pcfg = _cfgs()
    tree, params = _params(rcfg, pcfg, variant)
    _prefill_and_decode(rcfg, pcfg, tree, params, S=24)


@pytest.mark.parametrize("variant", ["init", "perturbed"])
def test_chunk_64_at_128_tokens_matches_sequential_reference(
        variant, sequential_reference):
    rcfg, pcfg = _cfgs(rwkv_chunk=64)
    tree, params = _params(rcfg, pcfg, variant, seed=1)
    toks, last = _prefill_and_decode(rcfg, pcfg, tree, params, S=128,
                                     n_steps=3, B=1)
    # decode continued from prefill == one forward over all the tokens
    x, _ = port_tf.forward(params, {"tokens": torch.from_numpy(toks)}, pcfg)
    np.testing.assert_allclose(last.numpy(), (x[:, -1] @ params["lm_head"])
                               .numpy(), **MODEL_TOL)


def test_bf16_prefill_and_decode_match_reference():
    """bfloat16 compute on both sides: the two frameworks round
    intermediate bf16 values at other places, so the logits agree to a
    few bf16 steps of their scale (about 1), not to float32 precision."""
    rcfg, pcfg = _cfgs(compute_dtype="bfloat16")
    tree, params = _params(rcfg, pcfg, "perturbed", seed=2)
    toks = _tokens(rcfg.vocab, 2, 20, seed=3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_rwkv, "wkv_chunked",
                   lambda r, k, v, w, u, S0=None, chunk=None:
                   ref_rwkv.wkv_sequential(r, k, v, w, u, S0))
        last_r, caches_r, pos = ref_tf.prefill(
            tree, {"tokens": jnp.asarray(toks[:, :16])}, rcfg)
        lr, _ = ref_tf.decode_step(tree, jnp.asarray(toks[:, 16:17]),
                                   caches_r, pos, rcfg)
    last_p, caches_p, pos_p = port_tf.prefill(
        params, {"tokens": torch.from_numpy(toks[:, :16])}, pcfg)
    lp, _ = port_tf.decode_step(params, torch.from_numpy(toks[:, 16:17]),
                                caches_p, pos_p, pcfg)
    for a, b in ((last_p, last_r), (lp, lr)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-2,
                                   atol=5e-2)
    assert caches_p[0]["l0"]["mix"]["S"].dtype == torch.float32
    assert caches_p[0]["l0"]["mix"]["tm"].dtype == torch.float32


def test_init_cache_matches_reference_layout():
    rcfg, pcfg = _cfgs()
    ref = ref_tf.init_cache(rcfg, 3, 10)
    port = port_tf.init_cache(pcfg, 3, 10, device="cpu")
    _assert_tree_close(ref, port)
    assert all(t.dtype == torch.float32 for t in tree_leaves(port))


def _ref_chunked_as_sequential(r, k, v, w, u, S0=None, *, chunk=32):
    return ref_rwkv.wkv_sequential(r, k, v, w, u, S0)


def test_rwkv_training_matches_reference(tmp_path, capsys, monkeypatch):
    """rwkv6-1.6b REDUCED through ``launch.train.train`` (coded) against
    the reference's loop on its float32 twin (``tests/
    torch_train_parity.py``).  The port's WKV is an autograd Function
    whose backward on the CPU is the written-out ``wkv_bwd_ref``; the
    reference differentiates its ``wkv_chunked``, patched here to
    ``wkv_sequential`` as above, since its clamped exponent is wrong past
    a cumulative log-decay of -30 inside a chunk."""
    monkeypatch.setattr(ref_rwkv, "wkv_chunked", _ref_chunked_as_sequential)
    run_against_reference("rwkv6-1.6b", True, FLAGS, tmp_path, capsys,
                          monkeypatch)
