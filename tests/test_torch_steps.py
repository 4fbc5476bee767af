"""The port's step builders (``repro_torch.launch.steps``) against the JAX
package's (``repro.launch.steps``) at TINY's float32 twin, within the
tolerances of ``tests/test_torch_launch_train.py``: the train step over 3
steps plain, with the EF int8 quantizer and with EF top-k as
``grad_transform`` (losses within rtol 1e-4 plus the port's own one-ulp
sensitivity; each parameter leaf within ``ULP_FACTOR`` times the distance
that a one-ulp nudge of every initial weight makes, plus ``NORM_FLOOR``:
the compressors round, so a gradient that moves by an ulp may move a code
by one step, and the nudged run, compressed alike, measures that too);
the quantizer inside the step equal to the reference's on the gradient it
was given, exactly; the prefill step and 3 serve steps (logits within
``tests/test_torch_serve.py``'s rtol and atol 1e-4, caches with the
absolute bound taken of their largest entry).  The reference's loss is
jitted (its eager step takes seconds at TINY); the step around it is the
reference's own.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.compress as ref_compress
import repro.launch.steps as ref_steps
import repro.launch.train as ref_train
import repro.models.transformer as ref_tf
from repro.configs.base import list_archs as ref_list_archs

import repro_torch.compress as port_compress
import repro_torch.launch.train as port_train
import repro_torch.models.transformer as port_tf
from repro_torch.core import coded_step
from repro_torch.launch import steps as port_steps
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.sim import threefry

ref_list_archs()        # fill the reference's registry before anything else
SERVE_TOL = dict(rtol=1e-4, atol=1e-4)
ULP_FACTOR, NORM_FLOOR = 10.0, 1e-6
TINY32 = dataclasses.replace(port_train.TINY, compute_dtype="float32")
REF_TINY32 = dataclasses.replace(ref_train.TINY, compute_dtype="float32")
_REF_LOSS = jax.jit(ref_tf.loss_fn, static_argnums=(2,),
                    static_argnames=("dp_shards",))
KEY = 3


@pytest.fixture
def jitted_ref_loss(monkeypatch):
    monkeypatch.setattr(ref_tf, "loss_fn", _REF_LOSS)


def _ref_params():
    return jax.tree.map(np.asarray, ref_tf.init_params(
        ref_train.TINY, jax.random.PRNGKey(0)))


def _ulp_nudge(tree, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def nudge(x):
        d = torch.randint(-1, 2, x.shape, generator=gen)
        return torch.where(d > 0, torch.nextafter(x, torch.full_like(
            x, np.inf)), torch.where(d < 0, torch.nextafter(
                x, torch.full_like(x, -np.inf)), x))
    return tree_map(nudge, tree)


def _batches(n=3, B=2, S=32):
    rng = np.random.default_rng(0)
    return [{"tokens": rng.integers(0, 512, (B, S)).astype(np.int32),
             "labels": rng.integers(0, 512, (B, S)).astype(np.int32),
             "weights": rng.random((B, S)).astype(np.float32)}
            for _ in range(n)]


def _ref_compressor(kind, params):
    if kind == "none":
        return None
    init, transform = (ref_compress.make_ef_quantizer() if kind == "int8"
                       else ref_compress.make_ef_topk(0.05))
    state = {"errors": init(params), "calls": 0}

    def hook(grads):
        args = (grads, state["errors"])
        if kind == "int8":
            args += (jax.random.fold_in(jax.random.PRNGKey(KEY),
                                        state["calls"]),)
        out, state["errors"] = transform(*args)
        state["calls"] += 1
        return out
    return hook


def _port_compressor(kind, params, seen=None):
    if kind == "none":
        return None
    hook = (port_compress.ErrorFeedback(
        port_compress.make_ef_quantizer(), params, threefry.prng_key(KEY))
        if kind == "int8" else port_compress.ErrorFeedback(
            port_compress.make_ef_topk(0.05), params))
    if seen is None:
        return hook

    def recording(grads):
        seen.append((tree_map(torch.clone, grads),
                     tree_map(torch.clone, hook.errors)))
        out = hook(grads)
        seen[-1] += (out,)
        return out
    return recording


def _ref_run(kind, batches):
    params = jax.tree.map(jnp.asarray, _ref_params())
    step, opt = ref_steps.make_train_step(
        REF_TINY32, 1, grad_transform=_ref_compressor(kind, params))
    opt_state, losses = opt.init(params), []
    for b in batches:
        params, opt_state, aux = step(params, opt_state,
                                      jax.tree.map(jnp.asarray, b))
        losses.append(float(aux["loss"]))
    return params, losses


def _port_run(kind, batches, params, seen=None):
    step, opt = port_steps.make_train_step(
        TINY32, 1, grad_transform=_port_compressor(kind, params, seen))
    opt_state, losses, norms = opt.init(params), [], []
    for b in batches:
        params, opt_state, aux = step(
            params, opt_state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(aux["loss"]))
        norms.append(float(aux["grad_norm"]))
    assert int(opt_state.step) == len(batches)
    return params, losses, norms


def _norm(x):
    return float(np.linalg.norm(np.asarray(x, np.float64)))


@pytest.mark.parametrize("kind", ["none", "int8", "topk"])
def test_train_step_matches_reference(kind, jitted_ref_loss):
    batches = _batches()
    want_p, want = _ref_run(kind, batches)
    p0 = port_tf.params_from_numpy(_ref_params(), TINY32, device="cpu")
    seen = []
    got_p, got, norms = _port_run(kind, batches, p0, seen)
    nudged_p, nudged, _ = _port_run(kind, batches, _ulp_nudge(p0))
    sens = np.abs(np.subtract(nudged, got))
    np.testing.assert_array_less(np.abs(np.subtract(got, want)),
                                 1e-4 * np.abs(want) + ULP_FACTOR * sens)
    assert all(np.isfinite(norms)) and min(norms) > 0
    for a, b, c, x0 in zip(jax.tree.leaves(want_p), *(tree_leaves(x) for x in
                                                      (got_p, nudged_p, p0))):
        a, b, c = np.asarray(a, np.float64), b.double().numpy(), \
            c.double().numpy()
        moved = _norm(a - x0.double().numpy())
        err, sens = _norm(b - a) / moved, _norm(c - b) / moved
        assert err <= ULP_FACTOR * sens + NORM_FLOOR, (err, sens)
    if kind == "none":
        return
    # inside the step, the port's compressor equals the reference's on
    # the gradient (and residuals) it was given, exactly
    assert len(seen) == len(batches)
    init, transform = (ref_compress.make_ef_quantizer() if kind == "int8"
                       else ref_compress.make_ef_topk(0.05))
    for n, (grads, errors, out) in enumerate(seen):
        args = [jax.tree.map(lambda t: jnp.asarray(t.numpy()), x)
                for x in (grads, errors)]
        if kind == "int8":
            args.append(jax.random.fold_in(jax.random.PRNGKey(KEY), n))
        want_out, _ = transform(*args)
        for g, w in zip(tree_leaves(out), jax.tree.leaves(want_out)):
            assert np.array_equal(g.numpy().view(np.uint32),
                                  np.asarray(w).view(np.uint32))


def test_optimizer_is_the_reference_s():
    """AdamW(b1 0.9, b2 0.95, weight decay 0.1) at the config's state type,
    3 updates of the same gradients, within float32 rounding."""
    rng = np.random.default_rng(1)
    params = {"a": rng.standard_normal((4, 5)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    opt_r = ref_steps.make_optimizer(REF_TINY32, lr=1e-2)
    opt_p = port_steps.make_optimizer(TINY32, lr=1e-2)
    p_r = jax.tree.map(jnp.asarray, params)
    p_p = {k: torch.from_numpy(v) for k, v in params.items()}
    s_r, s_p = opt_r.init(p_r), opt_p.init(p_p)
    assert s_p.m["a"].dtype == torch.float32
    for i in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
        p_r, s_r = opt_r.update(jax.tree.map(jnp.asarray, g), s_r, p_r)
        p_p, s_p = opt_p.update({k: torch.from_numpy(v)
                                 for k, v in g.items()}, s_p, p_p)
    for k in params:
        np.testing.assert_allclose(p_p[k].numpy(), np.asarray(p_r[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(s_p.v[k].numpy(), np.asarray(s_r.v[k]),
                                   rtol=1e-6, atol=1e-9)


def test_train_step_is_functional_and_inplace_refuses_a_transform():
    p0 = port_tf.params_from_numpy(_ref_params(), TINY32, device="cpu")
    before = [t.clone() for t in tree_leaves(p0)]
    hook = _port_compressor("int8", p0)
    step, opt = port_steps.make_train_step(TINY32, grad_transform=hook)
    opt_state = opt.init(p0)
    b = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    params, _, aux = step(p0, opt_state, b)
    assert all(torch.equal(a, t) for a, t in zip(before, tree_leaves(p0)))
    assert int(opt_state.step) == 0 and hook.calls == 1
    assert not all(torch.equal(a, t) for a, t in zip(before,
                                                     tree_leaves(params)))
    with pytest.raises(ValueError, match="functional"):
        coded_step.make_train_step(lambda p, b: 0.0, opt, inplace=True,
                                   grad_transform=hook)


def test_steps_pass_dp_shards_through(monkeypatch):
    seen = []

    def spy(name):
        real = getattr(port_tf, name)

        def fn(*args, dp_shards=1, **kw):
            seen.append((name, dp_shards))
            return real(*args, dp_shards=dp_shards, **kw)
        monkeypatch.setattr(port_tf, name, fn)
    for name in ("loss_fn", "prefill", "decode_step"):
        spy(name)
    p0 = port_tf.params_from_numpy(_ref_params(), TINY32, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _batches(1, S=8)[0].items()}
    step, opt = port_steps.make_train_step(TINY32, 2)
    step(p0, opt.init(p0), b)
    logits, caches = port_steps.make_prefill_step(TINY32, 2)(
        p0, {"tokens": b["tokens"]})
    caches = port_tf.pad_cache(caches, TINY32, 1)
    port_steps.make_serve_step(TINY32, 2)(p0, b["tokens"][:, :1], caches, 8)
    assert seen == [("loss_fn", 2), ("prefill", 2), ("decode_step", 2)]


def _close(got, want, scaled=False):
    """Within ``SERVE_TOL``; a cache (``scaled``) with the absolute bound
    taken of its largest entry: keys and values of the second layer carry
    the first layer's float32 rounding, ~1e-5 of their size."""
    want = np.asarray(want, np.float32)
    tol = dict(SERVE_TOL)
    if scaled:
        tol["atol"] *= max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().float().numpy(), want, **tol)


def test_prefill_and_serve_steps_match_reference():
    rng = np.random.default_rng(2)
    B, S, n_dec = 2, 24, 3
    toks = rng.integers(0, 512, (B, S)).astype(np.int32)
    dec = rng.integers(0, 512, (n_dec, B, 1)).astype(np.int32)
    p_ref = jax.tree.map(jnp.asarray, _ref_params())
    p = port_tf.params_from_numpy(_ref_params(), TINY32, device="cpu")
    want, want_c = ref_steps.make_prefill_step(REF_TINY32, 1)(
        p_ref, {"tokens": jnp.asarray(toks)})
    got, got_c = port_steps.make_prefill_step(TINY32, 1)(
        p, {"tokens": torch.from_numpy(toks)})
    assert tuple(got.shape) == (B, 512) and got.dtype == torch.float32
    _close(got, want)
    for g, w in zip(tree_leaves(got_c), jax.tree.leaves(want_c)):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, scaled=True)
    want_c = ref_tf.pad_cache(want_c, REF_TINY32, n_dec)
    got_c = port_tf.pad_cache(got_c, TINY32, n_dec)
    serve_r = ref_steps.make_serve_step(REF_TINY32, 1)
    serve_p = port_steps.make_serve_step(TINY32, 1)
    for i in range(n_dec):
        want, want_c = serve_r(p_ref, jnp.asarray(dec[i]), want_c,
                               jnp.int32(S + i))
        got, got_c = serve_p(p, torch.from_numpy(dec[i]), got_c, S + i)
        _close(got, want)
    for g, w in zip(tree_leaves(got_c), jax.tree.leaves(want_c)):
        _close(g, w, scaled=True)
