"""The port's gradient compressors (``repro_torch.compress``) against the
JAX package's (``repro.compress``), exactly: the same int8 codes, scales,
dequantized values, residuals and masks from the same keys, on the cases
of ``tests/test_compress.py`` (its hypothesis ranges drawn here with fixed
numpy seeds: n in [10, 2000] with 255, 256 and 257, scale in [1e-3,
1e3]); the device draws of ``repro_torch.sim.threefry`` against
``jax.random.uniform`` over slices."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.compress as ref
import repro_torch.compress as port
from repro_torch.compress import quantize as port_quantize
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.sim import threefry


def _cases(count=12, seed=0):
    rng = np.random.default_rng(seed)
    ns = [10, 255, 256, 257, 2000] + list(rng.integers(10, 2001, count - 5))
    return [(int(rng.integers(0, 2 ** 31 - 1)),
             float(np.exp(rng.uniform(np.log(1e-3), np.log(1e3)))), int(n))
            for n in ns]


CASES = _cases()


def _bits(x):
    x = np.asarray(x)
    return x.view({4: np.uint32, 2: np.uint16, 1: np.uint8}[x.itemsize])


def _equal(got, want):
    got = got.detach()
    if got.dtype == torch.bfloat16:
        got = got.view(torch.int16)
        want = np.asarray(want).view(np.int16)
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    assert np.array_equal(_bits(got), _bits(want))


def _x(seed, scale, n):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(
        np.float32)


@pytest.mark.parametrize("seed,scale,n", CASES)
def test_quantize_and_dequantize_equal_the_reference(seed, scale, n):
    x = _x(seed, scale, n)
    q_r, s_r = ref.quantize_int8(jnp.asarray(x), jax.random.PRNGKey(seed))
    q, s = port.quantize_int8(torch.from_numpy(x), threefry.prng_key(seed))
    _equal(q, q_r)
    _equal(s, s_r)
    deq = port.dequantize_int8(q, s, (n,), n)
    _equal(deq, ref.dequantize_int8(q_r, s_r, (n,), n))
    # the reference test's bound: one quantization step per block
    step = np.repeat(s.numpy()[:, 0], 256)[:n]
    assert np.all(np.abs(deq.numpy() - x) <= step + 1e-6)


def test_quantize_slices_the_draws_alike(monkeypatch):
    """Noise drawn a slice at a time is the noise drawn at once."""
    x = torch.from_numpy(_x(3, 2.0, 3000).reshape(30, 100))
    key = threefry.split(threefry.prng_key(7), 2)[1]
    whole = port.quantize_int8(x, key)
    monkeypatch.setattr(port_quantize, "DRAW_SLICE", 512)
    sliced = port.quantize_int8(x, key)
    assert torch.equal(whole[0], sliced[0]) and torch.equal(whole[1],
                                                            sliced[1])
    _equal(whole[0], ref.quantize_int8(jnp.asarray(x.numpy()),
                                       jnp.asarray(key))[0])


def test_zero_and_tiny_blocks_equal_the_reference():
    x = np.zeros(600, np.float32)
    x[300:310] = 1e-30                     # scale clamped at 1e-12
    x[500] = -3.0
    q_r, s_r = ref.quantize_int8(jnp.asarray(x), jax.random.PRNGKey(1))
    q, s = port.quantize_int8(torch.from_numpy(x), threefry.prng_key(1))
    _equal(q, q_r)
    _equal(s, s_r)


def test_unbiased_case_equals_the_reference():
    """``test_int8_stochastic_rounding_unbiased``'s 64 keys of one split."""
    x = jnp.full((4096,), 0.34567, jnp.float32) * jnp.linspace(0.5, 2, 4096)
    xt = torch.from_numpy(np.array(x))
    keys = jax.random.split(jax.random.PRNGKey(0), 64)
    port_keys = threefry.split(threefry.prng_key(0), 64)
    assert np.array_equal(np.asarray(keys), port_keys)
    for k, pk in zip(keys[:16], port_keys[:16]):
        q_r, s_r = ref.quantize_int8(x, k)
        q, s = port.quantize_int8(xt, pk)
        _equal(q, q_r)
        _equal(s, s_r)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"b": rng.standard_normal((3, 100)).astype(np.float32) * 1e-2,
            "a": {"z": rng.standard_normal(257).astype(np.float32),
                  "y": (rng.standard_normal((16, 16)) * 30).astype(
                      np.float32)},
            "c": rng.standard_normal(700).astype(np.float32) * 1e-4}


def _torch_tree(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _torch_tree(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree, np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ef_quantizer_three_steps_equals_the_reference(dtype):
    init_r, transform_r = ref.make_ef_quantizer()
    init_p, transform_p = port.make_ef_quantizer()
    jdt = jnp.dtype(dtype)
    params = _tree(0)
    errs_r = init_r(jax.tree.map(jnp.asarray, params))
    errs_p = init_p(_torch_tree(params))
    for step in range(3):
        g = _tree(10 + step)
        g_r = jax.tree.map(lambda a: jnp.asarray(a, jdt), g)
        g_p = _torch_tree(g, getattr(torch, dtype))
        key = jax.random.fold_in(jax.random.PRNGKey(5), step)
        sent_r, errs_r = transform_r(g_r, errs_r, key)
        sent_p, errs_p = transform_p(g_p, errs_p, np.asarray(key))
        for got, want in zip(tree_leaves(sent_p), jax.tree.leaves(sent_r)):
            _equal(got, want)
        for got, want in zip(tree_leaves(errs_p), jax.tree.leaves(errs_r)):
            _equal(got, want)
        assert set(sent_p) == set(g)


@pytest.mark.parametrize("make", [port.make_ef_quantizer,
                                  port.make_ef_topk])
def test_init_gives_float32_zero_residuals(make):
    init, _ = make()
    params = {"b": torch.ones(3, dtype=torch.bfloat16),
              "a": [torch.ones(2, 2), torch.ones(5)]}
    for errors in (init(params), init(params, "cpu")):
        leaves = tree_leaves(errors)
        assert [tuple(e.shape) for e in leaves] == [(2, 2), (5,), (3,)]
        assert all(e.dtype == torch.float32 and e.device.type == "cpu" and
                   not e.any() for e in leaves)
        assert list(errors) == ["b", "a"]


def test_error_feedback_accumulates_as_the_reference():
    """``test_error_feedback_accumulates``: 1e-6 gradients, far below one
    step, reach the wire through the residual, step for step alike."""
    init_r, transform_r = ref.make_ef_quantizer()
    init_p, transform_p = port.make_ef_quantizer()
    errs_r = init_r({"w": jnp.zeros((512,))})
    errs_p = init_p({"w": torch.zeros(512)})
    g_r, g_p = {"w": jnp.full((512,), 1e-6)}, {"w": torch.full((512,), 1e-6)}
    total = torch.zeros(512)
    for i in range(40):
        sent_r, errs_r = transform_r(g_r, errs_r, jax.random.PRNGKey(i))
        sent_p, errs_p = transform_p(g_p, errs_p, threefry.prng_key(i))
        _equal(sent_p["w"], sent_r["w"])
        _equal(errs_p["w"], errs_r["w"])
        total += sent_p["w"]
    assert float(total.abs().sum()) > 0


def test_error_feedback_hook_carries_residuals():
    """``ErrorFeedback`` is the transform with the residuals carried and
    call ``n`` keyed by ``fold_in(key, n)``."""
    init_r, transform_r = ref.make_ef_quantizer()
    params = _tree(1)
    hook = port.ErrorFeedback(port.make_ef_quantizer(), _torch_tree(params),
                              threefry.prng_key(9))
    errs_r = init_r(jax.tree.map(jnp.asarray, params))
    for n in range(3):
        g = _tree(20 + n)
        sent = hook(_torch_tree(g))
        sent_r, errs_r = transform_r(
            jax.tree.map(jnp.asarray, g), errs_r,
            jax.random.fold_in(jax.random.PRNGKey(9), n))
        for got, want in zip(tree_leaves(sent), jax.tree.leaves(sent_r)):
            _equal(got, want)
        for got, want in zip(tree_leaves(hook.errors),
                             jax.tree.leaves(errs_r)):
            _equal(got, want)
    assert hook.calls == 3


@pytest.mark.parametrize("x,k", [
    ([0.1, -5.0, 0.2, 3.0, -0.05], 2),
    ([1.0, -1.0, 1.0, 0.5, -1.0, 0.25], 2),      # a tie at the threshold
    ([2.0, 2.0, 2.0, 2.0], 1),
    ([0.0, -0.0, 0.0, 1e-30], 3),
])
def test_topk_mask_equals_the_reference_with_ties(x, k):
    want = ref.topk_mask(jnp.asarray(x, jnp.float32), k)
    got = port.topk_mask(torch.tensor(x, dtype=torch.float32), k)
    _equal(got, want)


@pytest.mark.parametrize("seed,scale,n", CASES[:6])
def test_topk_mask_random_equals_the_reference(seed, scale, n):
    x = _x(seed, scale, n)
    x[::7] = x[0]                      # ties, some at the threshold
    for k in (1, max(n // 20, 1), n // 2, n):
        _equal(port.topk_mask(torch.from_numpy(x), k),
               ref.topk_mask(jnp.asarray(x), k))


@pytest.mark.parametrize("fraction", [0.05, 0.1, 0.5])
def test_ef_topk_three_steps_equals_the_reference(fraction):
    init_r, transform_r = ref.make_ef_topk(fraction)
    init_p, transform_p = port.make_ef_topk(fraction)
    params = _tree(2)
    errs_r = init_r(jax.tree.map(jnp.asarray, params))
    errs_p = init_p(_torch_tree(params))
    for step in range(3):
        g = _tree(30 + step)
        sent_r, errs_r = transform_r(jax.tree.map(jnp.asarray, g), errs_r)
        sent_p, errs_p = transform_p(_torch_tree(g), errs_p)
        for got, want in zip(tree_leaves(sent_p), jax.tree.leaves(sent_r)):
            _equal(got, want)
        for got, want in zip(tree_leaves(errs_p), jax.tree.leaves(errs_r)):
            _equal(got, want)


def test_ef_topk_quadratic_equals_the_reference():
    """``test_ef_topk_convergence_on_quadratic``'s first 100 steps, equal
    step for step (the weights move by the same float32 operations)."""
    init_r, transform_r = ref.make_ef_topk(fraction=0.1)
    init_p, transform_p = port.make_ef_topk(fraction=0.1)
    w0 = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    w_r, w_p = jnp.asarray(w0), torch.from_numpy(w0)
    errs_r, errs_p = init_r({"w": w_r}), init_p({"w": w_p})
    for _ in range(100):
        sent_r, errs_r = transform_r({"w": 2 * w_r}, errs_r)
        sent_p, errs_p = transform_p({"w": 2 * w_p}, errs_p)
        _equal(sent_p["w"], sent_r["w"])
        w_r = w_r - 0.02 * sent_r["w"]
        w_p = w_p - 0.02 * sent_p["w"]
    _equal(w_p, w_r)


def test_compression_ratio_accounting():
    x = torch.zeros(1 << 16)
    q, s = port.quantize_int8(x, threefry.prng_key(0))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert x.numel() * 4 / (q.numel() + 4 * s.numel()) > 3.8


@pytest.mark.parametrize("start,count", [(0, 1), (0, 777), (255, 513),
                                         (2 ** 20 - 3, 9)])
@pytest.mark.parametrize("route", ["uniform_device", "uniform_tensors"])
def test_device_draws_equal_jax_uniform(start, count, route):
    key = jax.random.fold_in(jax.random.PRNGKey(11), 4)
    want = np.asarray(jax.random.uniform(key, (2 ** 20 + 6,))).reshape(-1)
    got = getattr(threefry, route)(np.asarray(key), start, count, "cpu")
    assert got.dtype == torch.float32
    _equal(got, want[start:start + count])


def test_quantize_by_the_card_route_equals_the_reference(monkeypatch):
    """The quantizer with its noise by the int64-tensor route (the card's),
    here on CPU tensors, equals the reference."""
    monkeypatch.setattr(threefry, "uniform_device", threefry.uniform_tensors)
    for seed, scale, n in CASES[:4]:
        x = _x(seed, scale, n)
        q_r, s_r = ref.quantize_int8(jnp.asarray(x), jax.random.PRNGKey(seed))
        q, s = port.quantize_int8(torch.from_numpy(x),
                                  threefry.prng_key(seed))
        _equal(q, q_r)
        _equal(s, s_r)
