"""The port's counter-based draws (``repro_torch.sim.threefry``) bit for
bit against ``jax.random``: ``PRNGKey``, ``fold_in``, the uniform bits
and their float32 map, at the extreme counters and at every soak shape;
``split`` (and keys split again, and folded); the device draws; and a
chunk drawn at once equals the same slots drawn one by one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.sim import threefry

SEEDS = (0, 1, 42, 2 ** 31 - 1, -1)
COUNTERS = (0, 1, 2 ** 16, 2 ** 31 - 1, 2 ** 32 - 1)
SHAPES = [(3, m) for m in range(1, 10)] + [(7,), (5, 3)]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in(seed):
    key = jax.random.PRNGKey(seed)
    assert np.array_equal(np.asarray(key), threefry.prng_key(seed))
    for k in COUNTERS:
        want = np.asarray(jax.random.fold_in(key, k))
        assert np.array_equal(threefry.fold_in(threefry.prng_key(seed), k),
                              want), k
    # a vector of counters folds each one in
    many = threefry.fold_in(threefry.prng_key(seed), np.asarray(COUNTERS))
    for row, k in zip(many, COUNTERS):
        assert np.array_equal(row, np.asarray(jax.random.fold_in(key, k)))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bits_and_floats(seed):
    key = jax.random.PRNGKey(seed)
    for k in COUNTERS:
        sub = jax.random.fold_in(key, k)
        port_key = threefry.fold_in(threefry.prng_key(seed), k)
        for shape in SHAPES:
            bits = threefry.uniform_bits(port_key, shape)
            assert np.array_equal(
                bits, np.asarray(jax.random.bits(sub, shape, jnp.uint32))), \
                (k, shape)
            got = threefry.bits_to_unit_float32(bits)
            want = np.asarray(jax.random.uniform(sub, shape,
                                                 dtype=jnp.float32))
            assert got.dtype == np.float32
            assert np.array_equal(got.view(np.uint32),
                                  want.view(np.uint32)), (k, shape)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 5, 64])
def test_split_equals_jax_split(seed, n):
    key = jax.random.PRNGKey(seed)
    port_key = threefry.prng_key(seed)
    for k in (0, 2 ** 32 - 1):                # a fresh key and a folded one
        sub, port_sub = jax.random.fold_in(key, k), threefry.fold_in(
            port_key, k)
        got = threefry.split(port_sub, n)
        want = np.asarray(jax.random.split(sub, n))
        assert got.dtype == np.uint32 and got.shape == (n, 2)
        assert np.array_equal(got, want)
        # a split key splits and draws alike
        assert np.array_equal(threefry.split(got[-1], 3),
                              np.asarray(jax.random.split(want[-1], 3)))
        assert np.array_equal(
            threefry.uniform_bits(got[0], (4, 5)),
            np.asarray(jax.random.bits(jnp.asarray(want[0]), (4, 5),
                                       jnp.uint32)))


def test_split_takes_a_shape_and_defaults_to_two():
    key = jax.random.PRNGKey(3)
    assert np.array_equal(threefry.split(threefry.prng_key(3)),
                          np.asarray(jax.random.split(key)))
    assert np.array_equal(threefry.split(threefry.prng_key(3), (2, 3)),
                          np.asarray(jax.random.split(key, (2, 3))))


@pytest.mark.parametrize("seed", [0, -1])
@pytest.mark.parametrize("route", ["uniform_device", "uniform_tensors"])
def test_device_uniforms_equal_the_host_bits(seed, route):
    """Both routes (the host's numpy words on the CPU; int64 tensors, the
    card's route, run here on CPU tensors)."""
    key = threefry.fold_in(threefry.prng_key(seed), 2 ** 31 - 1)
    host = threefry.bits_to_unit_float32(threefry.uniform_bits(key, (3000,)))
    for start, count in ((0, 3000), (1000, 1), (2047, 953)):
        got = getattr(threefry, route)(key, start, count, "cpu")
        assert got.dtype == torch.float32 and got.shape == (count,)
        assert np.array_equal(got.numpy().view(np.uint32),
                              host[start:start + count].view(np.uint32))


def test_tensor_route_past_two_to_the_32():
    """Counters past 2^32 carry a high word: the tensor route against the
    numpy cipher there."""
    key = threefry.prng_key(5)
    start = 2 ** 32 - 7
    got = threefry.uniform_tensors(key, start, 20, "cpu")
    want = threefry.uniform_device(key, start, 20, "cpu")
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    i = np.arange(start, start + 20, dtype=np.uint64)
    y0, y1 = threefry.threefry2x32(
        key, (i >> np.uint64(32)).astype(np.uint32),
        (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    assert np.array_equal(threefry.bits_to_unit_float32(y0 ^ y1),
                          got.numpy())


def test_bits_to_float_extremes():
    bits = np.array([0, 1, 511, 512, 2 ** 31, 2 ** 32 - 1], np.uint32)
    got = threefry.bits_to_unit_float32(bits)
    assert got[0] == 0.0 and got[1] == 0.0 and got[2] == 0.0
    assert got[3] == np.float32(2.0 ** -23)
    assert got[4] == np.float32(0.5)
    assert got[5] == np.float32(1.0) - np.float32(2.0 ** -23)


@pytest.mark.parametrize("M", [1, 6, 8])
def test_chunk_draw_equals_slots_one_by_one(M):
    seed, k0, n = 3, 2 ** 16 - 5, 11
    chunk = threefry.slot_uniforms(seed, k0, n, M)
    assert chunk.shape == (n, 3, M) and chunk.dtype == np.float32
    key = jax.random.PRNGKey(seed)
    for j in range(n):
        one = threefry.slot_uniforms(seed, k0 + j, 1, M)[0]
        want = np.asarray(jax.random.uniform(
            jax.random.fold_in(key, k0 + j), (3, M), dtype=jnp.float32))
        assert np.array_equal(chunk[j], one)
        assert np.array_equal(chunk[j].view(np.uint32),
                              want.view(np.uint32))
    # any split of the slots gives the same rows
    split = np.concatenate([threefry.slot_uniforms(seed, k0, 4, M),
                            threefry.slot_uniforms(seed, k0 + 4, n - 4, M)])
    assert np.array_equal(split, chunk)


def test_seed_out_of_int32_range_raises():
    with pytest.raises(ValueError, match="int32"):
        threefry.prng_key(2 ** 31)
