"""The port's counter-based draws (``repro_torch.sim.threefry``) bit for
bit against ``jax.random``: ``PRNGKey``, ``fold_in``, the uniform bits
and their float32 map, at the extreme counters and at every soak shape;
and a chunk drawn at once equals the same slots drawn one by one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

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
