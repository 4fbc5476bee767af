"""The port's P4–P7 scheduler equals the JAX package's bit for bit.

Every decision and the next ``QueueState``, ``R_server`` included, must be
equal to the last bit: float32 elementwise work is IEEE-exact on both
sides, the P7 prefix sum adds in float32 from left to right on both, and
the server queue's ``sum(c * xi)`` is the chain of fused multiply-adds
XLA's CPU backend compiles it into.  The draws
include ties in the P7 order (equal utilities, and idle workers whose
utility is exactly 0) and keep subnormals out of the P5/P6 comparisons,
where XLA flushes them (ROADMAP §3).

The batched call over ``(S, M)`` rows must equal S calls over ``(M,)``
rows, and with stacked heterogeneous physics it must equal the
reference's vmapped ``batched_schedule_slot``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lyapunov import queues as ref_queues
from repro.core.lyapunov import scheduler as ref_sched

from repro_torch.core.lyapunov import (Observation, QueueState, SystemParams,
                                       batched_schedule_slot,
                                       batched_schedule_slot_theta,
                                       dot_last, prefix_sum_last,
                                       run_horizon, schedule_slot,
                                       stack_system_params)

_REF_STEP = jax.jit(ref_sched.schedule_slot)
_REF_BATCHED = jax.jit(ref_sched.batched_schedule_slot)
FIELDS = ("T", "p", "delta", "xi", "f_max", "F", "E_cap", "V", "lam")


def _draw(rng, M):
    """One (state, params, observation) draw as float32 numpy arrays."""
    f32 = np.float32

    def pick(choices, size=None):
        return np.asarray(rng.choice(choices, size=size), f32)

    E_cap = pick([1.0, 4.0, 10.0])
    # inexact products (0.3·ν, 0.1·3, …) and energy caps that bind
    ph = {"T": pick([0.05, 0.1, 0.3]), "F": pick([1.0, 100.0]),
          "V": pick([0.5, 5.0, 50.0]),
          "p": pick([0.3, 0.5, 0.7, 4.0], M),
          "delta": pick([1e-4, 1e-3, 0.05], M),
          "xi": pick([0.0, 0.01, 0.5], M),
          "f_max": pick([1.0, 3.7, 100.0], M),
          "E_cap": np.full(M, E_cap, f32), "lam": np.ones(M, f32)}
    theta = f32(0.5) * ph["E_cap"]
    # backlogs: zeros, shared values (ties) and continuous draws
    Q = np.where(rng.random(M) < 0.3, 0.0,
                 np.where(rng.random(M) < 0.3, 1.5,
                          rng.uniform(0.0, 4.0, M))).astype(f32)
    H = np.where(rng.random(M) < 0.3, 0.0,
                 rng.uniform(0.0, 8.0, M)).astype(f32)
    # batteries at θ exactly make idle workers' utility 0
    E = np.where(rng.random(M) < 0.3, theta,
                 rng.uniform(0.0, 1.0, M) * ph["E_cap"]).astype(f32)
    R = np.where(rng.random(M) < 0.5, 0.0,
                 rng.uniform(0.0, 200.0, M)).astype(f32)
    R_server = f32(rng.choice([0.0, 0.0, rng.uniform(0.0, 300.0)]))
    D = np.where(rng.random(M) < 0.4, rng.uniform(0.0, 3.0, M),
                 0.0).astype(f32)
    r = pick([0.25, 1.5, 4.0, 10.0], M)
    if rng.random() < 0.3:          # every link equal: more exact ties
        r[:] = r[0]
    E_H = rng.uniform(0.0, 1.0, M).astype(f32)
    L = pick([1.0, 1.7, 2.0, 3.0])
    cyc = np.where(rng.random(M) < 0.3, rng.uniform(0.0, 50.0, M),
                   0.0).astype(f32)
    return (dict(Q=Q, H=H, E=E, R=R, R_server=R_server), ph,
            dict(D=D, r=r, E_H=E_H, L=L, new_cycles=cyc))


def _port(state, ph, obs):
    t = torch.from_numpy
    return (QueueState(**{k: t(np.asarray(v)) for k, v in state.items()}),
            SystemParams(**{k: t(np.asarray(ph[k])) for k in FIELDS}),
            Observation(**{k: t(np.asarray(v)) for k, v in obs.items()}))


def _ref(state, ph, obs):
    j = jnp.asarray
    return (ref_queues.QueueState(**{k: j(v) for k, v in state.items()}),
            ref_queues.SystemParams(**{k: j(ph[k]) for k in FIELDS}),
            ref_sched.Observation(**{k: j(v) for k, v in obs.items()}))


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _assert_same(ref_out, port_out):
    (s_r, d_r), (s_p, d_p) = ref_out, port_out
    for f in d_r._fields:
        np.testing.assert_array_equal(_bits(getattr(d_r, f)),
                                      _bits(getattr(d_p, f).numpy()),
                                      err_msg=f)
    for f in s_r._fields:
        np.testing.assert_array_equal(_bits(getattr(s_r, f)),
                                      _bits(getattr(s_p, f).numpy()),
                                      err_msg=f)


@pytest.mark.parametrize("M", [1, 6, 16])
@pytest.mark.parametrize("block", range(4))
def test_schedule_slot_is_bit_equal_to_reference(M, block):
    """200 draws a case, 2,400 in all: decisions and next state to the
    last bit.  The P7 prefix sum and ``R_server``'s sum are the parts
    that a double accumulation would change."""
    rng = np.random.default_rng(7919 * M + block)
    for _ in range(200):
        state, ph, obs = _draw(rng, M)
        _assert_same(_REF_STEP(*_ref(state, ph, obs)),
                     schedule_slot(*_port(state, ph, obs)))


def test_float32_prefix_sum_adds_from_left_to_right():
    x = torch.tensor([[1e8, 1.0, -1e8, 1.0], [3.0, 0.5, 0.25, 2.0]])
    # (1e8 + 1) rounds to 1e8 in float32, so the prefix ends at 1, not 2
    np.testing.assert_array_equal(
        prefix_sum_last(x).numpy(),
        np.array([[1e8, 1e8, 0.0, 1.0], [3.0, 3.5, 3.75, 5.75]],
                 np.float32))
    assert prefix_sum_last(torch.zeros(3, 0)).shape == (3, 0)


def test_dot_last_is_a_chain_of_fused_multiply_adds():
    """Each step rounds ``a·b + acc`` once, where float32 arithmetic
    rounds the product first; ``[c, a]·[1, b]`` is ``fma(a, b, c)``."""
    rng = np.random.default_rng(5)
    a, b, c = (rng.uniform(-4, 4, 20000).astype(np.float32)
               * rng.choice([1e-6, 1.0, 1e6], 20000).astype(np.float32)
               for _ in range(3))
    got = dot_last(torch.from_numpy(np.stack([c, a], 1)),
                   torch.from_numpy(np.stack([np.ones_like(b), b], 1)))
    got = got.numpy()
    # the exact value, then no float32 nearer to it than the result
    exact = a.astype(np.float64) * b + c
    err = np.abs(got.astype(np.float64) - exact)
    for nb in (np.nextafter(got, np.float32(-np.inf)),
               np.nextafter(got, np.float32(np.inf))):
        assert (err <= np.abs(nb.astype(np.float64) - exact)).all()
    assert (got != (a * b + c)).any()   # the twice-rounded result differs
    x = torch.tensor([[0.1, 0.2, 0.3], [3.0, 0.5, 0.25]])
    y = torch.tensor([[0.3, 0.7, 0.9], [1.0, 2.0, 4.0]])
    for row_x, row_y, got_row in zip(x, y, dot_last(x, y)):
        acc = row_x[:1] * row_y[:1]
        for u, v in zip(row_x[1:], row_y[1:]):
            acc = dot_last(torch.stack([acc[0], u]),
                           torch.stack([torch.tensor(1.0), v]))[None]
        assert acc[0].item() == got_row.item()
    assert dot_last(torch.zeros(2, 0), torch.zeros(2, 0)).shape == (2,)


def _stack_lanes(draws):
    states = [d[0] for d in draws]
    obs = [d[2] for d in draws]
    port_params = stack_system_params(
        [_port(*d)[1] for d in draws], device="cpu")
    st = QueueState(**{k: torch.from_numpy(np.stack(
        [np.asarray(s[k]) for s in states])) for k in states[0]})
    ob = Observation(**{k: torch.from_numpy(np.stack(
        [np.asarray(o[k]) for o in obs])) for k in obs[0]})
    return st, port_params, ob


@pytest.mark.parametrize("M", [1, 6, 16])
def test_batched_call_equals_per_lane_calls(M):
    """One (S, M) call, heterogeneous physics per lane, equals S (M,)
    calls bit for bit, and the reference's vmapped batched step."""
    rng = np.random.default_rng(31 + M)
    draws = [_draw(rng, M) for _ in range(48)]
    st, sp, ob = _stack_lanes(draws)
    assert sp.T.shape == (48,) and sp.p.shape == (48, M)
    s_b, d_b = batched_schedule_slot(st, sp, ob)
    for i, d in enumerate(draws):
        s_i, d_i = schedule_slot(*_port(*d))
        for f in d_i._fields:
            np.testing.assert_array_equal(_bits(getattr(d_b, f)[i]),
                                          _bits(getattr(d_i, f)), err_msg=f)
        for f in s_i._fields:
            np.testing.assert_array_equal(_bits(getattr(s_b, f)[i]),
                                          _bits(getattr(s_i, f)), err_msg=f)
    # the reference's vmap over stacked parameter rows
    ref_params = ref_queues.stack_system_params(
        [_ref(*d)[1] for d in draws])
    ref_state = ref_queues.QueueState(*(jnp.asarray(x.numpy()) for x in st))
    ref_obs = ref_sched.Observation(*(jnp.asarray(x.numpy()) for x in ob))
    _assert_same(_REF_BATCHED(ref_state, ref_params, ref_obs), (s_b, d_b))


def test_theta_variant_and_run_horizon():
    M, S, n = 6, 5, 7
    rng = np.random.default_rng(3)
    draws = [_draw(rng, M) for _ in range(S)]
    st, sp, ob = _stack_lanes(draws)
    theta = 0.5 * sp.E_cap
    for a, b in zip(batched_schedule_slot(st, sp, ob),
                    batched_schedule_slot_theta(st, sp, ob, theta)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(_bits(x), _bits(y))
    # run_horizon over n slots equals n schedule_slot calls, and the
    # reference's lax.scan
    state, ph, _ = draws[0]
    obs_seq = [_draw(rng, M)[2] for _ in range(n)]
    seq = Observation(**{k: torch.from_numpy(np.stack(
        [np.asarray(o[k]) for o in obs_seq])) for k in obs_seq[0]})
    s0, p0, _ = _port(state, ph, obs_seq[0])
    s_end, decs = run_horizon(s0, p0, seq)
    s = s0
    for k in range(n):
        s, d = schedule_slot(s, p0, Observation(*(x[k] for x in seq)))
        np.testing.assert_array_equal(_bits(decs.c[k]), _bits(d.c))
    for x, y in zip(s_end, s):
        np.testing.assert_array_equal(_bits(x), _bits(y))
    r_state, r_params, _ = _ref(state, ph, obs_seq[0])
    r_seq = ref_sched.Observation(*(jnp.asarray(x.numpy()) for x in seq))
    _assert_same(ref_sched.run_horizon(r_state, r_params, r_seq),
                 (s_end, decs))
