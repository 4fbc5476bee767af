"""The port's P4–P7 scheduler held against the JAX package's.

Both run float32; XLA may contract multiply-adds that torch rounds
separately, so states and decisions agree within rtol/atol 1e-6 rather
than bit for bit.  The P7 priority order is discrete and must be equal,
ties included (every worker with equal queues has equal w).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lyapunov import queues as ref_queues
from repro.core.lyapunov import scheduler as ref_sched

from repro_torch.core.lyapunov import (Observation, init_queues,
                                       make_system_params, schedule_slot)
from repro_torch.core.lyapunov.scheduler import _p7_knapsack

TOL = dict(rtol=1e-6, atol=1e-6)
_REF_STEP = jax.jit(ref_sched.schedule_slot)


def _physics(rng, M):
    return dict(T=float(rng.choice([0.1, 0.25])),
                p=float(rng.choice([0.5, 4.0])), delta=1e-3, xi=0.01,
                f_max=100.0, F=100.0, E_cap=float(rng.choice([1.0, 10.0])),
                V=float(rng.choice([5.0, 50.0])))


def _ref_params(M, ph):
    return ref_queues.SystemParams(
        T=jnp.asarray(ph["T"]), p=jnp.full((M,), ph["p"]),
        delta=jnp.full((M,), ph["delta"]), xi=jnp.full((M,), ph["xi"]),
        f_max=jnp.full((M,), ph["f_max"]), F=jnp.asarray(ph["F"]),
        E_cap=jnp.full((M,), ph["E_cap"]), V=jnp.asarray(ph["V"]),
        lam=jnp.ones((M,)))


def _w(Q, E, R_server, r, p, xi, theta):
    return Q * r + (E - theta) * p - R_server * xi * r


def _check_state(ref, port):
    for name in ("Q", "H", "E", "R", "R_server"):
        np.testing.assert_allclose(np.asarray(getattr(ref, name)),
                                   getattr(port, name).numpy(), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("block", range(10))
def test_schedule_slot_matches_reference(block):
    """200 random observation sequences (20 per case), 12 slots each."""
    for seq in range(20):
        rng = np.random.default_rng(1000 * block + seq)
        M = int(rng.integers(2, 9))
        E0 = float(rng.uniform(0.0, 5.0))
        ph = _physics(rng, M)
        p_ref = _ref_params(M, ph)
        p_port = make_system_params(M, device="cpu", **ph)
        s_ref = ref_queues.init_queues(M, E0=E0)
        s_port = init_queues(M, E0=E0, device="cpu")
        L = float(rng.choice([1.0, 2.0]))
        for _ in range(12):
            D = np.where(rng.random(M) < 0.4,
                         rng.uniform(0, 2, M), 0.0).astype(np.float32)
            r = rng.choice([0.25, 1.5, 4.0, 6.0], size=M).astype(np.float32)
            E_H = rng.uniform(0.0, 1.0, M).astype(np.float32)
            # the P7 order at this state, before stepping
            th_r = 0.5 * p_ref.E_cap
            w_r = _w(s_ref.Q, s_ref.E, s_ref.R_server, jnp.asarray(r),
                     p_ref.p, p_ref.xi, th_r)
            th_p = 0.5 * p_port.E_cap
            w_p = _w(s_port.Q, s_port.E, s_port.R_server,
                     torch.from_numpy(r), p_port.p, p_port.xi, th_p)
            np.testing.assert_array_equal(
                np.asarray(jnp.argsort(-w_r)),
                torch.argsort(-w_p, stable=True).numpy())

            s_ref, d_ref = _REF_STEP(s_ref, p_ref, ref_sched.Observation(
                D=jnp.asarray(D), r=jnp.asarray(r), E_H=jnp.asarray(E_H),
                L=jnp.asarray(L, jnp.float32), new_cycles=jnp.zeros((M,))))
            s_port, d_port = schedule_slot(s_port, p_port, Observation(
                D=torch.from_numpy(D), r=torch.from_numpy(r),
                E_H=torch.from_numpy(E_H),
                L=torch.tensor(L, dtype=torch.float32),
                new_cycles=torch.zeros(M)))
            for f in d_ref._fields:
                np.testing.assert_allclose(np.asarray(getattr(d_ref, f)),
                                           getattr(d_port, f).numpy(), **TOL,
                                           err_msg=f)
            _check_state(s_ref, s_port)
            assert all(x.dtype == torch.float32 for x in s_port)


def test_p7_ties_follow_index_order():
    """Idle workers all have w = (E−θ)·p: equal batteries tie, and the
    stable sort serves the lowest index first, as ``jnp.argsort`` does."""
    M = 6
    p = make_system_params(M, T=0.1, p=0.5, delta=1e-3, xi=0.0, f_max=1.0,
                           F=1.0, E_cap=10.0, V=50.0, device="cpu")
    Q = torch.full((M,), 5.0)
    E = torch.full((M,), 8.0)
    r = torch.full((M,), 1.0)
    nu = _p7_knapsack(Q, E, torch.tensor(0.0), r, torch.tensor(2.0), p,
                      0.5 * p.E_cap)
    # budget T·L = 0.2 at cap T = 0.1 per worker: the first two get it
    np.testing.assert_array_equal(nu.numpy(),
                                  np.array([0.1, 0.1, 0, 0, 0, 0],
                                           np.float32))


def test_queue_update_clips_like_the_reference():
    M = 4
    ph = dict(T=0.1, p=0.5, delta=1e-3, xi=0.01, f_max=100.0, F=100.0,
              E_cap=1.0, V=50.0)
    port = make_system_params(M, device="cpu", **ph)
    s = init_queues(M, E0=0.9, device="cpu")
    z = torch.zeros(M)
    big = torch.full((M,), 5.0)
    from repro_torch.core.lyapunov import step_queues
    out = step_queues(s, port, d=z, c=big, y=z, e_store=big, e_up=z,
                      e_com=z, f=big, new_cycles=z)
    ref = ref_queues.step_queues(
        ref_queues.init_queues(M, E0=0.9), _ref_params(M, ph),
        d=jnp.zeros(M), c=jnp.full(M, 5.0), y=jnp.zeros(M),
        e_store=jnp.full(M, 5.0), e_up=jnp.zeros(M), e_com=jnp.zeros(M),
        f=jnp.full(M, 5.0), new_cycles=jnp.zeros(M))
    _check_state(ref, out)
    assert float(out.E.max()) == 1.0 and float(out.Q.min()) == 0.0
