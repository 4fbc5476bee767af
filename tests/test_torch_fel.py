"""The paper's experiment in the port held against the JAX package's:
the train steps of ``core/coded_step.py``, the single-stage baseline epoch,
``per_slot_mlp_loss`` and ``FELTrainer`` on both epoch backends.

Both sides start from the reference's MLP weights (carried over with
``params_from_numpy``) and see the same dataset bytes.  Host outcomes
(numpy float64) must be equal; losses agree within rtol 1e-5 and
parameters within ``PARAM_TOL`` (float32 products sum in other orders in
the two frameworks).  Then the paper's claims C1–C3 for the port on its
own, as ``tests/test_coded_training.py`` states them for the reference.
"""
import dataclasses
import math

import jax
import jax.experimental
import numpy as np
import pytest
import torch

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

import repro.core.coded_step as ref_step                          # noqa: E402
import repro.core.coding as ref_coding                            # noqa: E402
import repro.core.fel as ref_fel                                  # noqa: E402
import repro.core.runtime as ref_runtime                          # noqa: E402
import repro.data.pipeline as ref_data                            # noqa: E402
import repro.models.mlp as ref_mlp                                # noqa: E402
import repro.optim.optimizers as ref_optim                        # noqa: E402
import repro.sim as ref_sim                                       # noqa: E402

import repro_torch.core as port_core                              # noqa: E402
import repro_torch.core.coding as port_coding                     # noqa: E402
import repro_torch.core.runtime as port_runtime                   # noqa: E402
import repro_torch.data.pipeline as port_data                     # noqa: E402
import repro_torch.models.mlp as port_mlp                         # noqa: E402
import repro_torch.optim.optimizers as port_optim                 # noqa: E402
import repro_torch.sim as port_sim                                # noqa: E402
from repro_torch.core.fel import FELTrainer                       # noqa: E402

SCHEMES = ("two-stage", "cyclic", "fractional", "uncoded")
SCENARIO = "bursty-stragglers"
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
M, K, DIM, NCLS = 6, 6, 32, 4
RATES = np.array([2.0, 2.0, 4.0, 4.0, 8.0, 8.0])
HOST_FIELDS = ("epoch", "time", "utilization", "n_stragglers", "redundancy",
               "efficiency", "compute_time", "comm_time", "decode_ok")


def _np_params(dims, seed=0):
    return [{k: np.asarray(v) for k, v in layer.items()}
            for layer in ref_mlp.init_mlp(jax.random.PRNGKey(seed), dims)]


def _flat_ref(tree):
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree.leaves(tree)])


def _flat_port(tree):
    return np.concatenate([x.detach().numpy().ravel()
                           for x in port_optim.tree_leaves(tree)])


def _capturing(opt, seen):
    """``opt`` that records each gradient tree it is given."""
    def update(grads, state, params):
        seen.append(grads)
        return opt.update(grads, state, params)
    return type(opt)(init=opt.init, update=update)


OPTS = {"sgd_momentum": lambda m: m.sgd_momentum(0.05),
        "adamw": lambda m: m.adamw(1e-2, weight_decay=0.01)}


# --------------------------------------------------------------------- #
# the train steps
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("variant", ["plain", "clip", "identity_transform"])
@pytest.mark.parametrize("opt_name", sorted(OPTS))
def test_make_train_step_matches_reference(opt_name, variant):
    kw = {"plain": {}, "clip": {"clip_norm": 0.5},
          "identity_transform": {"grad_transform": lambda g: g,
                                 "clip_norm": 0.5}}[variant]
    params = _np_params((DIM, 16, NCLS), seed=3)
    seen_r, seen_p = [], []
    step_r = ref_step.make_train_step(
        ref_mlp.mlp_loss, _capturing(OPTS[opt_name](ref_optim), seen_r), **kw)
    step_p = port_core.make_train_step(
        port_mlp.mlp_loss, _capturing(OPTS[opt_name](port_optim), seen_p),
        **kw)
    pr = jax.tree.map(jax.numpy.asarray, params)
    pp = port_mlp.params_from_numpy(params, device="cpu")
    state_r = OPTS[opt_name](ref_optim).init(pr)
    state_p = OPTS[opt_name](port_optim).init(pp)
    ds_r = ref_data.SyntheticClassificationDataset(2, 32, DIM, NCLS, seed=1)
    ds_p = port_data.SyntheticClassificationDataset(2, 32, DIM, NCLS, seed=1,
                                                    device="cpu")
    for epoch in range(3):
        pr, state_r, aux_r = step_r(pr, state_r, ds_r.partition(epoch, 1))
        pp, state_p, aux_p = step_p(pp, state_p, ds_p.partition(epoch, 1))
        np.testing.assert_allclose(float(aux_p["loss"]),
                                   float(aux_r["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(aux_p["grad_norm"]),
                                   float(aux_r["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(_flat_port(seen_p[-1]),
                                   _flat_ref(seen_r[-1]), **PARAM_TOL)
        np.testing.assert_allclose(_flat_port(pp), _flat_ref(pr),
                                   **PARAM_TOL)
    assert int(state_p.step) == int(state_r.step) == 3


def _slot_data(rng, Ms, S, n):
    x = rng.standard_normal((Ms, S, n, DIM)).astype(np.float32)
    y = rng.integers(0, NCLS, (Ms, S, n)).astype(np.int32)
    return x, y


@pytest.mark.parametrize("opt_name", sorted(OPTS))
def test_make_coded_train_step_matches_reference(opt_name):
    rng = np.random.default_rng(11)
    params = _np_params((DIM, 16, NCLS), seed=5)
    seen_r, seen_p = [], []
    step_r = ref_step.make_coded_train_step(
        ref_mlp.per_slot_mlp_loss, _capturing(OPTS[opt_name](ref_optim),
                                              seen_r))
    step_p = port_core.make_coded_train_step(
        port_mlp.per_slot_mlp_loss, _capturing(OPTS[opt_name](port_optim),
                                               seen_p))
    pr = jax.tree.map(jax.numpy.asarray, params)
    pp = port_mlp.params_from_numpy(params, device="cpu")
    state_r = OPTS[opt_name](ref_optim).init(pr)
    state_p = OPTS[opt_name](port_optim).init(pp)
    for _ in range(3):
        x, y = _slot_data(rng, M, 3, 8)
        w = rng.standard_normal((M, 3))
        w[rng.random((M, 3)) < 0.3] = 0.0
        pr, state_r, aux_r = step_r(
            pr, state_r,
            {"x": jax.numpy.asarray(x), "y": jax.numpy.asarray(y)},
            jax.numpy.asarray(w, jax.numpy.float32))
        pp, state_p, aux_p = step_p(
            pp, state_p, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
            torch.as_tensor(w, dtype=torch.float32))
        np.testing.assert_allclose(float(aux_p["loss"]),
                                   float(aux_r["loss"]), rtol=1e-5)
        np.testing.assert_allclose(_flat_port(seen_p[-1]),
                                   _flat_ref(seen_r[-1]), **PARAM_TOL)
        np.testing.assert_allclose(_flat_port(pp), _flat_ref(pr),
                                   **PARAM_TOL)


def test_per_slot_mlp_loss_matches_reference():
    rng = np.random.default_rng(2)
    params = _np_params((DIM, 32, NCLS), seed=1)
    x, y = _slot_data(rng, M, 5, 12)
    got = port_mlp.per_slot_mlp_loss(
        port_mlp.params_from_numpy(params, device="cpu"),
        {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    want = ref_mlp.per_slot_mlp_loss(
        jax.tree.map(jax.numpy.asarray, params),
        {"x": jax.numpy.asarray(x), "y": jax.numpy.asarray(y)})
    assert tuple(got.shape) == (M, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# --------------------------------------------------------------------- #
# the single-stage baseline epoch
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("fault_prob", [0.0, 0.2])
@pytest.mark.parametrize("scheme", ["cyclic", "fractional", "uncoded"])
def test_simulate_epoch_single_stage_is_bit_equal(scheme, fault_prob):
    static_r = ref_coding.build_static_scheme(scheme, M, K, 1)
    static_p = port_coding.build_static_scheme(scheme, M, K, 1)
    tm_r = ref_runtime.CompletionTimeModel(RATES, 0.4, fault_prob, 0.2, 8.0)
    tm_p = port_runtime.CompletionTimeModel(RATES, 0.4, fault_prob, 0.2, 8.0)
    rng_r, rng_p = np.random.default_rng(3), np.random.default_rng(3)
    n_failed = 0
    for epoch in range(30):
        wait_for = None if epoch % 3 else M - 2
        a = ref_runtime.simulate_epoch_single_stage(static_r, tm_r, rng_r,
                                                    wait_for)
        b = port_runtime.simulate_epoch_single_stage(static_p, tm_p, rng_p,
                                                     wait_for)
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(np.asarray(b[key]),
                                          np.asarray(a[key]), err_msg=key)
            assert type(b[key]) is type(a[key]), key
        n_failed += not b["ok"]
    assert rng_r.bit_generator.state == rng_p.bit_generator.state
    if fault_prob:
        assert n_failed > 0          # the failure branch was taken


# --------------------------------------------------------------------- #
# FELTrainer against the reference's
# --------------------------------------------------------------------- #
def _pair(scheme, backend, dims=(DIM, 32, NCLS), n=16, seed=3, lr=0.05):
    """(reference trainer, port trainer) from identical weights/data."""
    params = _np_params(dims)
    dim, ncls = dims[0], dims[-1]
    ds_r = ref_data.SyntheticClassificationDataset(K, n, dim, ncls, seed=7)
    ds_p = port_data.SyntheticClassificationDataset(K, n, dim, ncls, seed=7,
                                                    device="cpu")
    if backend == "cluster":
        kw_r = dict(cluster=ref_sim.scenario_spec(SCENARIO))
        kw_p = dict(cluster=port_sim.scenario_spec(SCENARIO))
    else:
        kw_r = kw_p = dict(M1=4, s=1, rates=RATES, noise_scale=0.3,
                           fault_prob=0.1, straggler_prob=0.2)
    ref = ref_fel.FELTrainer(scheme, M, K, ds_r, ref_mlp.per_slot_mlp_loss,
                             ref_optim.sgd_momentum(lr),
                             jax.tree.map(jax.numpy.asarray, params),
                             seed=seed, **kw_r)
    port = FELTrainer(scheme, M, K, ds_p, port_mlp.per_slot_mlp_loss,
                      port_optim.sgd_momentum(lr),
                      port_mlp.params_from_numpy(params, device="cpu"),
                      seed=seed, device="cpu", **kw_p)
    return ref, port


def _compare_logs(lr, lp):
    for f in HOST_FIELDS:
        a, b = getattr(lr, f), getattr(lp, f)
        assert a == b and type(a) is type(b), (f, a, b)
    assert math.isnan(lr.loss) == math.isnan(lp.loss)
    assert math.isnan(lp.loss) == (not lp.decode_ok)
    if lp.decode_ok:
        np.testing.assert_allclose(lp.loss, lr.loss, rtol=1e-5)


@pytest.mark.parametrize("backend", ["instant", "cluster"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_fel_trainer_matches_reference(scheme, backend):
    ref, port = _pair(scheme, backend)
    assert (port.n_slots, port.s) == (ref.n_slots, ref.s)
    for epoch in range(3):
        _compare_logs(ref.run_epoch(epoch), port.run_epoch(epoch))
        np.testing.assert_allclose(_flat_port(port.params),
                                   _flat_ref(ref.params), **PARAM_TOL)
    assert [dataclasses.asdict(x)["epoch"] for x in port.logs] == [0, 1, 2]


@pytest.mark.parametrize("backend", ["instant", "cluster"])
def test_fel_trainer_at_the_paper_widths(backend):
    """D = 235,146; SGD-momentum at lr 1e-2, as
    ``tests/test_torch_trainer.py::test_paper_mlp_two_stage_matches_reference``
    (the loss is a sum of six partitions' CE, so float32 summation-order
    differences move each step by lr times the gradient's rounding)."""
    ref, port = _pair("two-stage", backend, dims=(784, 256, 128, 10), n=16,
                      lr=1e-2)
    for epoch in range(3):
        _compare_logs(ref.run_epoch(epoch), port.run_epoch(epoch))
        np.testing.assert_allclose(_flat_port(port.params),
                                   _flat_ref(ref.params), **PARAM_TOL)


def test_fel_failed_decode_logs_nan_like_the_reference():
    """fault_prob 1: no worker returns, every decode fails; the step runs
    on all-zero weights, as the reference's does."""
    params = _np_params((DIM, 16, NCLS))
    kw = dict(M1=4, s=1, rates=RATES, noise_scale=0.3, fault_prob=1.0)
    for scheme in ("two-stage", "cyclic"):
        ref = ref_fel.FELTrainer(
            scheme, M, K, ref_data.SyntheticClassificationDataset(
                K, 8, DIM, NCLS), ref_mlp.per_slot_mlp_loss,
            ref_optim.sgd_momentum(0.05),
            jax.tree.map(jax.numpy.asarray, params), **kw)
        port = FELTrainer(
            scheme, M, K, port_data.SyntheticClassificationDataset(
                K, 8, DIM, NCLS, device="cpu"), port_mlp.per_slot_mlp_loss,
            port_optim.sgd_momentum(0.05),
            port_mlp.params_from_numpy(params, device="cpu"), device="cpu",
            **kw)
        before = _flat_port(port.params).copy()
        for epoch in range(2):
            lr, lp = ref.run_epoch(epoch), port.run_epoch(epoch)
            assert not lp.decode_ok
            _compare_logs(lr, lp)
        np.testing.assert_array_equal(_flat_port(port.params), before)


def _errors(make):
    try:
        make()
    except Exception as e:               # noqa: BLE001 (compared below)
        return type(e), str(e)
    return None


@pytest.mark.parametrize("case", ["physics_kwargs", "M_K", "scheme",
                                  "not_a_cluster"])
def test_fel_constructor_raises_like_the_reference(case):
    params = _np_params((DIM, 16, NCLS))

    def make(side):
        if side == "ref":
            sim, fel, data, opt, loss = (ref_sim, ref_fel.FELTrainer,
                                         ref_data, ref_optim,
                                         ref_mlp.per_slot_mlp_loss)
            p = jax.tree.map(jax.numpy.asarray, params)
            dkw, tkw, ckw = {}, {}, {}
        else:
            sim, fel, data, opt, loss = (port_sim, FELTrainer, port_data,
                                         port_optim,
                                         port_mlp.per_slot_mlp_loss)
            p = port_mlp.params_from_numpy(params, device="cpu")
            dkw, tkw, ckw = ({"device": "cpu"},) * 3
        spec = sim.scenario_spec(SCENARIO)
        Mc, Kc, scheme, kw = M, K, "two-stage", {}
        if case == "physics_kwargs":
            kw = dict(cluster=spec, noise_scale=0.1, M1=3)
        elif case == "M_K":
            Kc = K + 1
            kw = dict(cluster=sim.build_cluster(spec, "two-stage", 0, **ckw))
        elif case == "scheme":
            kw = dict(cluster=sim.build_cluster(spec, "cyclic", 0, **ckw))
        else:
            kw = dict(cluster="bursty-stragglers")
        return lambda: fel(scheme, Mc, Kc, data.SyntheticClassificationDataset(
            Kc, 4, DIM, NCLS, **dkw), loss, opt.sgd_momentum(0.05), p,
            **kw, **tkw)

    got, want = _errors(make("port")), _errors(make("ref"))
    assert want is not None and got == want


# --------------------------------------------------------------------- #
# the paper's claims C1–C3, in the port alone
# --------------------------------------------------------------------- #
def _trainer(scheme, seed=0, fault_prob=0.0, noise=0.3, s=1,
             straggler_prob=0.0):
    ds = port_data.SyntheticClassificationDataset(
        K, examples_per_partition=16, dim=DIM, n_classes=NCLS, seed=7,
        device="cpu")
    return FELTrainer(scheme, M, K, ds, port_mlp.per_slot_mlp_loss,
                      port_optim.sgd_momentum(lr=0.05),
                      port_mlp.params_from_numpy(_np_params((DIM, 32, NCLS)),
                                                 device="cpu"),
                      M1=4, s=s, rates=RATES, noise_scale=noise,
                      fault_prob=fault_prob, straggler_prob=straggler_prob,
                      seed=seed, device="cpu")


@pytest.mark.parametrize("scheme", ["two-stage", "cyclic", "fractional"])
def test_c1_trajectory_matches_uncoded(scheme):
    ref = _trainer("uncoded", noise=0.0)       # nobody straggles
    ref.run(5)
    coded = _trainer(scheme, seed=3, noise=0.5)  # stragglers dropped freely
    logs = coded.run(5)
    assert all(lg.decode_ok for lg in logs)
    assert sum(lg.n_stragglers for lg in logs) > 0
    np.testing.assert_allclose(_flat_port(coded.params),
                               _flat_port(ref.params), **PARAM_TOL)


def test_c1_two_stage_exact_under_faults():
    ref = _trainer("uncoded", noise=0.0)
    ref.run(4)
    coded = _trainer("two-stage", seed=5, noise=0.4, fault_prob=0.1)
    assert all(lg.decode_ok for lg in coded.run(4))
    np.testing.assert_allclose(_flat_port(coded.params),
                               _flat_port(ref.params), **PARAM_TOL)


def test_c2_two_stage_faster_than_uncoded_with_stragglers():
    kw = dict(noise=0.2, straggler_prob=0.25)
    two, unc = _trainer("two-stage", seed=11, **kw), \
        _trainer("uncoded", seed=11, **kw)
    two.run(30)
    unc.run(30)
    t_two = np.mean([lg.time for lg in two.logs[5:]])
    t_unc = np.mean([lg.time for lg in unc.logs[5:]])
    assert t_two < t_unc, (t_two, t_unc)


def test_c3_two_stage_lower_redundancy_than_static_coding():
    two, cyc = _trainer("two-stage", seed=2, noise=0.2), \
        _trainer("cyclic", seed=2, noise=0.2)
    two.run(10)
    cyc.run(10)
    red_two = np.mean([lg.redundancy for lg in two.logs])
    red_cyc = np.mean([lg.redundancy for lg in cyc.logs])
    assert red_two < red_cyc, (red_two, red_cyc)
    assert red_cyc == pytest.approx(2.0)


def test_training_actually_learns():
    tr = _trainer("two-stage", seed=1, noise=0.3)
    test_batch = tr.dataset.partition(999, 0)
    acc0 = float(port_mlp.mlp_accuracy(tr.params, test_batch))
    tr.run(30)
    acc1 = float(port_mlp.mlp_accuracy(tr.params, test_batch))
    losses = [lg.loss for lg in tr.logs]
    assert losses[-1] < losses[0]
    assert acc1 > max(acc0, 0.5), (acc0, acc1)


def test_phase_timer_sees_every_phase():
    seen = []

    class Timer:
        def __init__(self, name, epoch):
            seen.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    tr = _trainer("two-stage")
    tr._phase_timer = Timer
    tr.run_epoch(0)
    assert seen == ["plan", "draw", "stack", "copy", "step"]
