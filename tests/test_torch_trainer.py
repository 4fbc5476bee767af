"""The port's coded-training bridge held against the JAX package's.

Both trainers start from the same MLP weights (the reference's, carried
over with ``params_from_numpy``) and the same dataset bytes; epoch by
epoch the co-simulated outcomes must be equal and the parameters agree
within rtol 1e-5 / atol 1e-6 (float32 matrix products sum in another
order in the two frameworks).  A failed decode is the paper's no-op step:
the very same tensors, bit for bit.
"""
import math

import jax
import jax.experimental
import numpy as np
import pytest
import torch

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

from jax.flatten_util import ravel_pytree                         # noqa: E402

import repro.data.pipeline as ref_data                            # noqa: E402
import repro.models.mlp as ref_mlp                                # noqa: E402
import repro.optim.optimizers as ref_optim                        # noqa: E402
import repro.sim as ref_sim                                       # noqa: E402
import repro.train as ref_train                                   # noqa: E402

import repro_torch.data.pipeline as port_data                     # noqa: E402
import repro_torch.models.mlp as port_mlp                         # noqa: E402
import repro_torch.optim.optimizers as port_optim                 # noqa: E402
import repro_torch.sim as port_sim                                # noqa: E402
import repro_torch.train as port_train                            # noqa: E402

SCHEMES = ("two-stage", "cyclic", "fractional", "uncoded")
SCENARIO = "bursty-stragglers"
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)


def _np_params(dims, seed=0):
    return [{k: np.asarray(v) for k, v in layer.items()}
            for layer in ref_mlp.init_mlp(jax.random.PRNGKey(seed), dims)]


def _pair(scheme, dims, n, *, optimizer="adamw", spec_over=None):
    """(reference trainer, port trainer) from identical weights/data."""
    make_opt = {"adamw": lambda m: m.adamw(1e-3),
                "sgd_momentum": lambda m: m.sgd_momentum(1e-2)}[optimizer]
    dim, n_classes = dims[0], dims[-1]
    params = _np_params(dims)
    spec_r = ref_sim.scenario_spec(SCENARIO)
    spec_p = port_sim.scenario_spec(SCENARIO)
    if spec_over:
        spec_r = spec_r.with_overrides(**spec_over)
        spec_p = spec_p.with_overrides(**spec_over)
    ref = ref_train.CodedTrainer(
        None, spec_r, scheme,
        ref_data.SyntheticClassificationDataset(6, n, dim, n_classes),
        make_opt(ref_optim),
        params=jax.tree.map(jax.numpy.asarray, params),
        loss_fn=ref_mlp.mlp_loss)
    port = port_train.CodedTrainer(
        None, spec_p, scheme,
        port_data.SyntheticClassificationDataset(6, n, dim, n_classes,
                                                 device="cpu"),
        make_opt(port_optim),
        params=port_mlp.params_from_numpy(params, device="cpu"),
        loss_fn=port_mlp.mlp_loss, device="cpu")
    return ref, port


def _flat(params):
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree.leaves(params)])


def _port_flat(params):
    return port_train.flatten_grads(params).numpy()


def _compare_run(ref, port, n_epochs):
    for epoch in range(n_epochs):
        lr, lp = ref.run_epoch(epoch), port.run_epoch(epoch)
        assert (lr.decode_ok, lr.n_slots, lr.time, lr.compute_time,
                lr.comm_time) == (lp.decode_ok, lp.n_slots, lp.time,
                                  lp.compute_time, lp.comm_time)
        assert lr.grad_bytes == lp.grad_bytes
        assert (lp.n_uploads > 0) == lp.decode_ok
        np.testing.assert_allclose(lp.loss, lr.loss, rtol=1e-5)
        if lr.decode_ok:
            np.testing.assert_allclose(port.last_decoded, ref.last_decoded,
                                       rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(port.last_decoded,
                                       port.last_full_grad, rtol=2e-4,
                                       atol=2e-4)
        np.testing.assert_allclose(_port_flat(port.params),
                                   _flat(ref.params), **PARAM_TOL)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_small_mlp_trains_like_the_reference(scheme):
    ref, port = _pair(scheme, (32, 32, 4), 16)
    _compare_run(ref, port, 3)
    assert port.noop_steps == ref.noop_steps


def test_paper_mlp_two_stage_matches_reference():
    """The paper's width (784, 256, 128, 10): D = 235,146.

    Stepped with SGD-momentum: its update is linear in the gradient, so
    the decoded gradients' float32 agreement carries over to the params.
    AdamW's first step ``g/(|g|+eps)`` maps a gradient entry that cancels
    to ~1e-8 (f32 summation noise of both frameworks) onto an arbitrary
    value in [-1, 1]; at this width one such entry turns up per epoch.
    AdamW parity is held at the small width above and step by step in
    ``test_optimizer_steps_match_reference``."""
    ref, port = _pair("two-stage", (784, 256, 128, 10), 32,
                      optimizer="sgd_momentum")
    assert port.partition.D == ref.partition.D == 235146
    _compare_run(ref, port, 2)


def test_decode_failure_is_bit_identical_noop():
    ref, port = _pair("two-stage", (32, 32, 4), 8,
                      spec_over={"fault_prob": 1.0})
    params_before, opt_before = port.params, port.opt_state
    flat_before = _port_flat(port.params).copy()
    lr, lp = ref.run_epoch(0), port.run_epoch(0)
    assert not lp.decode_ok and not lr.decode_ok and math.isnan(lp.loss)
    assert port.noop_steps == 1 and port.last_decoded is None
    assert port.params is params_before and port.opt_state is opt_before
    np.testing.assert_array_equal(_port_flat(port.params), flat_before)
    assert lp.time == lr.time > 0.0


# --------------------------------------------------------------------- #
# the pieces: flatten order, loss, optimizer, dataset bytes
# --------------------------------------------------------------------- #
def test_flatten_follows_ravel_pytree_order():
    params = _np_params((784, 256, 128, 10))
    flat_ref, _ = ravel_pytree(jax.tree.map(jax.numpy.asarray, params))
    port = port_mlp.params_from_numpy(params, device="cpu")
    np.testing.assert_array_equal(port_train.flatten_grads(port).numpy(),
                                  np.asarray(flat_ref))
    part = port_train.GradPartition.from_params(port)
    back = part.unflatten(torch.from_numpy(np.array(flat_ref)))
    for a, b in zip(port_optim.tree_leaves(port),
                    port_optim.tree_leaves(back)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert part.payload_bytes == 4 * 235146
    assert part.grad_bytes() == pytest.approx(0.2243, abs=1e-4)


@pytest.mark.parametrize("seed", range(3))
def test_mlp_loss_and_grads_match_reference(seed):
    params = _np_params((32, 16, 4), seed)
    batch = ref_data.SyntheticClassificationDataset(
        6, 64, 32, 4, seed=seed).partition(1, 2)
    pbatch = port_data.SyntheticClassificationDataset(
        6, 64, 32, 4, seed=seed, device="cpu").partition(1, 2)
    np.testing.assert_array_equal(pbatch["x"].numpy(),
                                  np.asarray(batch["x"]))
    np.testing.assert_array_equal(pbatch["y"].numpy(),
                                  np.asarray(batch["y"]))
    assert pbatch["y"].dtype == torch.int32
    loss_r, g_r = jax.value_and_grad(ref_mlp.mlp_loss)(
        jax.tree.map(jax.numpy.asarray, params), batch)
    tp = port_mlp.params_from_numpy(params, device="cpu")
    loss_p, g_p = port_train.coded_trainer._value_and_grad(
        port_mlp.mlp_loss)(tp, pbatch)
    np.testing.assert_allclose(float(loss_p), float(loss_r), rtol=1e-6)
    np.testing.assert_allclose(port_train.flatten_grads(g_p).numpy(),
                               _flat(g_r), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        float(port_mlp.mlp_accuracy(tp, pbatch)),
        float(ref_mlp.mlp_accuracy(jax.tree.map(jax.numpy.asarray, params),
                                   batch)))


@pytest.mark.parametrize("name", ["adamw", "adamw_wd", "sgd_momentum"])
def test_optimizer_steps_match_reference(name):
    make = {"adamw": lambda m: m.adamw(1e-2),
            "adamw_wd": lambda m: m.adamw(1e-2, weight_decay=0.1),
            "sgd_momentum": lambda m: m.sgd_momentum(1e-2)}[name]
    rng = np.random.default_rng(4)
    params = _np_params((8, 6, 3))
    opt_r, opt_p = make(ref_optim), make(port_optim)
    pr = jax.tree.map(jax.numpy.asarray, params)
    pp = port_mlp.params_from_numpy(params, device="cpu")
    sr, sp = opt_r.init(pr), opt_p.init(pp)
    for _ in range(4):
        grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
                  for k, v in layer.items()} for layer in params]
        pr, sr = opt_r.update(jax.tree.map(jax.numpy.asarray, grads), sr, pr)
        before = _port_flat(pp).copy()
        new_pp, sp = opt_p.update(
            port_mlp.params_from_numpy(grads, device="cpu"), sp, pp)
        np.testing.assert_array_equal(_port_flat(pp), before)  # no in-place
        pp = new_pp
        np.testing.assert_allclose(_port_flat(pp), _flat(pr), **PARAM_TOL)
    assert int(sp.step) == int(sr.step) == 4


def test_clip_by_global_norm_matches_reference():
    params = _np_params((8, 6, 3))
    g_r, n_r = ref_optim.clip_by_global_norm(
        jax.tree.map(jax.numpy.asarray, params), 0.5)
    g_p, n_p = port_optim.clip_by_global_norm(
        port_mlp.params_from_numpy(params, device="cpu"), 0.5)
    np.testing.assert_allclose(float(n_p), float(n_r), rtol=1e-6)
    np.testing.assert_allclose(_port_flat(g_p), _flat(g_r), rtol=1e-6,
                               atol=1e-7)


def test_trainer_rejects_mismatched_dataset():
    spec = port_sim.scenario_spec(SCENARIO)
    bad = port_data.SyntheticClassificationDataset(spec.K + 1, 4, 8, 2,
                                                   device="cpu")
    with pytest.raises(ValueError, match="partitions"):
        port_train.CodedTrainer(None, spec, "two-stage", bad,
                                port_optim.adamw(1e-3),
                                params=port_mlp.init_mlp(dims=(8, 2),
                                                         device="cpu"),
                                loss_fn=port_mlp.mlp_loss, device="cpu")


def test_phase_timer_sees_every_phase():
    seen = []

    class Timer:
        def __init__(self, name, epoch):
            seen.append((name, epoch))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    spec = port_sim.scenario_spec(SCENARIO)
    tr = port_train.CodedTrainer(
        None, spec, "two-stage",
        port_data.SyntheticClassificationDataset(6, 4, 8, 2, device="cpu"),
        port_optim.adamw(1e-3),
        params=port_mlp.init_mlp(torch.Generator().manual_seed(0),
                                 dims=(8, 2), device="cpu"),
        loss_fn=port_mlp.mlp_loss, device="cpu", phase_timer=Timer)
    assert tr.run_epoch(0).decode_ok
    assert [n for n, _ in seen] == ["shard_grads", "cosim", "encode",
                                    "decode_reduce", "optimizer_step"]
