"""The coded-training bridge on the transformer, held against the JAX
package's, on the CPU.

Both trainers start from the reference's weights (carried over with
``params_from_numpy``) and see the same token bytes.  Epoch by epoch the
co-simulated outcomes must be equal.  Parameters are stepped with
SGD-momentum (AdamW's first step ``g/(|g|+eps)`` turns float32 noise in a
near-zero gradient entry into a move of up to ``lr``: ROADMAP.md, queue
3) and held to the reference's own conditioning: each leaf's distance
from the reference's parameters must be within ``ULP_FACTOR`` times the
distance that nudging every initial weight by one float32 ulp makes in
the reference's own run (see ``tests/test_torch_transformer.py``).
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

import repro.data.pipeline as ref_data                            # noqa: E402
import repro.models.transformer as ref_tf                         # noqa: E402
import repro.optim.optimizers as ref_optim                        # noqa: E402
import repro.sim as ref_sim                                       # noqa: E402
import repro.train as ref_train                                   # noqa: E402
from benchmarks import train_e2e as ref_e2e                       # noqa: E402
from repro.configs.base import ModelConfig as RefConfig           # noqa: E402

import repro_torch.data.pipeline as port_data                     # noqa: E402
import repro_torch.kernels.flash_attention.ops as fa_ops          # noqa: E402
import repro_torch.models.transformer as port_tf                  # noqa: E402
import repro_torch.optim.optimizers as port_optim                 # noqa: E402
import repro_torch.sim as port_sim                                # noqa: E402
import repro_torch.train as port_train                            # noqa: E402
from repro_torch.configs.stablelm_1_6b import FULL                # noqa: E402
from repro_torch.models.common import spec_leaves                 # noqa: E402
from repro_torch.train import e2e as port_e2e                     # noqa: E402

SCHEMES = ("two-stage", "cyclic", "fractional", "uncoded")
SCENARIO = "bursty-stragglers"
ULP_FACTOR, NORM_FLOOR = 10.0, 1e-6
REF_TINY = RefConfig(**{f.name: getattr(port_e2e.TINY, f.name)
                        for f in dataclasses.fields(port_e2e.TINY)})


def _ulp_nudge(tree, seed=0):
    rng = np.random.default_rng(seed)

    def nudge(x):
        x = np.asarray(x, np.float32)
        d = rng.integers(-1, 2, size=x.shape)
        return np.where(d > 0, np.nextafter(x, np.float32(np.inf)),
                        np.where(d < 0, np.nextafter(x, np.float32(-np.inf)),
                                 x)).astype(np.float32)
    return jax.tree.map(nudge, tree)


def _ref_trainer(scheme, params, grad_fn, n=2, seq_len=32):
    return ref_train.CodedTrainer(
        REF_TINY, ref_sim.scenario_spec(SCENARIO), scheme,
        ref_data.SyntheticLMDataset(6, n, seq_len, REF_TINY.vocab),
        ref_optim.sgd_momentum(1e-2),
        params=jax.tree.map(jax.numpy.asarray, params), grad_fn=grad_fn)


def _port_trainer(scheme, params, n=2, seq_len=32, **kw):
    cfg = port_e2e.TINY
    return port_train.CodedTrainer(
        cfg, port_sim.scenario_spec(SCENARIO), scheme,
        port_data.SyntheticLMDataset(6, n, seq_len, cfg.vocab, device="cpu"),
        port_optim.sgd_momentum(1e-2),
        params=port_tf.params_from_numpy(params, cfg, device="cpu"),
        device="cpu", **kw)


def _rel_dist(a, b, scale) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(scale), 1e-30))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_tiny_transformer_trains_like_the_reference(scheme):
    params = jax.tree.map(np.asarray, ref_tf.init_params(
        REF_TINY, jax.random.PRNGKey(0)))
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, batch: ref_tf.loss_fn(p, batch, REF_TINY)))
    ref = _ref_trainer(scheme, params, grad_fn)
    nudged = _ref_trainer(scheme, _ulp_nudge(params), grad_fn)
    port = _port_trainer(scheme, params)
    assert port.partition.D == ref.partition.D
    assert port.grad_bytes == ref.grad_bytes
    for epoch in range(2):
        lr, ln, lp = (ref.run_epoch(epoch), nudged.run_epoch(epoch),
                      port.run_epoch(epoch))
        assert (lr.decode_ok, lr.n_slots, lr.time, lr.compute_time,
                lr.comm_time) == (lp.decode_ok, lp.n_slots, lp.time,
                                  lp.compute_time, lp.comm_time)
        assert ln.decode_ok == lr.decode_ok
        assert (lp.n_uploads > 0) == lp.decode_ok
        np.testing.assert_allclose(lp.loss, lr.loss, rtol=1e-5)
        if lp.decode_ok:
            np.testing.assert_allclose(port.last_decoded.numpy(),
                                       port.last_full_grad.numpy(),
                                       rtol=1e-4, atol=1e-5)
        else:
            assert port.last_decoded is None and math.isnan(lp.loss)
        for a, b, c, p0 in zip(jax.tree.leaves(ref.params),
                               port_optim.tree_leaves(port.params),
                               jax.tree.leaves(nudged.params),
                               jax.tree.leaves(params)):
            moved = np.asarray(a, np.float64) - p0
            err = _rel_dist(a, b.numpy(), moved)
            sens = _rel_dist(a, c, moved)
            assert err <= ULP_FACTOR * sens + NORM_FLOOR, (epoch, err, sens)
    assert port.noop_steps == ref.noop_steps


def test_e2e_speedups_equal_the_reference():
    """The simulated clock is deterministic given the seeds: the smoke
    speedups (1.344x vs uncoded, 1.40x vs cyclic) come out equal."""
    ref = ref_e2e.run_benchmark(REF_TINY, n_seeds=5)
    params = jax.tree.map(np.asarray, ref_tf.init_params(
        REF_TINY, jax.random.PRNGKey(0)))
    port = port_e2e.run_benchmark(
        port_e2e.TINY, n_seeds=5, device="cpu",
        params=port_tf.params_from_numpy(params, port_e2e.TINY,
                                         device="cpu"))
    assert port["speedup_vs_uncoded"] == ref["speedup_vs_uncoded"]
    assert port["speedup_vs_cyclic"] == ref["speedup_vs_cyclic"]
    assert port["speedup_vs_uncoded"] == pytest.approx(1.3444444, abs=1e-6)
    assert port["speedup_vs_cyclic"] == pytest.approx(1.4, abs=1e-9)
    for key in ("param_dim", "grad_bytes_units", "n_seeds", "n_epochs"):
        assert port[key] == ref[key]
    # the benchmark steps with AdamW: its first step moves an entry whose
    # gradient cancels to float32 noise by up to lr, so the losses after
    # it agree to ~1e-4, not to float32 rounding (ROADMAP.md, queue 3)
    np.testing.assert_allclose(port["target_loss"], ref["target_loss"],
                               rtol=1e-3)
    for scheme in SCHEMES:
        r, p = ref["schemes"][scheme], port["schemes"][scheme]
        assert p["times_to_target"] == r["times_to_target"]
        assert p["noop_epochs"] == r["noop_epochs"]
        for cr, cp in zip(r["curves"], p["curves"]):
            assert cp["wall_clock"] == cr["wall_clock"]
            assert cp["decode_ok"] == cr["decode_ok"]


def test_e2e_with_its_own_init_gives_the_same_speedups():
    out = port_e2e.run_benchmark(port_e2e.TINY, n_seeds=2, device="cpu",
                                 schemes=("two-stage", "uncoded"))
    ref = ref_e2e.run_benchmark(REF_TINY, n_seeds=2,
                                schemes=("two-stage", "uncoded"))
    assert out["speedup_vs_uncoded"] == ref["speedup_vs_uncoded"]
    assert out["device"] == "cpu"


# --------------------------------------------------------------------- #
# the trainer's own contract
# --------------------------------------------------------------------- #
def test_default_model_is_the_cfg_transformer():
    cfg = port_e2e.TINY
    spec = port_sim.scenario_spec(SCENARIO)
    tr = port_train.CodedTrainer(
        cfg, spec, "two-stage",
        port_data.SyntheticLMDataset(6, 2, 16, cfg.vocab, device="cpu"),
        port_optim.adamw(1e-3), seed=3, device="cpu")
    D = sum(math.prod(s.shape) for s in spec_leaves(
        port_tf.model_specs(cfg)))
    assert tr.partition.D == D
    lg = tr.run_epoch(0)
    assert lg.decode_ok and np.isfinite(lg.loss)
    np.testing.assert_allclose(tr.last_decoded.numpy(),
                               tr.last_full_grad.numpy(), rtol=1e-4,
                               atol=1e-5)
    again = port_tf.init_params(cfg, torch.Generator().manual_seed(3),
                                device="cpu")
    tr2 = port_train.CodedTrainer(
        cfg, spec, "two-stage", tr.dataset, port_optim.adamw(1e-3), seed=3,
        device="cpu")
    for a, b in zip(port_optim.tree_leaves(tr2.params),
                    port_optim.tree_leaves(again)):
        assert torch.equal(a, b)


def test_without_cfg_the_model_must_be_given():
    spec = port_sim.scenario_spec(SCENARIO)
    data = port_data.SyntheticLMDataset(6, 1, 8, 16, device="cpu")
    with pytest.raises(ValueError, match="params"):
        port_train.CodedTrainer(None, spec, "two-stage", data,
                                port_optim.adamw(1e-3), device="cpu")


def test_shard_gradients_fill_rows_of_one_matrix():
    params = jax.tree.map(np.asarray, ref_tf.init_params(
        REF_TINY, jax.random.PRNGKey(1)))
    tr = _port_trainer("two-stage", params)
    losses, G = tr.shard_gradients(0)
    assert G.shape == (6, tr.partition.D) and G.dtype == torch.float32
    for k in range(6):
        loss, grads = tr._shard_grad(tr.params, tr.dataset.partition(0, k))
        assert float(loss) == float(losses[k])
        assert torch.equal(port_train.flatten_grads(grads), G[k])


def test_bytes_per_unit_sets_the_payload_scale():
    """Passing the payload's own bytes as the unit makes ``grad_bytes``
    1.0 in both trainers (the scale the scenarios were tuned for)."""
    params = jax.tree.map(np.asarray, ref_tf.init_params(
        REF_TINY, jax.random.PRNGKey(0)))
    D = sum(x.size for x in jax.tree.leaves(params))
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, batch: ref_tf.loss_fn(p, batch, REF_TINY)))
    ref = ref_train.CodedTrainer(
        REF_TINY, ref_sim.scenario_spec(SCENARIO), "uncoded",
        ref_data.SyntheticLMDataset(6, 1, 8, REF_TINY.vocab),
        ref_optim.adamw(1e-3), params=jax.tree.map(jax.numpy.asarray,
                                                   params),
        grad_fn=grad_fn, bytes_per_unit=4.0 * D)
    port = _port_trainer("uncoded", params, bytes_per_unit=4.0 * D)
    assert ref.grad_bytes == port.grad_bytes == 1.0
    assert port.spec.comm.grad_bytes == 1.0
    # stablelm-1.6b at full width, 4 layers, at the default 4 MiB a unit
    full4 = dataclasses.replace(FULL, n_layers=4)
    D4 = sum(math.prod(s.shape) for s in spec_leaves(
        port_tf.model_specs(full4)))
    assert D4 == 616_581_120
    assert port_train.payload_units(4.0 * D4) == pytest.approx(588.02,
                                                               abs=0.01)


def test_attention_calls_per_epoch_follow_the_remat_policy(monkeypatch):
    """What ``chip_smoke.py`` asserts of the kernel's launch counts, here
    on the plain version's calls: with ``remat="full"`` each layer's
    attention runs forward twice per shard (the forward, then the
    recompute in the backward) and backward once; without remat once
    each."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa_ops.flash_attention_fwd, fa_ops.flash_attention_bwd

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)
    monkeypatch.setattr(fa_ops, "flash_attention_fwd", count_fwd)
    monkeypatch.setattr(fa_ops, "flash_attention_bwd", count_bwd)
    spec = port_sim.scenario_spec(SCENARIO)
    for remat, fwd_per_layer in (("full", 2), ("none", 1)):
        cfg = dataclasses.replace(port_e2e.TINY, remat=remat)
        tr = port_train.CodedTrainer(
            cfg, spec, "two-stage",
            port_data.SyntheticLMDataset(6, 1, 16, cfg.vocab, device="cpu"),
            port_optim.adamw(1e-3), device="cpu")
        calls.update(fwd=0, bwd=0)
        tr.run_epoch(0)
        K, L = spec.K, cfg.n_layers
        assert calls == {"fwd": fwd_per_layer * K * L, "bwd": K * L}
