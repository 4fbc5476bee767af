"""The port's dense transformer against the JAX package's, on the CPU.

The reference's weights are carried across with ``params_from_numpy``
and both models see the same token batch (``SyntheticLMDataset`` draws
the same numpy bytes in both).  The loss must agree to rtol 1e-6.

Gradients are held to the reference's own conditioning.  Both compute in
float32 and round differently at every step, and at these random inits
the gradient is ill-conditioned: moving every weight by at most one
float32 ulp changes the reference's own gradient by up to 1e-4 (2e-4 with
a local window) in norm, leaf by leaf.  So each leaf's relative distance
(2-norm) from the reference's gradient must be within
``ULP_FACTOR`` times the change that such a one-ulp nudge makes to the
reference's gradient of that leaf, plus ``NORM_FLOOR``.  A wrong formula
moves a gradient by O(1) and fails by orders of magnitude.  The full-size
config is checked for shapes and flatten order only, without allocating
it.
"""
import dataclasses
import importlib

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

from jax.flatten_util import ravel_pytree                         # noqa: E402

import repro.configs.stablelm_1_6b as ref_stablelm                # noqa: E402
import repro.configs.base as ref_configs                          # noqa: E402
import repro.data.batches as ref_batches                          # noqa: E402
import repro.data.pipeline as ref_data                            # noqa: E402
import repro.models.common as ref_common                          # noqa: E402
import repro.models.transformer as ref_tf                         # noqa: E402
import repro.train.curves as ref_curves                           # noqa: E402
from repro.configs.base import ModelConfig as RefConfig           # noqa: E402

import repro_torch.configs as port_configs                        # noqa: E402
import repro_torch.configs.stablelm_1_6b as port_stablelm         # noqa: E402
import repro_torch.data.batches as port_batches                  # noqa: E402
import repro_torch.data.pipeline as port_data                     # noqa: E402
import repro_torch.models.common as port_common                   # noqa: E402
import repro_torch.models.transformer as port_tf                  # noqa: E402
import repro_torch.train.curves as port_curves                    # noqa: E402
from repro_torch.configs.base import ModelConfig as PortConfig    # noqa: E402
from repro_torch.optim.optimizers import tree_leaves              # noqa: E402
from repro_torch.train import GradPartition, flatten_grads        # noqa: E402
from repro_torch.train.coded_trainer import _value_and_grad       # noqa: E402
from repro_torch.train.e2e import TINY                            # noqa: E402

LOSS_RTOL = 1e-6
ULP_FACTOR, NORM_FLOOR = 10.0, 1e-5


def _configs(**over):
    """(reference cfg, port cfg) of the same fields."""
    fields = {f.name: getattr(TINY, f.name)
              for f in dataclasses.fields(TINY)}
    fields.update(over)
    return RefConfig(**fields), PortConfig(**fields)


def _reduced():
    over = dict(remat="none", compute_dtype="float32")
    return (dataclasses.replace(ref_stablelm.REDUCED, **over),
            dataclasses.replace(port_stablelm.REDUCED, **over))


def _ulp_nudge(tree, seed=0):
    """Every float32 leaf moved by -1, 0 or +1 ulp, entry by entry."""
    rng = np.random.default_rng(seed)

    def nudge(x):
        x = np.asarray(x, np.float32)
        d = rng.integers(-1, 2, size=x.shape)
        return np.where(d > 0, np.nextafter(x, np.float32(np.inf)),
                        np.where(d < 0, np.nextafter(x, np.float32(-np.inf)),
                                 x)).astype(np.float32)
    return jax.tree.map(nudge, tree)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _loss_and_grads(rcfg, pcfg, seq_len=32, n=2, seed=0):
    """(reference loss, grads), (port loss, grads) and the reference's
    grads at the one-ulp-nudged weights."""
    params = jax.tree.map(np.asarray,
                          ref_tf.init_params(rcfg, jax.random.PRNGKey(seed)))
    batch = ref_data.SyntheticLMDataset(6, n, seq_len, rcfg.vocab,
                                        seed=seed).partition(1, 3)
    pbatch = port_data.SyntheticLMDataset(6, n, seq_len, pcfg.vocab,
                                          seed=seed,
                                          device="cpu").partition(1, 3)
    return _batch_loss_and_grads(rcfg, pcfg, params, batch, pbatch)


def _batch_loss_and_grads(rcfg, pcfg, params, batch, pbatch):
    ref_grad = jax.jit(jax.value_and_grad(
        lambda p: ref_tf.loss_fn(p, batch, rcfg)))
    loss_r, g_r = ref_grad(params)
    _, g_nudged = ref_grad(_ulp_nudge(params))
    tp = port_tf.params_from_numpy(params, pcfg, device="cpu")
    loss_p, g_p = _value_and_grad(
        lambda p, b: port_tf.loss_fn(p, b, pcfg))(tp, pbatch)
    return (loss_r, g_r), (loss_p, g_p), g_nudged


def _assert_grads_close(g_r, g_p, g_nudged):
    ref_leaves = jax.tree_util.tree_flatten_with_path(g_r)[0]
    port_leaves = tree_leaves(g_p)
    assert len(ref_leaves) == len(port_leaves)
    for (path, a), b, c in zip(ref_leaves, port_leaves,
                               jax.tree.leaves(g_nudged)):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32
        err, sens = _rel(a, b.numpy()), _rel(a, c)
        assert err <= ULP_FACTOR * sens + NORM_FLOOR, \
            (jax.tree_util.keystr(path), err, sens)


@pytest.mark.parametrize("variant", [
    {}, {"remat": "full"}, {"remat": "dots"},
    {"n_kv_heads": 1, "qk_norm": True},            # GQA, G = 2
    {"layer_pattern": ("local", "attn"), "window": 8,
     "rope_theta_local": 500.0},
    {"gated_ffn": False, "act": "gelu", "norm": "layer"},
    {"tie_embeddings": True},
])
def test_tiny_loss_and_every_grad_leaf_match_reference(variant):
    rcfg, pcfg = _configs(**variant)
    (loss_r, g_r), (loss_p, g_p), g_nudged = _loss_and_grads(rcfg, pcfg)
    np.testing.assert_allclose(float(loss_p), float(loss_r), rtol=LOSS_RTOL)
    _assert_grads_close(g_r, g_p, g_nudged)


def test_reduced_stablelm_loss_and_grads_match_reference():
    rcfg, pcfg = _reduced()
    (loss_r, g_r), (loss_p, g_p), g_nudged = _loss_and_grads(rcfg, pcfg,
                                                             seq_len=64)
    np.testing.assert_allclose(float(loss_p), float(loss_r), rtol=LOSS_RTOL)
    _assert_grads_close(g_r, g_p, g_nudged)


def test_forward_hidden_matches_reference():
    """The final hidden states, held like the gradients: within
    ``ULP_FACTOR`` times what a one-ulp nudge of the weights moves the
    reference's own (about 1e-5 in norm here)."""
    rcfg, pcfg = _reduced()
    params = jax.tree.map(np.asarray,
                          ref_tf.init_params(rcfg, jax.random.PRNGKey(1)))
    batch = ref_data.SyntheticLMDataset(6, 2, 48, rcfg.vocab).partition(0, 0)
    x_r, aux_r, _ = ref_tf.forward(params, batch, rcfg)
    x_nudged, _, _ = ref_tf.forward(_ulp_nudge(params), batch, rcfg)
    tp = port_tf.params_from_numpy(params, pcfg, device="cpu")
    pbatch = port_data.SyntheticLMDataset(6, 2, 48, pcfg.vocab,
                                          device="cpu").partition(0, 0)
    x_p, aux_p = port_tf.forward(tp, pbatch, pcfg)
    assert x_p.shape == x_r.shape and x_p.dtype == torch.float32
    assert _rel(x_r, x_p.numpy()) <= \
        ULP_FACTOR * _rel(x_r, x_nudged) + NORM_FLOOR
    assert float(aux_p) == float(aux_r) == 0.0


# --------------------------------------------------------------------- #
# the full-width config: shapes and flatten order only
# --------------------------------------------------------------------- #
def _ref_spec_leaves(cfg):
    specs = ref_tf.model_specs(cfg)
    with_path = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, ref_common.Spec))[0]
    return [(jax.tree_util.keystr(p), tuple(s.shape), s.init, s.scale)
            for p, s in with_path]


@pytest.mark.parametrize("n_layers", [24, 4])
def test_full_stablelm_specs_and_flatten_order_match_reference(n_layers):
    rcfg = dataclasses.replace(ref_stablelm.FULL, n_layers=n_layers)
    pcfg = dataclasses.replace(port_stablelm.FULL, n_layers=n_layers)
    ref_leaves = _ref_spec_leaves(rcfg)
    port_leaves = port_common.spec_leaves(port_tf.model_specs(pcfg))
    assert [(s, i, c) for _, s, i, c in ref_leaves] == \
        [(tuple(s.shape), s.init, s.scale) for s in port_leaves]
    D = sum(int(np.prod(s)) for _, s, _, _ in ref_leaves)
    assert D == {24: 1_644_267_520, 4: 616_581_120}[n_layers]
    # the flattened layout: embed, final norm, the stacked layer leaves
    # (ffn before mixer, keys sorted), lm_head
    assert [p for p, *_ in ref_leaves][:3] == [
        "['embed']", "['final_norm']['w']",
        "['groups'][0]['l0']['ffn']['ln']['w']"]
    assert ref_leaves[-1][0] == "['lm_head']"


def test_flatten_order_of_carried_params_is_ravel_pytree():
    rcfg, pcfg = _configs(n_layers=3)
    params = ref_tf.init_params(rcfg, jax.random.PRNGKey(2))
    tp = port_tf.params_from_numpy(jax.tree.map(np.asarray, params), pcfg,
                                   device="cpu")
    flat_r = np.asarray(ravel_pytree(params)[0])
    np.testing.assert_array_equal(flatten_grads(tp).numpy(), flat_r)
    part = GradPartition.from_params(tp)
    assert part.D == flat_r.size
    back = part.unflatten(torch.from_numpy(flat_r.copy()))
    for a, b in zip(tree_leaves(tp), tree_leaves(back)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    row = torch.empty(part.D)
    np.testing.assert_array_equal(part.flatten_into(tp, row).numpy(), flat_r)


def test_params_from_numpy_checks_every_shape():
    rcfg, pcfg = _configs()
    params = jax.tree.map(np.asarray,
                          ref_tf.init_params(rcfg, jax.random.PRNGKey(0)))
    params["lm_head"] = params["lm_head"][:, :-1]
    with pytest.raises(ValueError, match="wants"):
        port_tf.params_from_numpy(params, pcfg, device="cpu")
    del params["lm_head"]
    with pytest.raises(ValueError, match="leaves"):
        port_tf.params_from_numpy(params, pcfg, device="cpu")


def test_init_params_follow_the_specs():
    _, pcfg = _configs()
    params = port_tf.init_params(pcfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    specs = port_common.spec_leaves(port_tf.model_specs(pcfg))
    for s, p in zip(specs, tree_leaves(params)):
        assert tuple(p.shape) == s.shape and p.dtype == torch.float32
        if s.init == "zeros":
            assert not p.any()
        elif s.init == "embed":
            assert float(p.abs().max()) <= 0.04 + 1e-7     # 2 sigma
    again = port_tf.init_params(pcfg, torch.Generator().manual_seed(0),
                                device="cpu")
    for a, b in zip(tree_leaves(params), tree_leaves(again)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("over", [
    {"n_experts": 4, "top_k": 1, "shared_expert": True},
    {"frontend": "vision", "n_patches": 8},
    {"n_experts": 4, "top_k": 2, "capacity_factor": 0.5},
    {"frontend": "audio", "causal": False},
])
def test_moe_and_frontend_layers_match_reference(over):
    """The MoE FFN (top-1 with a shared expert; top-2 with tokens dropped)
    and both frontends: the loss and every gradient leaf, held as the
    dense layers are."""
    rcfg, pcfg = _configs(**over)
    params = jax.tree.map(np.asarray,
                          ref_tf.init_params(rcfg, jax.random.PRNGKey(4)))
    batch = ref_batches.synthetic_batch(rcfg, 2, 32, "train", seed=4)
    pbatch = port_batches.synthetic_batch(pcfg, 2, 32, "train", seed=4,
                                          device="cpu")
    (loss_r, g_r), (loss_p, g_p), g_nudged = _batch_loss_and_grads(
        rcfg, pcfg, params, batch, pbatch)
    np.testing.assert_allclose(float(loss_p), float(loss_r), rtol=LOSS_RTOL)
    _assert_grads_close(g_r, g_p, g_nudged)


# --------------------------------------------------------------------- #
# the pieces: configs, common blocks, dataset bytes, curves
# --------------------------------------------------------------------- #
def test_configs_are_the_reference_s():
    # the reference's registry loads its modules only when it is empty
    # (ROADMAP.md section 3), so import all ten first
    for mod in ("llama4_maverick_400b_a17b", "granite_moe_3b_a800m",
                "recurrentgemma_2b", "internvl2_26b", "deepseek_67b",
                "gemma3_12b", "qwen3_14b", "stablelm_1_6b", "hubert_xlarge",
                "rwkv6_1_6b"):
        importlib.import_module(f"repro.configs.{mod}")
    archs = ref_configs.list_archs()
    assert len(archs) == 10
    assert port_configs.list_archs() == archs
    for arch in archs:
        for reduced in (False, True):
            r = dataclasses.asdict(ref_configs.get_config(arch,
                                                          reduced=reduced))
            p = dataclasses.asdict(port_configs.get_config(arch,
                                                           reduced=reduced))
            assert r == p
    assert port_configs.SHAPES["train_4k"].seq_len == 4096
    assert ref_tf.group_layout(ref_stablelm.FULL) == [] or [
        (g.kinds, g.n_repeat, g.first_layer)
        for g in ref_tf.group_layout(ref_stablelm.FULL)] == [
        (g.kinds, g.n_repeat, g.first_layer)
        for g in port_tf.group_layout(port_stablelm.FULL)]


@pytest.mark.parametrize("seed", range(3))
def test_norms_and_rope_match_reference(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 16, 3, 2, 8)).astype(np.float32)
    w = rng.standard_normal(8).astype(np.float32) * 0.1
    b = rng.standard_normal(8).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        port_common.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
        np.asarray(ref_common.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        port_common.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b)),
        np.asarray(ref_common.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(b))),
        rtol=1e-5, atol=1e-6)
    pos = np.arange(16)
    sin_p, cos_p = port_common.rope(torch.from_numpy(pos), 8, 10000.0)
    sin_r, cos_r = ref_common.rope(jnp.asarray(pos), 8, 10000.0)
    np.testing.assert_allclose(sin_p, np.asarray(sin_r), atol=1e-6)
    np.testing.assert_allclose(cos_p, np.asarray(cos_r), atol=1e-6)
    np.testing.assert_allclose(
        port_common.apply_rope(torch.from_numpy(x), sin_p, cos_p),
        np.asarray(ref_common.apply_rope(jnp.asarray(x), sin_r, cos_r)),
        rtol=1e-5, atol=1e-5)
    for name in ("silu", "gelu", "relu"):
        np.testing.assert_allclose(
            port_common.activation(name)(torch.from_numpy(x)),
            np.asarray(ref_common.activation(name)(jnp.asarray(x))),
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("epoch,k", [(0, 0), (1, 5), (3, 2)])
def test_lm_dataset_bytes_match_reference(epoch, k):
    ref = ref_data.SyntheticLMDataset(6, 3, 40, 97, seed=4).partition(
        epoch, k)
    port = port_data.SyntheticLMDataset(6, 3, 40, 97, seed=4,
                                        device="cpu").partition(epoch, k)
    for key in ("tokens", "labels", "weights"):
        assert port[key].dtype == {"weights": torch.float32}.get(
            key, torch.int32)
        np.testing.assert_array_equal(port[key].numpy(),
                                      np.asarray(ref[key]))


def test_curves_match_reference():
    from repro_torch.train import TrainEpochLog
    logs = [TrainEpochLog(epoch=i, loss=loss, time=t, compute_time=0.0,
                          comm_time=0.0, decode_ok=loss == loss, n_slots=1,
                          grad_bytes=1.0)
            for i, (loss, t) in enumerate([(3.0, 1.5), (float("nan"), 2.0),
                                           (2.5, 0.5), (2.7, 1.0)])]
    assert port_curves.loss_curve(logs)[0] == \
        ref_curves.loss_curve(logs)[0]
    assert port_curves.running_best([3.0, float("nan"), 2.5]) == \
        ref_curves.running_best([3.0, float("nan"), 2.5])
    for target in (2.6, 3.0, 1.0):
        assert port_curves.time_to_target(logs, target) == \
            ref_curves.time_to_target(logs, target)
    assert port_curves.curve_dict(logs) == ref_curves.curve_dict(logs)
