"""The seven configs that came with the MoE FFN and the frontends, against
the JAX package, on the CPU at REDUCED size.

Each config's reference weights are carried across with
``params_from_numpy``; both models see the batch of ``synthetic_batch``
(the same numpy draws).  Everything runs in float32.  Tolerances:

* the final hidden states: within ``ULP_FACTOR`` times what a one-ulp
  nudge of every weight moves the reference's own (in norm), plus
  ``NORM_FLOOR``, as ``test_torch_transformer.py`` holds them;
* the loss: rtol 1e-6; the MoE balance loss ``aux``: rtol 1e-5 (each
  layer's router sees hidden states that differ at the 1e-6 level);
* prefill and decode: ``tests/test_torch_zoo_serve.py``.
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

import repro.configs.base as ref_configs                          # noqa: E402
import repro.data.batches as ref_batches                          # noqa: E402
import repro.models.common as ref_common                          # noqa: E402
import repro.models.transformer as ref_tf                         # noqa: E402

import repro_torch.configs as port_configs                        # noqa: E402
import repro_torch.data.batches as port_batches                   # noqa: E402
import repro_torch.models.common as port_common                   # noqa: E402
import repro_torch.models.transformer as port_tf                  # noqa: E402
from repro_torch.core.coded_step import _value_and_grad           # noqa: E402
from repro_torch.launch import train as port_train                # noqa: E402
from repro_torch.optim.optimizers import tree_leaves              # noqa: E402

for _mod in ("llama4_maverick_400b_a17b", "granite_moe_3b_a800m",
             "internvl2_26b", "deepseek_67b", "gemma3_12b", "qwen3_14b",
             "hubert_xlarge"):
    importlib.import_module(f"repro.configs.{_mod}")

ZOO = ["granite-moe-3b-a800m", "llama4-maverick-400b-a17b", "qwen3-14b",
       "deepseek-67b", "gemma3-12b", "internvl2-26b", "hubert-xlarge"]
ULP_FACTOR, NORM_FLOOR = 10.0, 1e-5
LOSS_RTOL, AUX_RTOL = 1e-6, 1e-5


def _cfgs(arch, **over):
    return (dataclasses.replace(ref_configs.get_config(arch, reduced=True),
                                **over),
            dataclasses.replace(port_configs.get_config(arch, reduced=True),
                                **over))


def _params(rcfg, pcfg, seed=0):
    tree = jax.tree.map(np.asarray,
                        ref_tf.init_params(rcfg, jax.random.PRNGKey(seed)))
    return tree, port_tf.params_from_numpy(tree, pcfg, device="cpu")


def _batches(rcfg, pcfg, S, kind, seed):
    return (ref_batches.synthetic_batch(rcfg, 2, S, kind, seed=seed),
            port_batches.synthetic_batch(pcfg, 2, S, kind, seed=seed,
                                         device="cpu"))


def _ulp_nudge(tree, seed=0):
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


# --------------------------------------------------------------------- #
# full-size configs: specs only, nothing allocated
# --------------------------------------------------------------------- #
#: the reference's ``tests/test_models.py::test_param_counts_full_config``
PARAM_RANGES = {"llama4-maverick-400b-a17b": (350e9, 480e9),
                "granite-moe-3b-a800m": (2.5e9, 4.5e9),
                "internvl2-26b": (19e9, 28e9), "deepseek-67b": (60e9, 72e9),
                "gemma3-12b": (9e9, 14e9), "qwen3-14b": (12e9, 17e9),
                "hubert-xlarge": (0.7e9, 1.3e9)}


@pytest.mark.parametrize("arch", ZOO)
def test_full_specs_match_reference(arch):
    rcfg = ref_configs.get_config(arch)
    pcfg = port_configs.get_config(arch)
    with_path = jax.tree_util.tree_flatten_with_path(
        ref_tf.model_specs(rcfg),
        is_leaf=lambda x: isinstance(x, ref_common.Spec))[0]
    port = port_common.spec_leaves(port_tf.model_specs(pcfg))
    assert [(tuple(s.shape), s.axes, s.init, s.scale)
            for _, s in with_path] == \
        [(tuple(s.shape), s.axes, s.init, s.scale) for s in port]
    total = sum(int(np.prod(s.shape)) for s in port)
    lo, hi = PARAM_RANGES[arch]
    assert lo <= total <= hi, (arch, total / 1e9)
    assert [(g.kinds, g.n_repeat, g.first_layer)
            for g in ref_tf.group_layout(rcfg)] == \
        [(g.kinds, g.n_repeat, g.first_layer)
         for g in port_tf.group_layout(pcfg)]


# --------------------------------------------------------------------- #
# REDUCED: forward, loss, prefill + decode
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ZOO)
def test_reduced_forward_and_loss_match_reference(arch):
    rcfg, pcfg = _cfgs(arch, compute_dtype="float32", remat="none")
    tree, params = _params(rcfg, pcfg)
    S = 40 if rcfg.frontend == "vision" else 32
    rb, pb = _batches(rcfg, pcfg, S, "train", seed=1)

    @jax.jit
    def ref(p):
        x, aux, _ = ref_tf.forward(p, rb, rcfg)
        return x, aux, ref_tf.loss_fn(p, rb, rcfg)
    x_r, aux_r, loss_r = ref(tree)
    x_n, _, _ = ref(_ulp_nudge(tree))
    x_p, aux_p = port_tf.forward(params, pb, pcfg)
    loss_p = port_tf.loss_fn(params, pb, pcfg)
    assert x_p.shape == x_r.shape and x_p.dtype == torch.float32
    assert _rel(x_r, x_p.numpy()) <= \
        ULP_FACTOR * _rel(x_r, x_n) + NORM_FLOOR
    np.testing.assert_allclose(float(loss_p), float(loss_r), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux_p), float(aux_r), rtol=AUX_RTOL)
    assert (float(aux_p) > 0) == bool(rcfg.n_experts)


def test_unused_leaves_get_zero_gradients():
    """An audio config never reads its token embedding; ``jax.grad``
    gives it zeros, and so must the port's ``_value_and_grad``."""
    _, pcfg = _cfgs("hubert-xlarge", compute_dtype="float32", remat="none")
    params = port_tf.init_params(pcfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    batch = port_batches.synthetic_batch(pcfg, 2, 16, "train", seed=0,
                                         device="cpu")
    loss, grads = _value_and_grad(
        lambda p, b: port_tf.loss_fn(p, b, pcfg))(params, batch)
    assert torch.isfinite(loss)
    assert not grads["embed"].any() and grads["adapter"].abs().sum() > 0


# --------------------------------------------------------------------- #
# parameters, batches and the drivers
# --------------------------------------------------------------------- #
def test_bfloat16_params_are_drawn_in_slices(monkeypatch):
    """``param_dtype="bfloat16"`` makes bfloat16 leaves; a leaf drawn a
    slice at a time follows its spec (truncated at 2 sigma, std
    ``scale/sqrt(fan_in)``) and is drawn again the same from the seed."""
    _, pcfg = _cfgs("llama4-maverick-400b-a17b", param_dtype="bfloat16")
    monkeypatch.setattr(port_common, "_WHOLE_DRAW_MAX", 1000)
    monkeypatch.setattr(port_common, "_DRAW_SLICE", 777)
    draws = [port_tf.init_params(pcfg, torch.Generator().manual_seed(3),
                                 device="cpu") for _ in range(2)]
    specs = port_common.spec_leaves(port_tf.model_specs(pcfg))
    for s, a, b in zip(specs, *(tree_leaves(d) for d in draws)):
        assert a.dtype == torch.bfloat16 and tuple(a.shape) == s.shape
        assert torch.equal(a, b)
        if s.init in ("normal", "embed") and a.numel() > 1000:
            fan_in = s.shape[0] if len(s.shape) >= 2 else s.shape[-1]
            std = 0.02 * s.scale if s.init == "embed" else \
                s.scale / np.sqrt(fan_in)
            x = a.float() / std
            assert float(x.abs().max()) <= 2.0 * (1 + 2 ** -7)
            assert 0.8 < float(x.std()) < 0.95     # N(0,1) cut at 2: 0.88


@pytest.mark.parametrize("arch,kind,dtype", [
    ("hubert-xlarge", "train", "bfloat16"),
    ("hubert-xlarge", "prefill", "float32"),
    ("internvl2-26b", "train", "bfloat16"),
    ("internvl2-26b", "prefill", "float32"),
    ("granite-moe-3b-a800m", "train", "bfloat16"),
    ("qwen3-14b", "prefill", "bfloat16")])
def test_synthetic_batch_is_the_reference_s(arch, kind, dtype):
    rcfg, pcfg = _cfgs(arch, compute_dtype=dtype)
    rb, pb = _batches(rcfg, pcfg, 24, kind, seed=5)
    assert sorted(rb) == sorted(pb)
    for name in rb:
        want, got = np.asarray(rb[name]), pb[name]
        assert str(got.dtype)[6:] == str(want.dtype), name
        np.testing.assert_array_equal(got.float().numpy() if
                                      got.dtype == torch.bfloat16 else
                                      got.numpy(),
                                      want.astype(np.float32)
                                      if str(want.dtype) == "bfloat16"
                                      else want)
    assert port_batches.batch_shapes(pcfg, 2, 24, kind).keys() == \
        ref_batches.batch_shapes(rcfg, 2, 24, kind).keys()


def test_train_refuses_moe_and_frontend_configs():
    for arch in ("granite-moe-3b-a800m", "llama4-maverick-400b-a17b"):
        cfg = port_configs.get_config(arch, reduced=True)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            port_train.train(cfg, steps=1, device="cpu")
    for arch in ("internvl2-26b", "hubert-xlarge"):
        cfg = port_configs.get_config(arch, reduced=True)
        with pytest.raises(SystemExit):
            port_train.train(cfg, steps=1, device="cpu")
