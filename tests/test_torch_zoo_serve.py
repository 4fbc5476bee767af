"""Prefill, decode and serving of the seven configs that came with the
MoE FFN and the frontends, against the JAX package, on the CPU at REDUCED
size (forward and loss: ``tests/test_torch_zoo.py``).

Each config's reference weights are carried across with
``params_from_numpy``; both see the inputs of ``synthetic_batch``.  In
float32 at ``capacity_factor=8.0`` (no token dropped, so routing is the
same in prefill, decode and a fresh forward, as the reference's own check
asks): the logits within ``LOGIT_TOL`` of the largest |logit| of the
reference's (measured: up to 4.5e-5 with MoE, 4e-6 without), the same
greedy choices; the port's decode against the port's own fresh forward
within ``SELF_TOL`` (measured: up to 4.4e-6).
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
import repro.models.transformer as ref_tf                         # noqa: E402
from repro.core.lyapunov import (Observation, SystemParams,       # noqa: E402
                                 init_queues, schedule_slot)

import repro_torch.configs as port_configs                        # noqa: E402
import repro_torch.data.batches as port_batches                   # noqa: E402
import repro_torch.models.transformer as port_tf                  # noqa: E402
from repro_torch.launch import serve as port_serve                # noqa: E402

for _mod in ("llama4_maverick_400b_a17b", "granite_moe_3b_a800m",
             "internvl2_26b", "deepseek_67b", "gemma3_12b", "qwen3_14b",
             "hubert_xlarge"):
    importlib.import_module(f"repro.configs.{_mod}")

DECODERS = ["granite-moe-3b-a800m", "llama4-maverick-400b-a17b",
            "qwen3-14b", "deepseek-67b", "gemma3-12b", "internvl2-26b"]
LOSS_RTOL, AUX_RTOL = 1e-6, 1e-5
LOGIT_TOL, SELF_TOL = 2e-4, 1e-5


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


@pytest.mark.parametrize("arch", DECODERS)
def test_reduced_prefill_and_decode_match_reference(arch):
    rcfg, pcfg = _cfgs(arch, compute_dtype="float32", capacity_factor=8.0)
    tree, params = _params(rcfg, pcfg, seed=1)
    P = rcfg.n_patches if rcfg.frontend == "vision" else 0
    n = 3
    rb, pb = _batches(rcfg, pcfg, P + 32 + n, "prefill", seed=2)
    r_toks, p_toks = rb["tokens"], pb["tokens"]
    last_r, c_r, pos_r = ref_tf.prefill(
        tree, dict(rb, tokens=r_toks[:, :-n]), rcfg)
    last_p, c_p, pos_p = port_tf.prefill(
        params, dict(pb, tokens=p_toks[:, :-n]), pcfg)
    assert pos_p == int(pos_r) == P + 32
    c_r, c_p = ref_tf.pad_cache(c_r, rcfg, n), port_tf.pad_cache(c_p, pcfg,
                                                                  n)
    got_r, got_p = [np.asarray(last_r)], [last_p.numpy()]
    for i in range(n):
        j = r_toks.shape[1] - n + i
        lg_r, c_r = ref_tf.decode_step(tree, r_toks[:, j:j + 1], c_r,
                                       pos_r + i, rcfg)
        lg_p, c_p = port_tf.decode_step(params, p_toks[:, j:j + 1], c_p,
                                        pos_p + i, pcfg)
        got_r.append(np.asarray(lg_r))
        got_p.append(lg_p.numpy())
    got_r, got_p = np.stack(got_r), np.stack(got_p)
    scale = float(np.abs(got_r).max())
    np.testing.assert_allclose(got_p, got_r, rtol=0, atol=LOGIT_TOL * scale)
    np.testing.assert_array_equal(got_p.argmax(-1), got_r.argmax(-1))
    # the port's decode against its own fresh forward
    x, _ = port_tf.forward(params, pb, pcfg)
    fresh = (x[:, -n - 1:] @ port_tf._lm_head(params, pcfg)).permute(
        1, 0, 2).numpy()
    np.testing.assert_allclose(got_p, fresh, rtol=0, atol=SELF_TOL * scale)


def test_moe_decode_routes_per_shard_as_the_reference():
    rcfg, pcfg = _cfgs("granite-moe-3b-a800m", compute_dtype="float32")
    tree, params = _params(rcfg, pcfg, seed=2)
    rb, pb = _batches(rcfg, pcfg, 24, "prefill", seed=3)
    for shards in (1, 2):
        last_r, _, _ = ref_tf.prefill(tree, rb, rcfg, dp_shards=shards)
        last_p, _, _ = port_tf.prefill(params, pb, pcfg, dp_shards=shards)
        np.testing.assert_allclose(last_p.numpy(), np.asarray(last_r),
                                   rtol=0, atol=LOGIT_TOL * float(
                                       np.abs(np.asarray(last_r)).max()))
    loss_r = ref_tf.loss_fn(tree, dict(rb, **ref_batches.synthetic_batch(
        rcfg, 2, 24, "train", seed=3)), rcfg, dp_shards=2)
    loss_p = port_tf.loss_fn(params, port_batches.synthetic_batch(
        pcfg, 2, 24, "train", seed=3, device="cpu"), pcfg, dp_shards=2)
    # two shards, tokens dropped at capacity 1.0: the loss moves with the
    # MoE layers' hidden states, so it is held as aux is
    np.testing.assert_allclose(float(loss_p), float(loss_r), rtol=AUX_RTOL)


def test_audio_config_has_no_decode_step():
    _, pcfg = _cfgs("hubert-xlarge", compute_dtype="float32")
    params = port_tf.init_params(pcfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    with pytest.raises(ValueError, match="no decode step"):
        port_tf.decode_step(params, torch.zeros((2, 1), dtype=torch.int64),
                            [], 4, pcfg)


def test_serve_refuses_frontend_configs():
    for arch in ("internvl2-26b", "hubert-xlarge"):
        cfg = port_configs.get_config(arch, reduced=True)
        with pytest.raises(ValueError, match="token prompts"):
            port_serve.serve(cfg, None, device="cpu")


def _reference_admissions(*, clients, slots, prompt_len, batch, V, vocab):
    """``repro.launch.serve.main``'s admission loop, without the model
    (its decisions do not depend on it)."""
    Mc = clients
    rng = np.random.default_rng(0)
    sys_params = SystemParams(
        T=1.0, p=jnp.full((Mc,), 0.1), delta=jnp.full((Mc,), 1e-4),
        xi=jnp.full((Mc,), 0.01), f_max=jnp.full((Mc,), 100.0), F=500.0,
        E_cap=jnp.full((Mc,), 50.0), V=V, lam=jnp.ones((Mc,)))
    q_state = init_queues(Mc, E0=25.0)
    sched = jax.jit(lambda s, o: schedule_slot(s, sys_params, o))
    served = np.zeros(Mc)
    admitted = []
    for _ in range(slots):
        arrivals = rng.poisson([6.0] + [1.0] * (Mc - 1)).astype(np.float32)
        obs = Observation(
            D=jnp.asarray(arrivals), r=jnp.full((Mc,), float(batch)),
            E_H=jnp.asarray(rng.uniform(1, 3, Mc), jnp.float32),
            L=jnp.asarray(1.0), new_cycles=jnp.zeros((Mc,)))
        q_state, dec = sched(q_state, obs)
        n_serve = np.round(np.asarray(dec.c)).astype(int)
        total = int(n_serve.sum())
        if total > 0:
            n_run = min(total, batch)
            rng.integers(0, vocab, (n_run, prompt_len))
            served += n_serve * (n_run / max(total, 1))
        admitted.append(np.asarray(dec.d))
    return np.asarray(admitted), served


def test_serve_granite_admits_and_serves_as_the_reference():
    cfg = port_configs.get_config("granite-moe-3b-a800m", reduced=True)
    flags = dict(clients=6, slots=8, prompt_len=16, batch=4)
    params = port_tf.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    res = port_serve.serve(cfg, params, gen_len=3, V=30.0, seed=0,
                           device="cpu", **flags)
    admitted, served = _reference_admissions(V=30.0, vocab=cfg.vocab,
                                             **flags)
    np.testing.assert_array_equal(res["admitted"], admitted)
    np.testing.assert_array_equal(res["served"], served)
    assert res["prefills"] > 0
