"""The port's serving path against the JAX package's, on the CPU.

The dense decode path (``_attn_decode`` with its ring buffer for local
layers, ``decode_attention``) at ``tests/test_serving.py``'s TINY, float32
compute: prefill logits and caches, ``pad_cache`` and 8 decode steps
against the reference at rtol/atol 1e-4, and the greedy teacher-forced
consistency test ported.  Where the prompt is shorter than a local
layer's window the reference's decode drops tokens still inside the
window (its ``pad_cache`` never grows a windowed cache); there the port's
decode is held against its own forward instead, as it is at prompts
below, at and above the window, and the reference's divergence is
recorded.  ``jain_index`` against the reference's
definition.  The admission loop: ``serve()`` and ``main`` against the
reference's loop for the same seed, with equal admissions and served
counts (the scheduler's decisions do not depend on the model).
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as ref_serve
import repro.models.attention as ref_attn
import repro.models.transformer as ref_tf
from repro.configs.base import ModelConfig as RefConfig
from repro.core.lyapunov import (Observation, SystemParams, init_queues,
                                 schedule_slot)
from repro.telemetry.metrics import jain_index as ref_jain

import repro_torch.launch.serve as port_serve
import repro_torch.models.attention as port_attn
import repro_torch.models.transformer as port_tf
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig as PortConfig
from repro_torch.core.lyapunov import jain_index
from repro_torch.optim.optimizers import tree_leaves

TOL = dict(rtol=1e-4, atol=1e-4)
#: tests/test_serving.py's config
TINY = dict(name="tiny-serve", family="dense", n_layers=2, d_model=64,
            n_heads=2, n_kv_heads=2, head_dim=32, d_ff=128, vocab=128,
            compute_dtype="float32")


def _cfgs(**over):
    fields = dict(TINY, **over)
    return RefConfig(**fields), PortConfig(**fields)


def _params(rcfg, pcfg, seed=0):
    tree = jax.tree.map(np.asarray,
                        ref_tf.init_params(rcfg, jax.random.PRNGKey(seed)))
    return tree, port_tf.params_from_numpy(tree, pcfg, device="cpu")


def _assert_tree_close(ref_tree, port_tree):
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    port_leaves = tree_leaves(port_tree)
    assert len(ref_leaves) == len(port_leaves)
    for (path, a), b in zip(ref_leaves, port_leaves):
        assert tuple(b.shape) == a.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), **TOL,
                                   err_msg=jax.tree_util.keystr(path))


# --------------------------------------------------------------------- #
# the dense decode path
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("variant", [
    {},
    {"n_heads": 4, "n_kv_heads": 2, "qk_norm": True},        # GQA, G = 2
    {"layer_pattern": ("local", "attn"), "window": 8,         # ring buffer
     "rope_theta_local": 500.0},
    {"layer_pattern": ("local",), "window": 32},              # window > S
])
def test_prefill_pad_and_decode_match_reference(variant):
    """Prefill against the reference; ``pad_cache`` and decode against it
    too where its local cache is right, else (the window > S case)
    against the port's own forward."""
    rcfg, pcfg = _cfgs(**variant)
    tree, params = _params(rcfg, pcfg)
    S, n = 16, 8
    toks = np.random.default_rng(0).integers(0, 128, (2, S + n)).astype(
        np.int32)
    last_r, caches_r, pos_r = ref_tf.prefill(
        tree, {"tokens": jnp.asarray(toks[:, :S])}, rcfg)
    last_p, caches_p, pos_p = port_tf.prefill(
        params, {"tokens": torch.from_numpy(toks[:, :S])}, pcfg)
    assert pos_p == int(pos_r) == S
    np.testing.assert_allclose(last_p.numpy(), np.asarray(last_r), **TOL)
    _assert_tree_close(caches_r, caches_p)
    if rcfg.window > S:
        got, want = _decode_vs_forward(params, pcfg, toks, S)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
        return
    caches_r = ref_tf.pad_cache(caches_r, rcfg, extra=n)
    caches_p = port_tf.pad_cache(caches_p, pcfg, extra=n)
    _assert_tree_close(caches_r, caches_p)
    for i in range(n):
        tok = toks[:, S + i:S + i + 1]
        lr, caches_r = ref_tf.decode_step(tree, jnp.asarray(tok), caches_r,
                                          pos_r + i, rcfg)
        lp, caches_p = port_tf.decode_step(params, torch.from_numpy(tok),
                                           caches_p, pos_p + i, pcfg)
        np.testing.assert_allclose(lp.numpy(), np.asarray(lr), **TOL,
                                   err_msg=f"decode step {i}")
    _assert_tree_close(caches_r, caches_p)


def _decode_vs_forward(params, cfg, toks, S):
    """Prefill ``toks[:, :S]``, then teacher-forced decode of the rest.
    Returns the logits of prefill's last position and of every step, and
    a fresh forward's logits at the same positions, each (B, n, V)."""
    n = toks.shape[1] - S
    last, caches, pos = port_tf.prefill(
        params, {"tokens": torch.from_numpy(toks[:, :S])}, cfg)
    caches = port_tf.pad_cache(caches, cfg, extra=n)
    got = [last]
    for i in range(n - 1):
        lg, caches = port_tf.decode_step(
            params, torch.from_numpy(toks[:, S + i:S + i + 1]), caches,
            pos + i, cfg)
        got.append(lg)
    x, _ = port_tf.forward(params, {"tokens": torch.from_numpy(
        toks[:, :-1])}, cfg)
    return torch.stack(got, 1), x[:, S - 1:] @ params["lm_head"]


@pytest.mark.parametrize("S,n", [(10, 14), (16, 8), (23, 9)])
@pytest.mark.parametrize("pattern", [("local",), ("local", "attn")])
def test_decode_matches_forward_across_the_window(pattern, S, n):
    """Window 16: a prompt below it whose decode crosses the window's edge
    (positions 10 to 23), one at it and one above it (a ring from
    prefill), each decoding past a multiple of the window."""
    _, pcfg = _cfgs(layer_pattern=pattern, window=16)
    params = port_tf.init_params(pcfg, torch.Generator().manual_seed(1),
                                 device="cpu")
    toks = np.random.default_rng(S).integers(0, 128, (2, S + n)).astype(
        np.int32)
    got, want = _decode_vs_forward(params, pcfg, toks, S)
    assert got.shape == want.shape == (2, n, pcfg.vocab)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    caches = port_tf.pad_cache(port_tf.prefill(
        params, {"tokens": torch.from_numpy(toks[:, :S])}, pcfg)[1], pcfg,
        extra=n)
    assert caches[0]["l0"]["mix"]["k"].shape[2] == min(S + n, 16)


def test_reference_local_cache_drops_tokens_inside_the_window():
    """The reference's decode at a prompt shorter than the window: its
    cache stays at the prompt's 16 slots, the step at pos = 16 writes over
    slot 0 (token 0, still inside the window of 32), and its logits leave
    a fresh forward's, by far more than the port's decode does."""
    rcfg, pcfg = _cfgs(layer_pattern=("local",), window=32)
    tree, params = _params(rcfg, pcfg)
    S, n = 16, 8
    toks = np.random.default_rng(0).integers(0, 128, (2, S + n)).astype(
        np.int32)
    got, want = _decode_vs_forward(params, pcfg, toks, S)
    last, caches, pos = ref_tf.prefill(
        tree, {"tokens": jnp.asarray(toks[:, :S])}, rcfg)
    caches = ref_tf.pad_cache(caches, rcfg, extra=n)
    assert caches[0]["l0"]["mix"]["k"].shape[2] == S
    ref = [np.asarray(last)]
    for i in range(n - 1):
        lg, caches = ref_tf.decode_step(
            tree, jnp.asarray(toks[:, S + i:S + i + 1]), caches, pos + i,
            rcfg)
        ref.append(np.asarray(lg))
    ref_err = np.abs(np.stack(ref, 1) - want.numpy()).max(axis=(0, 2))
    port_err = (got - want).abs().amax(dim=(0, 2)).numpy()
    assert ref_err[0] < 1e-4                      # prefill is right
    assert port_err.max() < 1e-4
    assert ref_err[1:].min() > 1e-3               # every decode step is not


def test_greedy_generation_is_deterministic_and_consistent():
    """tests/test_serving.py's test on the port: feeding the generated
    tokens through a fresh forward reproduces the same greedy choices."""
    _, pcfg = _cfgs()
    params = port_tf.init_params(pcfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, 128, (2, 16)))

    def generate():
        last, caches, pos = port_tf.prefill(params, {"tokens": toks}, pcfg)
        caches = port_tf.pad_cache(caches, pcfg, extra=8)
        tok = last.argmax(-1)[:, None]
        first, outs = tok, []
        for i in range(8):
            logits, caches = port_tf.decode_step(params, tok, caches,
                                                 pos + i, pcfg)
            tok = logits.argmax(-1)[:, None]
            outs.append(tok)
        return first, torch.cat(outs, dim=1)

    first, gen = generate()
    assert torch.equal(gen, generate()[1])
    full = torch.cat([toks, first, gen], dim=1)
    x, _ = port_tf.forward(params, {"tokens": full[:, :-1]}, pcfg)
    ref = (x @ params["lm_head"]).argmax(-1)
    assert torch.equal(gen, ref[:, 16:])


@pytest.mark.parametrize("seed", range(3))
def test_decode_attention_matches_reference(seed):
    rng = np.random.default_rng(seed)
    B, S, KV, G, D = 2, 12, 2, 3, 16
    q = rng.standard_normal((B, 1, KV, G, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    valid = rng.uniform(size=(B, S)) < 0.6
    valid[:, 0] = True
    want = ref_attn.decode_attention(*map(jnp.asarray, (q, k, v, valid)))
    got = port_attn.decode_attention(*map(torch.from_numpy,
                                          (q, k, v, valid)))
    assert got.shape == (B, 1, KV, G, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_init_cache_matches_reference():
    rcfg, pcfg = _cfgs(layer_pattern=("local", "attn"), window=8)
    _assert_tree_close(ref_tf.init_cache(rcfg, 2, 20),
                       port_tf.init_cache(pcfg, 2, 20, device="cpu"))


# --------------------------------------------------------------------- #
# jain_index
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("x", [
    [1.0, 2.0, 3.0], [5.0], [0.0, 0.0, 4.0], [7.5] * 6, [], [0.0, 0.0],
    list(np.random.default_rng(0).uniform(0, 100, 16)),
    [1e-3, 2e5, 3.0, 0.0]])
def test_jain_index_matches_reference(x):
    assert jain_index(x) == pytest.approx(ref_jain(x), rel=1e-12, abs=0)
    assert jain_index(torch.tensor(x, dtype=torch.float64)) == \
        pytest.approx(ref_jain(x), rel=1e-12, abs=0)


def test_jain_index_has_no_underflow():
    """Where the reference's squares underflow it returns NaN; the port
    scales by the largest share first."""
    with np.errstate(invalid="ignore"):
        assert np.isnan(ref_jain([1e-200]))
    assert jain_index([1e-200]) == 1.0
    assert jain_index([1e-200, 0.0]) == pytest.approx(0.5, rel=1e-15)
    assert jain_index([1e-200, 1e-200, 2e-200]) == \
        pytest.approx(ref_jain([1.0, 1.0, 2.0]), rel=1e-15)
    with pytest.raises(ValueError):
        jain_index([1.0, -1.0])


# --------------------------------------------------------------------- #
# the admission loop
# --------------------------------------------------------------------- #
def _reference_loop(*, clients, slots, prompt_len, batch, V, vocab, seed=0):
    """``repro.launch.serve.main``'s loop with its scheduler, without the
    model (the decisions do not depend on it): per-slot admissions,
    scheduled requests and the served counts."""
    Mc = clients
    rng = np.random.default_rng(seed)
    sys_params = SystemParams(
        T=1.0, p=jnp.full((Mc,), 0.1), delta=jnp.full((Mc,), 1e-4),
        xi=jnp.full((Mc,), 0.01), f_max=jnp.full((Mc,), 100.0), F=500.0,
        E_cap=jnp.full((Mc,), 50.0), V=V, lam=jnp.ones((Mc,)))
    q_state = init_queues(Mc, E0=25.0)
    sched = jax.jit(lambda s, o: schedule_slot(s, sys_params, o))
    served = np.zeros(Mc)
    admitted, scheduled = [], []
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
        scheduled.append(n_serve)
    return np.asarray(admitted), np.asarray(scheduled), served


@pytest.mark.parametrize("arch,flags", [
    ("tiny", dict(clients=3, slots=6, prompt_len=8, gen_len=2, batch=2)),
    ("tiny", dict(clients=6, slots=40, prompt_len=32, gen_len=8, batch=4)),
    ("rwkv6-1.6b", dict(clients=6, slots=40, prompt_len=32, gen_len=8,
                        batch=4)),
    ("recurrentgemma-2b", dict(clients=6, slots=40, prompt_len=32,
                               gen_len=8, batch=4)),
])
def test_serve_admits_and_serves_as_the_reference(arch, flags):
    cfg = port_serve.TINY if arch == "tiny" else get_config(arch,
                                                            reduced=True)
    params = port_tf.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    res = port_serve.serve(cfg, params, V=30.0, seed=0, device="cpu",
                           **flags)
    admitted, scheduled, served = _reference_loop(
        V=30.0, vocab=cfg.vocab, **{k: v for k, v in flags.items()
                                    if k != "gen_len"})
    np.testing.assert_array_equal(res["admitted"], admitted)
    np.testing.assert_array_equal(res["scheduled"], scheduled)
    np.testing.assert_array_equal(res["served"], served)
    assert res["jain"] == pytest.approx(ref_jain(served), rel=1e-12)
    assert res["prefills"] == int((scheduled.sum(1) > 0).sum()) > 0
    assert len(res["decode_ms"]) == res["prefills"]
    assert res["max_Q"].shape == (flags["slots"],)


def _without_times(text):
    return re.sub(r"\([0-9]+ slots, [0-9.]+s\)", "", text).strip()


def test_main_prints_what_the_reference_prints(capsys):
    argv = ["--arch", "tiny", "--slots", "6", "--clients", "3",
            "--prompt-len", "8", "--gen-len", "2", "--batch", "2"]
    ref_serve.main(argv)
    ref_out = capsys.readouterr().out
    res = port_serve.main(argv + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    assert _without_times(port_out) == _without_times(ref_out)
    assert "clients served" in port_out and res["prefills"] > 0


def test_main_serves_reduced_rwkv6(capsys):
    res = port_serve.main(["--arch", "rwkv6-1.6b", "--slots", "12",
                           "--device", "cpu"])
    assert "Jain fairness index" in capsys.readouterr().out
    assert res["served"].sum() > 0 and 0.0 < res["jain"] <= 1.0


def test_tiny_is_the_reference_s():
    from repro.launch.train import TINY as REF_TINY
    assert dataclasses.asdict(REF_TINY) == \
        dataclasses.asdict(port_serve.TINY)
