"""The port's RG-LRU path (recurrentgemma-2b) against the JAX package's, on
the CPU.

The scan: the port's plain version (what ``rglru_scan`` computes for a CPU
tensor, and what the kernel is held to on the card) against the
reference's oracle ``rglru_ref`` and its Pallas kernel in interpret mode,
on ``tests/test_kernels.py``'s cases with its tolerances (float32 rtol
and atol 2e-5 for the output, 1e-5 for ``h_last``; bfloat16 2e-2 and
1e-2), and a ragged (S, D).

The block (``models/rglru.py``): ``_gates``, ``rglru_scan`` with and
without ``h0``, ``rglru_step``, ``causal_conv1d`` and ``conv1d_step``
against the reference's, with ``lam`` drawn so that a^c lies in [0.9,
0.999] (Griffin's initialisation, arXiv:2402.19427 §2.4) and the zero
biases drawn: at the reference's ``lam = 1`` the recurrence forgets
nearly everything in one step, and a wrong carry would go unseen.

The model: recurrentgemma-2b REDUCED through ``params_from_numpy``,
float32 compute: ``forward``, ``loss_fn``, ``prefill`` caches and decode
against the reference at S = window, where the reference's local cache is
right, at rtol 1e-4 and 3e-3 of the largest |value|; decode against the
port's own forward at S below, at and above the window, at rtol and 1e-4
of the largest |value|.

Why 3e-3 against the reference.  The input scale ``sqrt(1 - a²)``
cancels where the recurrence gate r saturates to ~1e-8: a is then within
a few float32 ulps of 1, and the reference's ``1 - exp(2 log a)`` (its
scan) and ``1 - a·a`` (its step) are multiples of 6e-8, off from the
exact scale by up to 240x.  The port takes ``-expm1(2 log a)`` in both,
which keeps its precision there, so its decode continues its prefill
(``test_reference_input_scale_cancels_where_a_is_near_1`` records the
reference's values).  Where that happens the two differ: by up to 2e-3 of
a rec layer's output (0.051 of up to 25), 3.5e-4 of the final hidden
state's scale (1.3e-3 of up to 3.8), and 2e-4 of the logits.  Everything
else agrees to float32 rounding (the pieces at 2e-5), and a wrong formula
moves the outputs by O(1).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.base as ref_configs
ref_configs.list_archs()    # the whole registry first: it loads only if empty
import repro.configs.recurrentgemma_2b as ref_rg_cfg              # noqa: E402
import repro.models.rglru as ref_rglru                            # noqa: E402
import repro.models.transformer as ref_tf                         # noqa: E402
from repro.kernels.rglru_scan.ops import rglru_scan_op            # noqa: E402
from repro.kernels.rglru_scan.ref import rglru_ref as ref_scan    # noqa: E402

import repro_torch.configs.recurrentgemma_2b as port_rg_cfg       # noqa: E402
import repro_torch.models.rglru as port_rglru                     # noqa: E402
import repro_torch.models.transformer as port_tf                  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_ref, rglru_scan  # noqa: E402
from repro_torch.models.common import spec_leaves                 # noqa: E402
from repro_torch.optim.optimizers import tree_leaves              # noqa: E402
from torch_train_parity import FLAGS, run_against_reference        # noqa: E402

#: tests/test_kernels.py's bounds: (out, h_last) by dtype
SCAN_TOL = {"float32": (dict(rtol=2e-5, atol=2e-5),
                        dict(rtol=1e-5, atol=1e-5)),
            "bfloat16": (dict(rtol=2e-2, atol=2e-2),
                         dict(rtol=1e-2, atol=1e-2))}
PIECE_TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_RTOL, MODEL_FRAC = 1e-4, 3e-3
#: decode against the port's own forward: float32 rounding only
SELF_FRAC = 1e-4


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, err_msg="", frac=MODEL_FRAC):
    """The model comparisons' bound: rtol 1e-4 and ``frac`` of the largest
    |value| (the module docstring says why)."""
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(_np(got) if torch.is_tensor(got) else got,
                               want, rtol=MODEL_RTOL,
                               atol=frac * max(scale, 1.0),
                               err_msg=err_msg)


def _scan_inputs(seed, B, S, D):
    """tests/test_kernels.py's draws: a ~ U(0.5, 0.999), b ~ N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 0.999, (B, S, D)).astype(np.float32),
            (rng.standard_normal((B, S, D)) * 0.1).astype(np.float32))


# --------------------------------------------------------------------- #
# the scan
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("B,S,D", [(2, 128, 64), (1, 256, 128), (3, 64, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_scan_matches_oracle_and_pallas(B, S, D, dtype):
    a, b = _scan_inputs(3, B, S, D)
    out, h_last = rglru_scan(_t(a, getattr(torch, dtype)),
                             _t(b, getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype)
    assert h_last.dtype == torch.float32 and h_last.shape == (B, D)
    aj = jnp.asarray(a, getattr(jnp, dtype))
    bj = jnp.asarray(b, getattr(jnp, dtype))
    tol_out, tol_h = SCAN_TOL[dtype]
    for want, h_want in (ref_scan(aj, bj),
                         rglru_scan_op(aj, bj, block_s=64, block_d=64,
                                       interpret=True)):
        np.testing.assert_allclose(_np(out), np.asarray(want, np.float32),
                                   **tol_out)
        np.testing.assert_allclose(_np(h_last), np.asarray(h_want),
                                   **tol_h)


@pytest.mark.parametrize("B,S,D", [(2, 77, 130), (1, 1, 5), (3, 300, 33)])
def test_plain_scan_ragged_and_with_h0_matches_oracle(B, S, D):
    a, b = _scan_inputs(4, B, S, D)
    h0 = np.random.default_rng(5).standard_normal((B, D)).astype(np.float32)
    for h in (None, h0):
        out, h_last = rglru_ref(_t(a), _t(b),
                                None if h is None else _t(h))
        want, h_want = ref_scan(jnp.asarray(a), jnp.asarray(b),
                                None if h is None else jnp.asarray(h))
        np.testing.assert_allclose(_np(out), np.asarray(want),
                                   **SCAN_TOL["float32"][0])
        np.testing.assert_allclose(_np(h_last), np.asarray(h_want),
                                   **SCAN_TOL["float32"][1])
    out, h_last = rglru_scan(_t(a), _t(b))
    want, h_want = ref_scan(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(_np(out), np.asarray(want),
                               **SCAN_TOL["float32"][0])


@pytest.mark.parametrize("case", ["rank", "shape", "dtype", "mixed",
                                  "strided", "empty", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    a = torch.ones(2, 8, 4)
    args = {"rank": (torch.ones(8, 4), torch.ones(8, 4)),
            "shape": (a, torch.ones(2, 8, 5)),
            "dtype": (a.double(), a.double()),
            "mixed": (a, a.bfloat16()),
            "strided": (torch.ones(2, 4, 8).transpose(1, 2), a),
            "empty": (torch.ones(2, 0, 4), torch.ones(2, 0, 4)),
            "device": (a.to("meta"), a.to("meta"))}[case]
    with pytest.raises((ValueError, TypeError)):
        rglru_scan(*args)


def test_cpu_path_counts_no_launch_and_is_differentiable():
    a, b = (_t(x).requires_grad_(True) for x in _scan_inputs(6, 1, 9, 3))
    before = rglru_scan.launches
    out, h_last = rglru_scan(a, b)
    (out.sum() + h_last.sum()).backward()
    assert rglru_scan.launches == before
    assert a.grad is not None and b.grad is not None
    assert float(b.grad[0, -1, 0]) == 2.0        # d(out_S + h_S)/d b_S


# --------------------------------------------------------------------- #
# the block: gates, scan, step, conv
# --------------------------------------------------------------------- #
def _block_params(seed, Hr, Dr, W=4):
    """The rec block's weights, with ``lam`` giving a^c in [0.9, 0.999]
    and the biases drawn (the reference zero-initialises them)."""
    rng = np.random.default_rng(seed)
    ac = rng.uniform(0.9, 0.999, (Hr, Dr))
    # a = exp(-c·softplus(lam)) at r = 1, so softplus(lam) = -log(a^c)/c
    lam = np.log(np.expm1(-np.log(ac) / 8.0))
    p = {"w_a": rng.standard_normal((Hr, Dr, Dr)) / math.sqrt(Dr),
         "b_a": rng.standard_normal((Hr, Dr)) * 0.5,
         "w_x": rng.standard_normal((Hr, Dr, Dr)) / math.sqrt(Dr),
         "b_x": rng.standard_normal((Hr, Dr)) * 0.5,
         "lam": lam,
         "conv_w": rng.standard_normal((W, Hr * Dr)) * 0.3,
         "conv_b": rng.standard_normal(Hr * Dr) * 0.1}
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: _t(v) for k, v in p.items()})


@pytest.mark.parametrize("seed", range(3))
def test_block_pieces_match_reference(seed):
    B, S, Hr, Dr = 2, 48, 2, 32
    pj, pt = _block_params(seed, Hr, Dr)
    rng = np.random.default_rng(10 + seed)
    x = rng.standard_normal((B, S, Hr, Dr)).astype(np.float32)
    h0 = rng.standard_normal((B, Hr, Dr)).astype(np.float32)
    # a^c in [0.9, 0.999] holds: the recurrence keeps a long memory
    a_c = np.exp(-8.0 * np.logaddexp(0.0, np.asarray(pj["lam"])))
    assert 0.9 - 1e-6 <= a_c.min() and a_c.max() <= 0.999 + 1e-6
    i_r, la_r = ref_rglru._gates(jnp.asarray(x), pj)
    i_p, la_p = port_rglru._gates(_t(x), pt)
    np.testing.assert_allclose(_np(i_p), np.asarray(i_r), **PIECE_TOL)
    np.testing.assert_allclose(_np(la_p), np.asarray(la_r), **PIECE_TOL)
    for h in (None, h0):
        y_r, hl_r = ref_rglru.rglru_scan(
            jnp.asarray(x), pj, None if h is None else jnp.asarray(h))
        y_p, hl_p = port_rglru.rglru_scan(_t(x), pt,
                                          None if h is None else _t(h))
        assert y_p.dtype == torch.float32 and hl_p.shape == (B, Hr, Dr)
        np.testing.assert_allclose(_np(y_p), np.asarray(y_r), **PIECE_TOL)
        np.testing.assert_allclose(_np(hl_p), np.asarray(hl_r), **PIECE_TOL)
    y_r, hn_r = ref_rglru.rglru_step(jnp.asarray(x[:, 0]), jnp.asarray(h0),
                                     pj)
    y_p, hn_p = port_rglru.rglru_step(_t(x[:, 0]), _t(h0), pt)
    np.testing.assert_allclose(_np(y_p), np.asarray(y_r), **PIECE_TOL)
    np.testing.assert_allclose(_np(hn_p), np.asarray(hn_r), **PIECE_TOL)
    xc = x.reshape(B, S, Hr * Dr)
    np.testing.assert_allclose(
        _np(port_rglru.causal_conv1d(_t(xc), pt["conv_w"], pt["conv_b"])),
        np.asarray(ref_rglru.causal_conv1d(jnp.asarray(xc), pj["conv_w"],
                                           pj["conv_b"])), **PIECE_TOL)
    state = xc[:, :3]
    o_r, s_r = ref_rglru.conv1d_step(jnp.asarray(xc[:, 3]),
                                     jnp.asarray(state), pj["conv_w"],
                                     pj["conv_b"])
    o_p, s_p = port_rglru.conv1d_step(_t(xc[:, 3]), _t(state), pt["conv_w"],
                                      pt["conv_b"])
    np.testing.assert_allclose(_np(o_p), np.asarray(o_r), **PIECE_TOL)
    np.testing.assert_array_equal(_np(s_p), np.asarray(s_r))


def test_scan_step_by_step_equals_the_whole_scan():
    """The block's decode step continues its scan: S steps of
    ``rglru_step`` from h = 0 give the scan's outputs and state."""
    B, S, Hr, Dr = 2, 40, 2, 16
    _, pt = _block_params(7, Hr, Dr)
    x = _t(np.random.default_rng(8).standard_normal((B, S, Hr, Dr)))
    y, h_last = port_rglru.rglru_scan(x, pt)
    h = torch.zeros(B, Hr, Dr)
    for t in range(S):
        y_t, h = port_rglru.rglru_step(x[:, t], h, pt)
        np.testing.assert_allclose(_np(y_t), _np(y[:, t]), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {t}")
    np.testing.assert_allclose(_np(h), _np(h_last), rtol=1e-5, atol=1e-5)


def test_reference_input_scale_cancels_where_a_is_near_1():
    """Where r is ~2e-9, log a = -2.2e-8: a = exp(log a) rounds to 1 and
    the reference's step scales its input by sqrt(max(1 - a·a, 1e-12)) =
    1e-6; its scan takes exp(2 log a) one ulp below 1 and scales it by
    2.44e-4; the exact scale, sqrt(-expm1(2 log a)) in float64, is
    2.08e-4.  The port's step and scan both take ``expm1`` and agree with
    the exact value, so its decode continues its prefill wherever a is."""
    B, S, Hr, Dr = 1, 1, 1, 8
    p = {"w_a": np.zeros((Hr, Dr, Dr)), "b_a": np.full((Hr, Dr), -20.0),
         "w_x": np.zeros((Hr, Dr, Dr)), "b_x": np.zeros((Hr, Dr)),
         "lam": np.ones((Hr, Dr))}
    pj = {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}
    pt = {k: _t(v) for k, v in p.items()}
    x = np.ones((B, S, Hr, Dr), np.float32)
    i, log_a = ref_rglru._gates(jnp.asarray(x), pj)
    exact = np.sqrt(-np.expm1(2.0 * np.asarray(log_a, np.float64))) \
        * np.asarray(i, np.float64)
    y_scan, _ = ref_rglru.rglru_scan(jnp.asarray(x), pj)
    y_step, _ = ref_rglru.rglru_step(jnp.asarray(x[:, 0]),
                                     jnp.zeros((B, Hr, Dr)), pj)
    assert np.all(np.asarray(y_scan) / exact > 1.1)
    assert np.all(exact[:, 0] / np.asarray(y_step) > 100)
    p_scan, _ = port_rglru.rglru_scan(_t(x), pt)
    p_step, _ = port_rglru.rglru_step(_t(x[:, 0]), torch.zeros(B, Hr, Dr),
                                      pt)
    np.testing.assert_allclose(_np(p_step), _np(p_scan[:, 0]), rtol=1e-6)
    np.testing.assert_allclose(_np(p_scan), exact, rtol=1e-5)


def test_model_scan_feeds_the_kernel_what_the_reference_scans():
    """The kernel's inputs a, b made from the gate math, as
    tests/test_kernels.py::test_rglru_matches_model_assoc_scan makes them:
    the port's scan wrapper on them equals the reference model's
    associative scan (float32, another order: 1e-5)."""
    B, S, Hr, Dr = 2, 64, 2, 32
    pj, pt = _block_params(9, Hr, Dr)
    x = np.random.default_rng(4).standard_normal((B, S, Hr, Dr)).astype(
        np.float32)
    y_model, _ = ref_rglru.rglru_scan(jnp.asarray(x), pj)
    i, log_a = port_rglru._gates(_t(x), pt)
    a = torch.exp(log_a).reshape(B, S, Hr * Dr)
    b = (torch.sqrt(torch.clamp(1 - torch.exp(2 * log_a), min=1e-12))
         * (i * _t(x))).reshape(B, S, Hr * Dr)
    out, _ = rglru_scan(a.contiguous(), b.contiguous())
    np.testing.assert_allclose(_np(out),
                               np.asarray(y_model).reshape(B, S, -1),
                               rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------- #
# the model: recurrentgemma-2b REDUCED
# --------------------------------------------------------------------- #
def _cfgs(**over):
    over = dict(dict(remat="none", compute_dtype="float32"), **over)
    return (dataclasses.replace(ref_rg_cfg.REDUCED, **over),
            dataclasses.replace(port_rg_cfg.REDUCED, **over))


def _draw_rec_leaves(tree, seed):
    """The rec leaves the reference initialises to zeros or ones drawn:
    ``lam`` for a^c in [0.9, 0.999], ``b_a``, ``b_x`` and ``conv_b``."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.array, tree)
    for group in tree["groups"]:
        for unit in group.values():
            mix = unit["mixer"]
            if "lam" not in mix:
                continue
            ac = rng.uniform(0.9, 0.999, mix["lam"].shape)
            mix["lam"] = np.log(np.expm1(-np.log(ac) / 8.0)).astype(
                np.float32)
            for key, scale in (("b_a", 0.5), ("b_x", 0.5), ("conv_b", 0.1)):
                mix[key] = (rng.standard_normal(mix[key].shape)
                            * scale).astype(np.float32)
    return tree


def _params(rcfg, pcfg, variant, seed=0):
    tree = jax.tree.map(np.asarray,
                        ref_tf.init_params(rcfg, jax.random.PRNGKey(seed)))
    if variant == "drawn":
        tree = _draw_rec_leaves(tree, seed)
    return tree, port_tf.params_from_numpy(tree, pcfg, device="cpu")


def _tokens(vocab, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _assert_tree_close(ref_tree, port_tree):
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    port_leaves = tree_leaves(port_tree)
    assert len(ref_leaves) == len(port_leaves)
    for (path, a), b in zip(ref_leaves, port_leaves):
        assert tuple(b.shape) == np.shape(a), jax.tree_util.keystr(path)
        _close(b, a, err_msg=jax.tree_util.keystr(path))


def test_model_specs_match_reference_full_and_reduced():
    for ref_cfg, port_cfg in ((ref_rg_cfg.FULL, port_rg_cfg.FULL),
                              (ref_rg_cfg.REDUCED, port_rg_cfg.REDUCED)):
        ref_specs = jax.tree.leaves(
            ref_tf.model_specs(ref_cfg),
            is_leaf=lambda x: isinstance(x, ref_tf.Spec))
        port_specs = spec_leaves(port_tf.model_specs(port_cfg))
        assert [(s.shape, s.axes, s.init, s.scale) for s in ref_specs] == \
            [(s.shape, s.axes, s.init, s.scale) for s in port_specs]
    full = port_rg_cfg.FULL
    kinds = [m for m, _ in full.layer_kinds()]
    assert (kinds.count("rec"), kinds.count("local")) == (18, 8)
    assert [(g.kinds, g.n_repeat) for g in port_tf.group_layout(full)] == [
        ((("rec", "dense"), ("rec", "dense"), ("local", "dense")), 8),
        ((("rec", "dense"), ("rec", "dense")), 1)]
    n = sum(math.prod(s.shape)
            for s in spec_leaves(port_tf.model_specs(full)))
    assert n == 2_682_237_440                   # 2.68 B, tied embedding


@pytest.mark.parametrize("variant", ["init", "drawn"])
def test_forward_and_loss_match_reference(variant):
    rcfg, pcfg = _cfgs()
    tree, params = _params(rcfg, pcfg, variant)
    toks = _tokens(rcfg.vocab, 2, 40)
    labels = np.roll(toks, -1, axis=1)
    weights = np.random.default_rng(1).uniform(0, 1, toks.shape).astype(
        np.float32)
    x_r, _, _ = ref_tf.forward(tree, {"tokens": jnp.asarray(toks)}, rcfg)
    x_p, aux = port_tf.forward(params, {"tokens": torch.from_numpy(toks)},
                               pcfg)
    _close(x_p, x_r)
    assert float(aux) == 0.0
    batch = {"tokens": toks, "labels": labels, "weights": weights}
    loss_r = ref_tf.loss_fn(tree, {k: jnp.asarray(v)
                                   for k, v in batch.items()}, rcfg)
    loss_p = port_tf.loss_fn(params, {k: torch.from_numpy(v)
                                      for k, v in batch.items()}, pcfg)
    np.testing.assert_allclose(float(loss_p), float(loss_r), rtol=1e-5)


@pytest.mark.parametrize("variant", ["init", "drawn"])
def test_prefill_and_decode_match_reference_at_the_window(variant):
    """S = window: the one prompt length (besides S > window) at which the
    reference's local cache is right, so every step is compared."""
    rcfg, pcfg = _cfgs()
    tree, params = _params(rcfg, pcfg, variant, seed=1)
    S, n, B = rcfg.window, 8, 2
    toks = _tokens(rcfg.vocab, B, S + n, seed=S)
    last_r, caches_r, pos_r = ref_tf.prefill(
        tree, {"tokens": jnp.asarray(toks[:, :S])}, rcfg)
    last_p, caches_p, pos_p = port_tf.prefill(
        params, {"tokens": torch.from_numpy(toks[:, :S])}, pcfg)
    assert pos_p == int(pos_r) == S
    assert last_p.dtype == torch.float32 and last_p.shape == (B, rcfg.vocab)
    _close(last_p, last_r)
    _assert_tree_close(caches_r, caches_p)
    caches_r = ref_tf.pad_cache(caches_r, rcfg, extra=n)
    caches_p = port_tf.pad_cache(caches_p, pcfg, extra=n)
    _assert_tree_close(caches_r, caches_p)
    for i in range(n):
        tok = toks[:, S + i:S + i + 1]
        lr, caches_r = ref_tf.decode_step(tree, jnp.asarray(tok), caches_r,
                                          pos_r + i, rcfg)
        lp, caches_p = port_tf.decode_step(params, torch.from_numpy(tok),
                                           caches_p, pos_p + i, pcfg)
        _close(lp, lr, err_msg=f"decode step {i}")
    _assert_tree_close(caches_r, caches_p)


def _decode_vs_forward(params, cfg, toks, S):
    """Prefill ``toks[:, :S]``, then teacher-forced decode of the rest;
    returns the logits of prefill's last position and of every step, and
    a fresh forward's logits at the same positions."""
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
    head = port_tf._lm_head(params, cfg)
    return torch.stack(got, 1), (x[:, S - 1:] @ head).float()


@pytest.mark.parametrize("S,n", [(20, 20), (32, 8), (45, 12)])
@pytest.mark.parametrize("variant", ["init", "drawn"])
def test_decode_matches_own_forward_across_the_window(S, n, variant):
    """Below, at and above the window (32); the first case decodes across
    the window's edge (positions 20 to 39)."""
    rcfg, pcfg = _cfgs()
    _, params = _params(rcfg, pcfg, variant, seed=2)
    toks = _tokens(pcfg.vocab, 2, S + n, seed=3)
    got, want = _decode_vs_forward(params, pcfg, toks, S)
    assert got.shape == want.shape == (2, n, pcfg.vocab)
    _close(got, want.numpy(), frac=SELF_FRAC)


def test_reference_local_cache_drops_tokens_inside_the_window():
    """The reference keeps a prompt shorter than the window at its length
    (``pad_cache`` never grows a windowed cache), so its decode writes the
    first token past the prompt over slot 0, still inside the window: its
    logits leave a fresh forward.  The port's equal it."""
    rcfg, pcfg = _cfgs()
    tree, params = _params(rcfg, pcfg, "drawn", seed=2)
    S, n = 20, 6
    toks = _tokens(rcfg.vocab, 2, S + n, seed=3)
    got, want = _decode_vs_forward(params, pcfg, toks, S)
    _close(got, want.numpy(), frac=SELF_FRAC)
    last, caches, pos = ref_tf.prefill(
        tree, {"tokens": jnp.asarray(toks[:, :S])}, rcfg)
    caches = ref_tf.pad_cache(caches, rcfg, extra=n)
    assert caches[0]["l2"]["mix"]["k"].shape[2] == S       # not grown
    ref = [np.asarray(last)]
    for i in range(n - 1):
        lg, caches = ref_tf.decode_step(
            tree, jnp.asarray(toks[:, S + i:S + i + 1]), caches, pos + i,
            rcfg)
        ref.append(np.asarray(lg))
    ref = np.stack(ref, 1)
    # prefill agrees; the decode steps, which have lost token 0, do not
    _close(ref[:, :1], want.numpy()[:, :1])
    assert np.abs(ref[:, 1:] - want.numpy()[:, 1:]).max() > \
        10 * MODEL_FRAC * float(np.abs(want.numpy()).max())


def test_short_prompt_keeps_a_zero_padded_conv_state():
    """A prompt shorter than conv_width - 1: the port keeps the last
    W - 1 pre-conv inputs with zeros before the first token, as a causal
    conv sees them, and decodes as its forward.  The reference keeps only
    the S rows it has, and its decode step then fails on them."""
    rcfg, pcfg = _cfgs()
    tree, params = _params(rcfg, pcfg, "drawn", seed=4)
    S, n = 2, 5
    toks = _tokens(pcfg.vocab, 2, S + n, seed=5)
    last, caches, _ = port_tf.prefill(
        params, {"tokens": torch.from_numpy(toks[:, :S])}, pcfg)
    conv = caches[0]["l0"]["mix"]["conv"]
    assert conv.shape[2] == pcfg.conv_width - 1
    assert not conv[:, :, 0].any()               # the zero row before t=0
    got, want = _decode_vs_forward(params, pcfg, toks, S)
    _close(got, want.numpy(), frac=SELF_FRAC)
    _, caches_r, pos_r = ref_tf.prefill(
        tree, {"tokens": jnp.asarray(toks[:, :S])}, rcfg)
    assert caches_r[0]["l0"]["mix"]["conv"].shape[2] == S
    with pytest.raises(Exception):
        ref_tf.decode_step(tree, jnp.asarray(toks[:, S:S + 1]), caches_r,
                           pos_r, rcfg)


def test_bf16_prefill_and_decode_match_reference():
    """bfloat16 compute on both sides: the frameworks round intermediate
    bf16 values at other places, so the logits agree to a few bf16 steps
    of their scale (about 1), not to float32 precision."""
    rcfg, pcfg = _cfgs(compute_dtype="bfloat16")
    tree, params = _params(rcfg, pcfg, "drawn", seed=2)
    S = rcfg.window
    toks = _tokens(rcfg.vocab, 2, S + 1, seed=3)
    last_r, caches_r, pos = ref_tf.prefill(
        tree, {"tokens": jnp.asarray(toks[:, :S])}, rcfg)
    lr, _ = ref_tf.decode_step(tree, jnp.asarray(toks[:, S:]), caches_r,
                               pos, rcfg)
    last_p, caches_p, pos_p = port_tf.prefill(
        params, {"tokens": torch.from_numpy(toks[:, :S])}, pcfg)
    lp, _ = port_tf.decode_step(params, torch.from_numpy(toks[:, S:]),
                                caches_p, pos_p, pcfg)
    for a, b in ((last_p, last_r), (lp, lr)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=5e-2,
                                   atol=5e-2)
    rec = caches_p[0]["l0"]["mix"]
    assert rec["h"].dtype == torch.float32
    assert rec["conv"].dtype == torch.bfloat16


def test_init_cache_matches_reference_layout():
    rcfg, pcfg = _cfgs(compute_dtype="bfloat16")
    ref = ref_tf.init_cache(rcfg, 3, 10)
    port = port_tf.init_cache(pcfg, 3, 10, device="cpu")
    ref_leaves = jax.tree.leaves(ref)
    port_leaves = tree_leaves(port)
    assert [(tuple(np.shape(a)), str(a.dtype)) for a in ref_leaves] == \
        [(tuple(b.shape), str(b.dtype)[6:]) for b in port_leaves]
    assert not any(b.any() for b in port_leaves)


def test_training_through_the_rec_block_on_the_cpu():
    """The CPU's plain scan is differentiable, so ``loss_fn`` has a
    gradient for every rec leaf (the card's kernel is forward-only)."""
    _, pcfg = _cfgs()
    params = port_tf.init_params(pcfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    toks = torch.from_numpy(_tokens(pcfg.vocab, 1, 12))
    loss = port_tf.loss_fn(params, {"tokens": toks,
                                    "labels": toks.roll(-1, 1),
                                    "weights": torch.ones(1, 12)}, pcfg)
    grads = torch.autograd.grad(loss, leaves)
    rec = params["groups"][0]["l0"]["mixer"]
    for name in ("lam", "w_a", "w_x", "conv_w"):
        idx = next(i for i, t in enumerate(leaves) if t is rec[name])
        assert torch.isfinite(grads[idx]).all() and grads[idx].abs().sum() > 0


def _exact_scale_scan(x, p, h0=None):
    """``repro.models.rglru.rglru_scan`` with the input scale taken as
    ``sqrt(-expm1(2 log a))``; nothing else changed."""
    xf = x.astype(jnp.float32)
    i, log_a = ref_rglru._gates(xf, p)
    a = jnp.exp(log_a)
    b = jnp.sqrt(jnp.maximum(-jnp.expm1(2.0 * log_a), 1e-12)) * (i * xf)
    if h0 is not None:
        b = b.at[:, 0].add(a[:, 0] * h0.astype(jnp.float32))
    _, h = jax.lax.associative_scan(
        lambda u, v: (u[0] * v[0], v[0] * u[1] + v[1]), (a, b), axis=1)
    return h.astype(x.dtype), h[:, -1]


def test_recurrentgemma_training_matches_reference(tmp_path, capsys,
                                                   monkeypatch):
    """recurrentgemma-2b REDUCED (rec and windowed local layers) through
    ``launch.train.train`` (coded) against the reference's loop on its
    float32 twin (``tests/torch_train_parity.py``), at 48 tokens, past
    the window of 32, so that it bites in the forward and the attention
    backward.  The RG-LRU's backward on the CPU is the written-out
    ``rglru_bwd_ref``; the reference differentiates ``associative_scan``.
    Its input scale cancels where a is within a few ulps of 1 (above), which
    no nudge of the weights bounds, so its scan is patched to the port's
    scale, as the WKV tests patch the chunked WKV."""
    monkeypatch.setattr(ref_rglru, "rglru_scan", _exact_scale_scan)
    flags = list(FLAGS)
    flags[flags.index("--seq") + 1] = "48"
    run_against_reference("recurrentgemma-2b", True, flags, tmp_path, capsys,
                          monkeypatch)
