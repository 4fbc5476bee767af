"""The port's LM training loop and checkpoints held against the JAX
package's (``repro.launch.train``, ``repro.checkpoint``).

The reference's training loop is its command line: it is run at TINY with a
checkpoint every step, and its last checkpoint is restored in the port,
which is both the comparison of the two loops' parameters and the proof
that a checkpoint of one package restores in the other.  Both start from
the reference's weights (``PRNGKey(0)``, carried over with
``params_from_numpy``).  TINY computes in bfloat16, and XLA and PyTorch
round bfloat16 at other places, so the tight comparison runs TINY's float32
twin (``TINY32``, patched into the reference's module for its command
line): per-slot losses within rtol 1e-4 (the bound of
``tests/test_torch_lm_bridge.py``'s decode checks).  The loop steps with
AdamW, whose first step ``g/(|g|+eps)`` moves an entry whose gradient
cancels to float32 noise by up to ``lr`` (ROADMAP.md §3, the AdamW parity
limit: at TINY 13 of 426,624 entries move by up to 8e-5), so after the
steps the parameters and losses are held to the port's own conditioning,
as ``tests/test_torch_lm_bridge.py`` holds them: each leaf's distance from
the reference's within ``ULP_FACTOR`` times the distance a one-ulp nudge
of every initial weight makes, plus ``NORM_FLOOR``.  TINY itself is held
to bfloat16's unit roundoff, 2^-9, on the losses.
"""
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as ref_ckpt
import repro.launch.train as ref_train
import repro.models.transformer as ref_tf
from repro.configs.base import list_archs as ref_list_archs

import repro_torch.checkpoint as port_ckpt
import repro_torch.launch.train as port_train
import repro_torch.models.mlp as port_mlp
import repro_torch.models.transformer as port_tf
from repro_torch.configs.base import list_archs
from repro_torch.core import make_train_step
from repro_torch.optim.optimizers import adamw, tree_leaves, tree_map

ref_list_archs()        # fill the reference's registry before anything else
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
ULP_FACTOR, NORM_FLOOR = 10.0, 1e-6
BF16_RTOL = 2.0 ** -9
TINY32 = dataclasses.replace(port_train.TINY, compute_dtype="float32")
REF_TINY32 = dataclasses.replace(ref_train.TINY, compute_dtype="float32")
FLAGS = ["--steps", "3", "--batch", "2", "--seq", "32", "--log-every", "1",
         "--ckpt-every", "1"]


def _ref_params():
    return jax.tree.map(np.asarray, ref_tf.init_params(
        ref_train.TINY, jax.random.PRNGKey(0)))


def _port_params(params=None):
    return port_tf.params_from_numpy(
        _ref_params() if params is None else params, port_train.TINY,
        device="cpu")


def _ulp_nudge(tree, seed=0):
    """Every float32 leaf moved by -1, 0 or +1 ulp, entry by entry."""
    gen = torch.Generator().manual_seed(seed)

    def nudge(x):
        d = torch.randint(-1, 2, x.shape, generator=gen)
        return torch.where(d > 0, torch.nextafter(x, torch.full_like(
            x, np.inf)), torch.where(d < 0, torch.nextafter(
                x, torch.full_like(x, -np.inf)), x))
    return tree_map(nudge, tree)


def _norm(x):
    return float(np.linalg.norm(np.asarray(x, np.float64)))


def _printed_losses(text):
    return [float(x) for x in re.findall(r"loss=([-\d.]+)", text)]


def _flat(tree):
    return np.concatenate([t.detach().float().numpy().ravel()
                           for t in tree_leaves(tree)])


def test_tiny_is_the_reference_s_and_unregistered():
    assert dataclasses.asdict(port_train.TINY) == \
        dataclasses.asdict(ref_train.TINY)
    assert dataclasses.asdict(port_train.PRESET_100M) == \
        dataclasses.asdict(ref_train.PRESET_100M)
    assert "tiny" not in list_archs() and "preset-100m" not in list_archs()


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_per_slot_lm_loss_matches_reference(compute):
    cfg, ref_cfg = ((TINY32, REF_TINY32) if compute == "float32"
                    else (port_train.TINY, ref_train.TINY))
    rtol = 1e-4 if compute == "float32" else BF16_RTOL
    rng = np.random.default_rng(0)
    Mw, S_, b, S = 3, 4, 2, 24
    toks = rng.integers(0, 512, (Mw, S_, b, S)).astype(np.int32)
    labs = rng.integers(0, 512, (Mw, S_, b, S)).astype(np.int32)
    w = rng.random((Mw, S_, b, S)).astype(np.float32)
    w[:, :, :, -1] = 0.0
    w[0, 3] = 0.0                         # an unused slot
    want = ref_train.per_slot_lm_loss(ref_cfg)(
        jax.tree.map(jnp.asarray, _ref_params()),
        {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs),
         "weights": jnp.asarray(w)})
    for chunk in (port_train.CE_CHUNK, 40):   # one chunk; ragged chunks
        got = port_train.per_slot_lm_loss(cfg, chunk=chunk)(
            _port_params(), {"tokens": torch.from_numpy(toks),
                             "labels": torch.from_numpy(labs),
                             "weights": torch.from_numpy(w)})
        assert tuple(got.shape) == (Mw, S_)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=rtol)
    assert float(got[0, 3]) == 0.0


@pytest.mark.parametrize("coded", [True, False], ids=["coded", "plain"])
def test_training_loop_matches_reference(coded, tmp_path, capsys,
                                         monkeypatch):
    ref_dir = str(tmp_path / "ref")
    monkeypatch.setattr(ref_train, "TINY", REF_TINY32)
    ref_train.main(FLAGS + ["--ckpt-dir", ref_dir] +
                   (["--coded"] if coded else []))
    want = _printed_losses(capsys.readouterr().out)
    kw = dict(steps=3, batch=2, seq=32, coded=coded, device="cpu",
              log=lambda msg: None)
    p0 = _port_params()
    out = port_train.train(TINY32, params=p0, **kw)
    nudged = port_train.train(TINY32, params=_ulp_nudge(p0), **kw)
    assert len(want) == 3 and out["step"] == [0, 1, 2]
    sens = np.abs(np.subtract(nudged["loss"], out["loss"]))
    # the printed four decimals, float32 sums of 12 partitions' CE in
    # another order (rtol 1e-5), and AdamW's noise after the first step
    np.testing.assert_array_less(np.abs(np.subtract(out["loss"], want)),
                                 5e-5 + 1e-5 * np.abs(want) +
                                 ULP_FACTOR * sens)
    if coded:
        assert all(out["decode_ok"]) and min(out["n_slots"]) >= 1
    # the reference's last checkpoint (after step 2) restored in the port
    ck = port_ckpt.Checkpointer(ref_dir)
    assert ck.all_steps() == [1, 2]
    step, t = ck.restore({"params": out["params"], "opt": out["opt_state"]})
    assert step == 2 and int(t["opt"].step) == int(out["opt_state"].step) == 3
    for a, b, c, x0 in zip(*(tree_leaves(x) for x in (
            t["params"], out["params"], nudged["params"], p0))):
        a, b, c = (y.double().numpy() for y in (a, b, c))
        moved = _norm(a - x0.double().numpy())
        err, sens = _norm(b - a) / moved, _norm(c - b) / moved
        assert err <= ULP_FACTOR * sens + NORM_FLOOR, (err, sens)


@pytest.mark.parametrize("coded", [True, False], ids=["coded", "plain"])
def test_training_loop_in_bfloat16_matches_reference(coded, capsys):
    ref_train.main(FLAGS[:-2] + (["--coded"] if coded else []))
    want = _printed_losses(capsys.readouterr().out)
    out = port_train.train(port_train.TINY, steps=3, batch=2, seq=32,
                           coded=coded, params=_port_params(),
                           device="cpu", log=lambda msg: None)
    assert len(want) == 3 and all(np.isfinite(out["loss"]))
    np.testing.assert_allclose(out["loss"], want, rtol=BF16_RTOL)


@pytest.mark.parametrize("coded", [True, False], ids=["coded", "plain"])
def test_crash_resume_is_bit_exact(coded, tmp_path):
    """An unbroken run of 5 steps, against 3 steps that checkpoint at
    step 2 and a new run that resumes there."""
    kw = dict(batch=2, seq=16, coded=coded, device="cpu", ckpt_every=2,
              log=lambda msg: None)
    whole = port_train.train(port_train.TINY, steps=5,
                             params=_port_params(), **kw)
    first = port_train.train(port_train.TINY, steps=3, params=_port_params(),
                             ckpt_dir=str(tmp_path), **kw)
    assert first["step"] == [0, 1, 2]
    second = port_train.train(port_train.TINY, steps=5,
                              params=_port_params(), ckpt_dir=str(tmp_path),
                              **kw)
    assert second["start_step"] == 3 and second["step"] == [3, 4]
    assert first["loss"] + second["loss"] == whole["loss"]
    for a, b in zip(tree_leaves(whole["params"]),
                    tree_leaves(second["params"])):
        assert torch.equal(a, b)
    if coded:
        assert first["sim_time"] + second["sim_time"] == whole["sim_time"]


@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32-state", "bf16-state"])
def test_inplace_adamw_is_bit_equal_to_the_functional_update(state_dtype,
                                                             monkeypatch):
    """``adamw(...).update_``, the driver's step, against ``update`` over
    3 steps: float32 and bf16 parameters (one not contiguous), both
    moments and the step equal bit for bit, with weight decay and a
    scheduled lr, in slices smaller than the leaves; each gradient leaf
    is let go once applied, and ``update`` writes into none of its
    inputs."""
    import repro_torch.optim.optimizers as port_opt
    monkeypatch.setattr(port_opt, "INPLACE_SLICE", 64)
    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(5, 7, generator=gen),
              "b": [torch.randn(300, generator=gen).to(torch.bfloat16),
                    torch.randn(2, 3, 4, generator=gen).transpose(0, 1)]}
    opt = adamw(lambda step: 1e-2 / step.float(), weight_decay=0.1,
                state_dtype=state_dtype)
    fun = tree_map(torch.clone, params)
    inplace = tree_map(torch.clone, params)
    s_fun, s_in = opt.init(fun), opt.init(inplace)
    for _ in range(3):
        grads = tree_map(lambda p: torch.randn(p.shape, generator=gen).to(
            p.dtype), params)
        before = [t.clone() for t in tree_leaves((grads, fun, s_fun))]
        inputs = tree_leaves((grads, fun, s_fun))
        fun, s_fun = opt.update(grads, s_fun, fun)
        assert all(torch.equal(a, b) for a, b in zip(before, inputs))
        leaves = [g.clone() for g in tree_leaves(grads)]
        s_in = opt.update_(leaves, s_in, inplace)
        assert leaves == [None] * len(leaves)
    assert int(s_fun.step) == int(s_in.step) == 3
    for a, b in zip(tree_leaves((fun, s_fun.m, s_fun.v)),
                    tree_leaves((inplace, s_in.m, s_in.v))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_command_line_runs_on_the_cpu(capsys):
    out = port_train.main(["--steps", "2", "--batch", "2", "--seq", "16",
                           "--coded", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "arch=tiny" in text and "coded=True" in text
    assert len(out["loss"]) == 2 and all(np.isfinite(out["loss"]))


# --------------------------------------------------------------------- #
# checkpoints, across the two packages and on their own
# --------------------------------------------------------------------- #
def _ref_tree():
    return {"a": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
            "nested": {"b": jnp.asarray([1.5, -2.25, 3.0, 7.0, 0.1],
                                        jnp.bfloat16),
                       "c": jnp.asarray(3, jnp.int32)},
            "lst": [jnp.zeros((2, 2)), jnp.full((1,), 7.0)]}


def _port_tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.tensor([1.5, -2.25, 3.0, 7.0, 0.1],
                                         dtype=torch.bfloat16),
                       "c": torch.tensor(3, dtype=torch.int32)},
            "lst": [torch.zeros((2, 2)), torch.full((1,), 7.0)]}


def _same_values(ref_leaves, port_leaves):
    assert len(ref_leaves) == len(port_leaves)
    for a, b in zip(ref_leaves, port_leaves):
        assert np.dtype(a.dtype).name == str(b.dtype).split(".")[-1]
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    p = str(tmp_path / "ck.npz")
    ref_ckpt.save_pytree(p, _ref_tree(), step=5)
    got = port_ckpt.restore_pytree(p, tree_map(torch.zeros_like,
                                               _port_tree()))
    _same_values(jax.tree.leaves(_ref_tree()), tree_leaves(got))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    p = str(tmp_path / "ck.npz")
    port_ckpt.save_pytree(p, _port_tree(), step=5)
    got = ref_ckpt.restore_pytree(p, jax.tree.map(jnp.zeros_like,
                                                  _ref_tree()))
    _same_values(jax.tree.leaves(got), tree_leaves(_port_tree()))


def test_checkpoint_keys_and_meta_are_the_reference_s(tmp_path):
    pr, pp = str(tmp_path / "r.npz"), str(tmp_path / "p.npz")
    opt_r = ref_train.adamw(1e-3)
    params = _ref_params()
    ref_ckpt.save_pytree(pr, {"params": params,
                              "opt": opt_r.init(params)}, step=7)
    tp = _port_params(params)
    port_ckpt.save_pytree(pp, {"params": tp, "opt": adamw(1e-3).init(tp)},
                          step=7)
    with np.load(pr) as zr, np.load(pp) as zp:
        meta_r = bytes(zr["__meta__"]).decode()
        meta_p = bytes(zp["__meta__"]).decode()
        assert meta_p == meta_r
        assert sorted(zr.files) == sorted(zp.files)
        for f in zr.files:
            np.testing.assert_array_equal(zr[f], zp[f])


def test_crash_resume_step_by_step_is_bit_exact(tmp_path):
    """test_checkpoint.py's case in the port: 10 steps against 5 +
    checkpoint + restore into fresh tensors + 5."""
    rng = np.random.default_rng(0)
    batches = [{"x": torch.from_numpy(rng.standard_normal((8, 16)).astype(
                    np.float32)),
                "y": torch.from_numpy(rng.integers(0, 4, 8).astype(np.int32))}
               for _ in range(10)]
    opt = adamw(lr=1e-2)
    step_fn = make_train_step(port_mlp.mlp_loss, opt)

    def fresh():
        params = port_mlp.init_mlp(torch.Generator().manual_seed(1),
                                   dims=(16, 16, 4), device="cpu")
        return params, opt.init(params)

    p1, s1 = fresh()
    for b in batches:
        p1, s1, _ = step_fn(p1, s1, b)
    p2, s2 = fresh()
    for b in batches[:5]:
        p2, s2, _ = step_fn(p2, s2, b)
    ck = port_ckpt.Checkpointer(str(tmp_path), keep=2)
    ck.save(5, {"params": p2, "opt": s2})
    del p2, s2
    p3, s3 = fresh()
    step, t = ck.restore({"params": p3, "opt": s3})
    p3, s3 = t["params"], t["opt"]
    for b in batches[step:]:
        p3, s3, _ = step_fn(p3, s3, b)
    for a, b in zip(tree_leaves(p1), tree_leaves(p3)):
        assert torch.equal(a, b)


def test_atomicity_no_partial_file(tmp_path):
    p = str(tmp_path / "ck.npz")
    port_ckpt.save_pytree(p, _port_tree())
    assert os.path.exists(p) and not os.path.exists(p + ".tmp")


def test_shape_mismatch_rejected(tmp_path):
    p = str(tmp_path / "ck.npz")
    port_ckpt.save_pytree(p, {"a": torch.zeros((3,))})
    with pytest.raises(ValueError, match="shape mismatch"):
        port_ckpt.restore_pytree(p, {"a": torch.zeros((4,))})
    with pytest.raises(ValueError, match="leaves"):
        port_ckpt.restore_pytree(p, {"a": torch.zeros((3,)),
                                     "b": torch.zeros(())})


def test_retention_and_latest(tmp_path):
    ck = port_ckpt.Checkpointer(str(tmp_path), keep=2)
    for s in [1, 5, 9, 12]:
        ck.save(s, {"x": torch.tensor(s)})
    assert ck.all_steps() == [9, 12]
    assert ck.latest_step() == 12
    step, t = ck.restore({"x": torch.tensor(0)})
    assert step == 12 and int(t["x"]) == 12
    with pytest.raises(FileNotFoundError):
        port_ckpt.Checkpointer(str(tmp_path / "empty")).restore({})


def test_async_save_snapshots_before_returning(tmp_path):
    ck = port_ckpt.Checkpointer(str(tmp_path), keep=3)
    x = torch.full((1000,), 3.0)
    ck.async_save(3, {"x": x})
    x.fill_(-1.0)                         # the snapshot was taken already
    ck.wait()
    step, t = ck.restore({"x": torch.zeros((1000,))})
    assert step == 3 and float(t["x"][0]) == 3.0
