"""The port's LM driver against the JAX package's, loop for loop: the
reference's command line (``repro.launch.train.main``) and the port's
``train`` on a config's float32 twin (compute, parameters and AdamW state
in float32; patched into the reference's module for its command line),
both from the reference's weights (``PRNGKey(0)``).  As
``tests/test_torch_launch_train.py`` holds TINY, the losses and the
parameters after the steps are held to the port's own conditioning:
within ``ULP_FACTOR`` times what a one-ulp nudge of every initial weight
moves them, plus ``NORM_FLOOR`` (AdamW's first step moves an entry whose
gradient cancels to float32 noise by up to ``lr``).  Each family's test
file imports it (``test_torch_{moe,zoo,rwkv,rglru,flash_attention}.py``);
it holds no test itself.
"""
import contextlib
import dataclasses
import re

import jax
import numpy as np
import torch

import repro.configs.base as ref_configs
import repro.launch.train as ref_train
import repro.models.transformer as ref_tf
from repro.configs.base import list_archs as ref_list_archs

import repro_torch.checkpoint as port_ckpt
import repro_torch.configs.base as port_configs
import repro_torch.launch.train as port_train
import repro_torch.models.transformer as port_tf
from repro_torch.optim.optimizers import tree_leaves, tree_map

ref_list_archs()        # fill the reference's registry before anything else
ULP_FACTOR, NORM_FLOOR = 10.0, 1e-6
F32 = dict(compute_dtype="float32", param_dtype="float32",
           opt_state_dtype="float32")
FLAGS = ["--steps", "3", "--batch", "2", "--seq", "32", "--log-every", "1",
         "--ckpt-every", "1"]


def _twins(arch, **over):
    return tuple(dataclasses.replace(
        registry.get_config(arch, reduced=True), **F32, **over)
        for registry in (port_configs, ref_configs))


def _ulp_nudge(tree, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def nudge(x):
        d = torch.randint(-1, 2, x.shape, generator=gen)
        return torch.where(d > 0, torch.nextafter(x, torch.full_like(
            x, np.inf)), torch.where(d < 0, torch.nextafter(
                x, torch.full_like(x, -np.inf)), x))
    return tree_map(nudge, tree)


def _norm(x):
    return float(np.linalg.norm(np.asarray(x, np.float64)))


@contextlib.contextmanager
def _one_torch_thread():
    """The port's CPU training is thousands of small operations: beside
    the other test workers on the same cores, torch's thread pool spins
    (the rwkv6 test took 290 s with its default threads beside five busy
    processes, 30 s with one).  One thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def run_against_reference(arch, coded, flags, tmp_path, capsys,
                          monkeypatch, **over):
    """:func:`_run` with one torch thread."""
    with _one_torch_thread():
        return _run(arch, coded, flags, tmp_path, capsys, monkeypatch,
                    **over)


def _run(arch, coded, flags, tmp_path, capsys, monkeypatch, **over):
    """The reference's command line and the port's ``train`` on ``arch``'s
    float32 twin (``over`` replaces config fields of both) from the same
    weights; asserts the losses and the parameters after the last step
    within the port's conditioning.  ``flags`` must hold ``--steps``,
    ``--batch`` and ``--seq``."""
    cfg, ref_cfg = _twins(arch, **over)
    ref_dir = str(tmp_path / "ref")
    monkeypatch.setattr(ref_train, "get_config",
                        lambda name, reduced=True: ref_cfg)
    ref_train.main(["--arch", arch] + flags + ["--ckpt-dir", ref_dir] +
                   (["--coded"] if coded else []))
    want = [float(x) for x in re.findall(r"loss=([-\d.]+)",
                                         capsys.readouterr().out)]
    p0 = port_tf.params_from_numpy(jax.tree.map(np.asarray, ref_tf.init_params(
        ref_cfg, jax.random.PRNGKey(0))), cfg, device="cpu")
    steps = int(flags[flags.index("--steps") + 1])
    kw = dict(steps=steps, batch=int(flags[flags.index("--batch") + 1]),
              seq=int(flags[flags.index("--seq") + 1]), coded=coded,
              device="cpu", log=lambda msg: None)
    out = port_train.train(cfg, params=p0, **kw)
    nudged = port_train.train(cfg, params=_ulp_nudge(p0), **kw)
    assert len(want) == steps and out["step"] == list(range(steps))
    sens = np.abs(np.subtract(nudged["loss"], out["loss"]))
    np.testing.assert_array_less(np.abs(np.subtract(out["loss"], want)),
                                 5e-5 + 1e-5 * np.abs(want) +
                                 ULP_FACTOR * sens)
    if coded:
        assert all(out["decode_ok"])
    step, t = port_ckpt.Checkpointer(ref_dir).restore(
        {"params": out["params"], "opt": out["opt_state"]})
    assert step == steps - 1
    for a, b, c, x0 in zip(*(tree_leaves(x) for x in (
            t["params"], out["params"], nudged["params"], p0))):
        a, b, c = (y.double().numpy() for y in (a, b, c))
        moved = _norm(a - x0.double().numpy())
        err, sens = _norm(b - a) / moved, _norm(c - b) / moved
        assert err <= ULP_FACTOR * sens + NORM_FLOOR, (err, sens)
    return out

