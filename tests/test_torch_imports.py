"""Import hygiene of the port: importing every module of ``repro_torch``,
and ``chip_smoke.py``, loads neither ``jax`` nor the JAX package
``repro``, and ``repro_torch.launch``'s names of submodules stay
modules."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, importlib.util, json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
launch = sys.modules["repro_torch.launch"]
kinds = {n: type(getattr(launch, n)).__name__
         for n in ("serve", "train", "steps", "cells")}
print(json.dumps({"imported": names, "bad": bad, "launch": kinds}))
"""


def test_port_imports_neither_jax_nor_the_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE,
                          str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    # the launch package binds no function to a submodule's name
    assert got["launch"] == dict.fromkeys(("serve", "train", "steps",
                                           "cells"), "module")
    for mod in ("repro_torch.kernels.coded_reduce.ops",
                "repro_torch.core.lyapunov.scheduler",
                "repro_torch.sim.cluster", "repro_torch.train.coded_trainer",
                "repro_torch.models.mlp", "repro_torch.optim.optimizers",
                "repro_torch.data.pipeline",
                "repro_torch.kernels.flash_attention.ops",
                "repro_torch.kernels.flash_attention.ref",
                "repro_torch.models.common", "repro_torch.models.attention",
                "repro_torch.models.transformer", "repro_torch.configs.base",
                "repro_torch.configs.stablelm_1_6b",
                "repro_torch.train.curves", "repro_torch.train.e2e",
                "repro_torch.configs.rwkv6_1_6b", "repro_torch.models.rwkv6",
                "repro_torch.kernels.rwkv6_wkv.ops",
                "repro_torch.kernels.rwkv6_wkv.ref",
                "repro_torch.launch.serve",
                "repro_torch.configs.recurrentgemma_2b",
                "repro_torch.models.rglru",
                "repro_torch.kernels.rglru_scan.ops",
                "repro_torch.kernels.rglru_scan.ref",
                "repro_torch.core.fel", "repro_torch.core.coded_step",
                "repro_torch.checkpoint.checkpointer",
                "repro_torch.launch.train",
                "repro_torch.telemetry", "repro_torch.telemetry.metrics",
                "repro_torch.telemetry.compilation",
                "repro_torch.telemetry.recorder",
                "repro_torch.telemetry.sinks", "repro_torch.telemetry.trace",
                "repro_torch.telemetry.report",
                "repro_torch.telemetry.runner",
                "repro_torch.sim.batched_compute", "repro_torch.sim.batched",
                "repro_torch.sim.fleet", "repro_torch.sim.montecarlo",
                "repro_torch.sim.sweep", "repro_torch.sim.threefry",
                "repro_torch.sim.device_epoch", "repro_torch.sim.soak",
                "repro_torch.sim.policy", "repro_torch.sim.frontier",
                "repro_torch.models.moe", "repro_torch.data.batches",
                "repro_torch.configs.granite_moe_3b_a800m",
                "repro_torch.configs.llama4_maverick_400b_a17b",
                "repro_torch.configs.qwen3_14b",
                "repro_torch.configs.deepseek_67b",
                "repro_torch.configs.gemma3_12b",
                "repro_torch.configs.internvl2_26b",
                "repro_torch.configs.hubert_xlarge",
                "repro_torch.kernels.backward_ab",
                "repro_torch.compress", "repro_torch.compress.quantize",
                "repro_torch.launch.steps", "repro_torch.launch.cells",
                "repro_torch.analysis", "repro_torch.analysis.roofline"):
        assert mod in got["imported"]
