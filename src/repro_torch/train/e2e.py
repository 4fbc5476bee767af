"""End-to-end coded training: time to a target loss on the simulated clock.

The torch twin of ``benchmarks/train_e2e.py::run_benchmark``.  It trains a
transformer through the co-simulated uplink under all four coding schemes
(:class:`~repro_torch.train.CodedTrainer`) on ``bursty-stragglers`` and
reports the paper's Fig 5e/6e metric: *time to target loss* per scheme,
averaged over a small seed fleet (every scheme replays the same seeds).

Every scheme recovers the exact full-batch gradient whenever its decode
succeeds, so the loss at each epoch is the same across schemes; what
differs is the *simulated* wall-clock each epoch burns.  The target loss
is the worst over schemes of the best loss each reached.  The simulated
clock is deterministic given the seeds, so the speedups equal the
reference's (``benchmarks/baselines/BENCH_train.json``: 1.344x vs
uncoded, 1.40x vs cyclic with TINY, 5 seeds x 2 epochs).

    PYTHONPATH=src python -m repro_torch.train.e2e --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.coded_step import _value_and_grad
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.models.transformer import init_params, loss_fn
from repro_torch.optim.optimizers import adamw
from repro_torch.sim.cluster import SCHEMES
from repro_torch.sim.scenarios import scenario_spec
from repro_torch.train.coded_trainer import CodedTrainer
from repro_torch.train.curves import curve_dict, loss_curve, time_to_target

__all__ = ["TINY", "reduced_config", "run_benchmark"]

#: Tiny stablelm-shaped config (2 layers, ~100k params); the payload is
#: still measured from the flattened gradient.
TINY = ModelConfig(
    name="train-e2e-tiny", family="dense",
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
    d_ff=128, vocab=128, remat="none", compute_dtype="float32")


def reduced_config() -> ModelConfig:
    """The stablelm-1.6b REDUCED config, float32 and without remat."""
    from repro_torch.configs.stablelm_1_6b import REDUCED
    return dataclasses.replace(REDUCED, remat="none",
                               compute_dtype="float32")


def run_benchmark(cfg: ModelConfig, *, scenario: str = "bursty-stragglers",
                  n_seeds: int = 5, n_epochs: int = 2, schemes=SCHEMES,
                  params=None, device="cuda") -> dict:
    """``params`` (default: :func:`init_params` of seed 0) start every
    trainer; one backward and one optimizer are shared by all of them."""
    spec = scenario_spec(scenario)
    dataset = SyntheticLMDataset(K=spec.K, examples_per_partition=2,
                                 seq_len=32, vocab=cfg.vocab, seed=0,
                                 device=device)
    if params is None:
        params = init_params(
            cfg, torch.Generator(device=device).manual_seed(0), device)
    grad_fn = _value_and_grad(lambda p, batch: loss_fn(p, batch, cfg))
    optimizer = adamw(1e-2)

    t_host = time.perf_counter()
    runs: dict = {s: [] for s in schemes}
    trainers: dict = {}
    for scheme in schemes:
        for seed in range(n_seeds):
            tr = CodedTrainer(cfg, spec, scheme, dataset, optimizer,
                              params=params, seed=seed, grad_fn=grad_fn,
                              device=device)
            tr.run(n_epochs)
            runs[scheme].append(tr.logs)
            trainers[scheme] = tr
    wall = time.perf_counter() - t_host

    # worst-over-schemes best loss: a target every scheme reached
    bests = []
    for logs_list in runs.values():
        for logs in logs_list:
            finite = [v for v in loss_curve(logs)[1] if not math.isnan(v)]
            bests.append(min(finite) if finite else math.inf)
    target = max(bests)

    out = {
        "scenario": scenario,
        "model": cfg.name,
        "device": str(torch.device(device)),
        "param_dim": trainers[schemes[0]].partition.D,
        "grad_bytes_units": trainers[schemes[0]].grad_bytes,
        "n_seeds": n_seeds,
        "n_epochs": n_epochs,
        "target_loss": float(target),
        "wall_seconds": wall,
        "schemes": {},
    }
    ttt = {}
    for scheme in schemes:
        per_seed = [time_to_target(logs, target) for logs in runs[scheme]]
        mean_ttt = (float(np.mean(per_seed))
                    if all(math.isfinite(t) for t in per_seed) else math.inf)
        ttt[scheme] = mean_ttt
        out["schemes"][scheme] = {
            "time_to_target": mean_ttt,
            "times_to_target": [t if math.isfinite(t) else None
                                for t in per_seed],
            "noop_epochs": sum(sum(1 for log in logs if not log.decode_ok)
                               for logs in runs[scheme]),
            "curves": [curve_dict(logs) for logs in runs[scheme]],
        }

    def speedup(base: str) -> float:
        ts = ttt.get("two-stage", math.inf)
        if not math.isfinite(ts) or ts <= 0:
            return 0.0
        tb = ttt.get(base, math.inf)
        return tb / ts if math.isfinite(tb) else math.inf
    if "two-stage" in schemes:
        if "uncoded" in schemes:
            out["speedup_vs_uncoded"] = speedup("uncoded")
        if "cyclic" in schemes:
            out["speedup_vs_cyclic"] = speedup("cyclic")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny 2-layer model")
    ap.add_argument("--seeds", type=int, default=5,
                    help="seed fleet size per scheme")
    ap.add_argument("--epochs", type=int, default=None,
                    help="epochs per run (default: 2 smoke, 4 full)")
    ap.add_argument("--scenario", default="bursty-stragglers")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write JSON here")
    args = ap.parse_args(argv)

    cfg = TINY if args.smoke else reduced_config()
    n_epochs = args.epochs if args.epochs is not None else (
        2 if args.smoke else 4)
    result = run_benchmark(cfg, scenario=args.scenario, n_seeds=args.seeds,
                           n_epochs=n_epochs, device=args.device)
    print(f"train-e2e [{result['model']}] on {result['scenario']} "
          f"({result['device']}): D={result['param_dim']} "
          f"({result['grad_bytes_units']:.3f} payload units), target loss "
          f"{result['target_loss']:.4f}")
    for scheme, row in result["schemes"].items():
        print(f"  {scheme:<10s} time-to-target={row['time_to_target']:8.2f}"
              f" noop={row['noop_epochs']}")
    for key in ("speedup_vs_uncoded", "speedup_vs_cyclic"):
        if key in result:
            print(f"  two-stage {key.replace('_', ' ')}: {result[key]:.2f}x")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
