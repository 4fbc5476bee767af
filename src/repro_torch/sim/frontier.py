"""The paper's Lyapunov V-sweep and the per-scenario V-frontier, in torch.

The torch twin of ``benchmarks/paper_lyapunov.py`` (:data:`PAPER_SPEC`,
:func:`paper_cells`, :func:`run_v_sweep`) and
``benchmarks/lyapunov_frontier.py`` (:func:`run_frontier`).  It soaks the
P4–P7 scheduler (``repro_torch.sim.soak``) over the registry scenarios
with distinct soak physics × the default V grid, plus the paper's own
V-sweep scenario, and writes the per-scenario throughput–fairness
frontier in the reference's ``lyapunov-frontier/v1`` schema
(``repro_torch.sim.policy.frontier_dict``; the committed 1M-slot
reference run is ``benchmarks/baselines/BENCH_lyapunov_frontier.json``).

The soak is deterministic given the seed, so runs differ only in horizon:

    PYTHONPATH=src python -m repro_torch.sim.frontier --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.sim.frontier --slots 2000 --out F.json
"""
from __future__ import annotations

import argparse
import json
import platform
import sys
import time

from repro_torch.sim.policy import (frontier_dict, policy_grid,
                                    policy_search)
from repro_torch.sim.scenarios import scenario_spec
from repro_torch.sim.spec import (CommSpec, EnergySpec, ScenarioSpec,
                                  StaticChannelSpec)

__all__ = ["PAPER_SPEC", "V_GRID", "SCENARIOS", "paper_cells",
           "run_v_sweep", "run_frontier"]

#: The paper's C4 V-sweep conditions: worker 0 on a 10x-hot channel, slow
#: slots (T = 1), roomy batteries refilled by a U(1, 3) harvest.  V is
#: only the grid's centre; every cell overrides it.
PAPER_SPEC = ScenarioSpec(
    name="paper-v-sweep",
    description="Paper C4 V-sweep: one hot uplink among M=8, slow slots, "
                "harvest-limited batteries",
    M=8, K=8,
    channel=StaticChannelSpec(rates=(20.0,) + (2.0,) * 7),
    energy=EnergySpec(tx_power=0.5, E0=25.0, E_cap=50.0,
                      harvest_mean=2.0, harvest_jitter=0.5),
    comm=CommSpec(slot_T=1.0, n_subchannels=2.0, V=50.0, xi=0.1, F=200.0,
                  f_max=100.0))

#: The paper's V grid.
V_GRID = (1.0, 10.0, 50.0, 200.0)

#: One registry scenario per distinct soak (comm/energy/channel) physics.
SCENARIOS = ("homogeneous", "heterogeneous-rates",
             "energy-harvesting-constrained", "fading-uplink", "flash-crowd")
FULL_SLOTS = 1_000_000
SMOKE_SLOTS = 50_000


def paper_cells(V_grid=V_GRID):
    """The V-sweep as policy-grid cells."""
    return policy_grid([PAPER_SPEC], V_grid=V_grid)


def run_v_sweep(n_slots: int = 20_000, V_grid=V_GRID, *,
                device="cuda") -> dict:
    """Steady-state V-sweep: ``{V: {throughput, mean_H, mean_Q, jain,
    utility, drift_ratio}}`` (common random numbers across the grid)."""
    points = policy_search(paper_cells(V_grid), n_slots, device=device)
    return {float(p.cell.V): {
        "throughput": p.throughput,
        "mean_H": p.mean_H,
        "mean_Q": p.mean_qtot,
        "jain": p.jain,
        "utility": p.utility,
        "drift_ratio": p.drift_ratio,
    } for p in points}


def run_frontier(n_slots: int, scenarios=SCENARIOS, *, seed: int = 0,
                 device="cuda") -> dict:
    """Soak the frontier grid for ``n_slots`` slots on ``device`` and
    reduce it to the ``lyapunov-frontier/v1`` artifact."""
    cells = policy_grid([scenario_spec(s) for s in scenarios])
    cells += paper_cells()
    t0 = time.perf_counter()
    points = policy_search(cells, n_slots, seed=seed, device=device)
    dt = time.perf_counter() - t0
    out = frontier_dict(points, n_slots=n_slots, warmup=n_slots // 5)
    out["config"] = {
        "seed": seed, "n_cells": len(cells), "seconds": dt,
        "slots_per_sec": len(cells) * n_slots / dt, "device": str(device),
        "platform": platform.platform(),
        "python": platform.python_version()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help=f"{SMOKE_SLOTS} slots instead of {FULL_SLOTS}")
    ap.add_argument("--slots", type=int, default=None,
                    help="override the soak horizon")
    ap.add_argument("--scenarios", nargs="*", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the JSON here")
    args = ap.parse_args(argv)
    n_slots = args.slots if args.slots is not None else (
        SMOKE_SLOTS if args.smoke else FULL_SLOTS)
    res = run_frontier(n_slots, scenarios=tuple(args.scenarios or SCENARIOS),
                       seed=args.seed, device=args.device)
    cfg = res["config"]
    print(f"{cfg['n_cells']} cells x {n_slots} slots on {args.device} in "
          f"{cfg['seconds']:.1f}s ({cfg['slots_per_sec']:.3e} lane-slots/s)")
    for name, row in res["scenarios"].items():
        pareto_V = ["%g" % p["V"] for p in row["points"] if p["pareto"]]
        print(f"{name:32s} max_thru={row['max_throughput']:8.3f} "
              f"max_jain={row['max_jain']:.3f} "
              f"qtot<= {row['max_mean_qtot']:8.1f} pareto_V={pareto_V}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
            f.write("\n")
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
