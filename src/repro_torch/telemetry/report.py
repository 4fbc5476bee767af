"""Fleet telemetry report: JSONL event streams → summary table.

    PYTHONPATH=src python -m repro_torch.telemetry.report telemetry.jsonl [...]

Reads one or more JSONL files written by
:class:`~repro_torch.telemetry.sinks.JsonlSink` (each ``run`` header starts a
new run; several runs may share a file) and renders one table row per
(scenario × scheme × engine) run: Jain fairness over admitted bytes, mean
queue backlog at epoch end, mean utilization, decode failure rate, mean
comm slots and the recompile total — the fleet-health view the ROADMAP's
scheduler-soak and policy-search items will read their regression bounds
off.

The module is also importable: :func:`load_runs` / :func:`fleet_table`
power the walkthrough example and the tests without touching the CLI.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Iterable, List

import numpy as np

from repro_torch.telemetry.metrics import jain_index

__all__ = ["load_runs", "run_row", "fleet_table", "main"]

_HEADER = (f"{'scenario':<28s} {'scheme':<10s} {'engine':<8s} "
           f"{'lanes':>5s} {'epochs':>6s} {'fairness':>8s} "
           f"{'backlog':>8s} {'util':>6s} {'fail':>5s} {'noop':>5s} "
           f"{'slots':>7s} {'compiles':>8s}")


def load_runs(paths: Iterable[str]) -> List[dict]:
    """Parse JSONL event streams into per-run dicts:
    ``{"meta": .., "epochs": [..], "spans": [..], "compiles": {..}}``."""
    runs: List[dict] = []
    run: dict = None
    for path in paths:
        with open(path) as f:
            for i, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError as e:
                    raise ValueError(f"{path}:{i + 1}: not JSON: {e}")
                kind = ev.pop("type", None)
                if kind == "run":
                    run = {"meta": ev, "epochs": [], "spans": [],
                           "slots": [], "compiles": {}}
                    runs.append(run)
                elif run is None:
                    raise ValueError(f"{path}:{i + 1}: {kind!r} event "
                                     f"before any 'run' header")
                elif kind == "epoch":
                    run["epochs"].append(ev)
                elif kind == "span":
                    run["spans"].append(ev)
                elif kind == "slot":
                    run["slots"].append(ev)
                elif kind == "compiles":
                    for k, v in ev.get("counts", {}).items():
                        run["compiles"][k] = run["compiles"].get(k, 0) + v
                # unknown event types are ignored (schema-forward)
    return runs


def run_row(run: dict) -> Dict[str, object]:
    """One run's summary cells (the table's single source of truth)."""
    meta, epochs = run["meta"], run["epochs"]
    admitted = np.sum([e["bytes_admitted"] for e in epochs
                       if "bytes_admitted" in e], axis=0)
    residuals = [np.mean(e["queue_residual"]) for e in epochs
                 if "queue_residual" in e]
    slots = [e["n_slots"] for e in epochs if "n_slots" in e]
    return {
        "scenario": str(meta.get("scenario", "?")),
        "scheme": str(meta.get("scheme", "?")),
        "engine": str(meta.get("engine", "?")),
        "lanes": int(meta.get("n_seeds", 0)),
        "epochs": len(epochs),
        "fairness": jain_index(admitted) if np.ndim(admitted) else 1.0,
        "backlog": float(np.mean(residuals)) if residuals else 0.0,
        "utilization": (float(np.mean([e["utilization"] for e in epochs]))
                        if epochs else 0.0),
        "decode_failure_rate": (
            sum(1 for e in epochs if not e["decode_ok"])
            / max(len(epochs), 1)),
        # absolute count of the paper's no-op steps: epochs that burned
        # wall-clock without a model update (decode failed)
        "noop_steps": sum(1 for e in epochs if not e["decode_ok"]),
        "mean_slots": float(np.mean(slots)) if slots else 0.0,
        "compiles": int(sum(run["compiles"].values())),
    }


def fleet_table(runs: Iterable[dict]) -> str:
    """Render the fleet summary table (one line per recorded run)."""
    lines = [_HEADER, "-" * len(_HEADER)]
    for run in runs:
        r = run_row(run)
        lines.append(
            f"{r['scenario']:<28s} {r['scheme']:<10s} {r['engine']:<8s} "
            f"{r['lanes']:>5d} {r['epochs']:>6d} {r['fairness']:>8.4f} "
            f"{r['backlog']:>8.3f} {r['utilization']:>6.3f} "
            f"{r['decode_failure_rate']:>5.2f} {r['noop_steps']:>5d} "
            f"{r['mean_slots']:>7.1f} {r['compiles']:>8d}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="+",
                    help="telemetry JSONL file(s) from a JsonlSink")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary rows as JSON instead of a table")
    args = ap.parse_args(argv)
    runs = load_runs(args.paths)
    if not runs:
        print("no runs found in", ", ".join(args.paths))
        return 1
    if args.json:
        print(json.dumps([run_row(r) for r in runs], indent=2))
    else:
        print(fleet_table(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
