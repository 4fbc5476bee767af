"""The port's grid sweeps: runner-sharing groups, per-cell rows.

``sweep()`` stacks structurally compatible cells (same scheme, worker
count and channel kind) into one batched fleet.  Its ``FleetSummary``
rows must equal per-cell ``run_experiment`` exactly, and it builds at
most one chunk runner per group (``scan_trace_count``).  Rows also equal
the JAX package's ``sweep`` on a small grid.
"""
import jax
import jax.experimental
import pytest

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

import repro.sim as ref_sim                                       # noqa: E402

from repro_torch.sim import (ExperimentSpec, compat_key,          # noqa: E402
                             plan_groups, reset_scan_compile_cache,
                             run_experiment, scan_trace_count,
                             scenario_spec, sweep)
from repro_torch.sim.cluster import SCHEMES                       # noqa: E402

#: Two registry scenarios of one structure (M, static channel) but
#: different compute heterogeneity.
COMPATIBLE = ("homogeneous", "bursty-stragglers")
CPU = dict(device="cpu")


def _grid(n_seeds=3, n_epochs=2, schemes=SCHEMES, sim=None):
    spec, exp = ((scenario_spec, ExperimentSpec) if sim is None
                 else (sim.scenario_spec, sim.ExperimentSpec))
    return [exp(scenario=spec(name), scheme=scheme, n_seeds=n_seeds,
                n_epochs=n_epochs)
            for name in COMPATIBLE for scheme in schemes]


def _builds(fn):
    reset_scan_compile_cache()
    before = scan_trace_count()
    out = fn()
    return out, scan_trace_count() - before


def test_grouping_is_structural_not_parametric():
    grid = _grid(n_seeds=2)
    groups = plan_groups(grid)
    assert len(groups) == len(SCHEMES)
    assert all(len(g) == len(COMPATIBLE) for g in groups)
    assert compat_key(grid[0]) == compat_key(grid[len(SCHEMES)])
    cells = [ExperimentSpec(scenario=scenario_spec(n), n_seeds=2)
             for n in ("homogeneous", "saturated-uplink", "fading-uplink")]
    assert plan_groups(cells) == [[0, 1], [2]]
    assert plan_groups(cells, key=lambda c: c.scenario.M) == [[0, 1, 2]]
    with pytest.raises(TypeError, match="ExperimentSpec"):
        plan_groups([cells[0], "homogeneous"])
    with pytest.raises(TypeError, match="ExperimentSpec"):
        sweep([cells[0], "homogeneous"], engine="oracle", **CPU)


def test_rows_equal_per_cell_runs_one_runner_per_group():
    """2 compatible scenarios × 4 schemes: rows equal per-cell
    ``run_experiment`` exactly (dataclass ``==`` over floats), with one
    runner build for all four groups (equal (S, M) and channel kind)."""
    grid = _grid()
    per_cell = [run_experiment(c, **CPU) for c in grid]
    rows, builds = _builds(lambda: sweep(grid, **CPU))
    assert rows == per_cell
    assert 0 < builds <= len(plan_groups(grid))
    assert builds == 1
    assert [(r.scenario, r.scheme) for r in rows] == \
        [(c.scenario.name, c.scheme) for c in grid]
    hybrid = sweep(grid, engine="hybrid", **CPU)
    assert hybrid == rows


def test_rows_equal_the_references_sweep():
    grid = _grid(n_seeds=2, n_epochs=1, schemes=("two-stage", "uncoded"))
    ref_grid = _grid(n_seeds=2, n_epochs=1,
                     schemes=("two-stage", "uncoded"), sim=ref_sim)
    rows = sweep(grid, **CPU)
    want = ref_sim.sweep(ref_grid)
    assert [r.row() for r in rows] == [w.row() for w in want]


def test_payload_axis_and_heterogeneous_physics_share_one_fleet():
    base = scenario_spec("homogeneous")
    grid = [ExperimentSpec(
                scenario=base.with_overrides(name=f"homogeneous-gb{gb}",
                                             grad_bytes=gb),
                n_seeds=2, n_epochs=1)
            for gb in (0.5, 1.0, 2.0)]
    grid += [ExperimentSpec(scenario=scenario_spec(n), n_seeds=2,
                            n_epochs=1)
             for n in ("saturated-uplink", "heterogeneous-rates",
                       "energy-harvesting-constrained")]
    assert len(plan_groups(grid)) == 1
    per_cell = [run_experiment(c, **CPU) for c in grid]
    rows, builds = _builds(lambda: sweep(grid, **CPU))
    assert builds == 1
    assert rows == per_cell
    assert rows[0].mean_slots <= rows[2].mean_slots


def test_mixed_kinds_and_epoch_counts():
    """Static and Gilbert–Elliott cells split into two groups, one runner
    each; a shorter cell in a group keeps its standalone rows."""
    grid = [ExperimentSpec(scenario=scenario_spec(n), n_seeds=2, n_epochs=1)
            for n in ("homogeneous", "saturated-uplink", "fading-uplink")]
    grid.append(ExperimentSpec(scenario=scenario_spec("bursty-stragglers"),
                               n_seeds=2, n_epochs=3))
    assert len(plan_groups(grid)) == 2
    per_cell = [run_experiment(c, **CPU) for c in grid]
    rows, builds = _builds(lambda: sweep(grid, **CPU))
    assert builds == 2
    assert rows == per_cell


def test_oracle_engine_agrees_with_batched():
    grid = _grid(n_seeds=2, n_epochs=1, schemes=("two-stage", "cyclic"))
    assert sweep(grid, engine="oracle", **CPU) == sweep(grid, **CPU)


def test_empty_grid_and_single_cell_sweep():
    assert sweep([], **CPU) == []
    assert sweep([], engine="oracle", **CPU) == []
    cell = ExperimentSpec(scenario=scenario_spec("homogeneous"),
                          n_seeds=2, n_epochs=1)
    rows, builds = _builds(lambda: sweep([cell], **CPU))
    assert rows == [run_experiment(cell, **CPU)]
    assert builds == 1
    with pytest.raises(ValueError, match="engine must be one of"):
        sweep([cell], engine="warp", **CPU)
