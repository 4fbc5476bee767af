"""The port's Lyapunov soak and policy search (``repro_torch.sim.soak``,
``repro_torch.sim.policy``, ``repro_torch.sim.frontier``) held against
the JAX package's.

  * ``run_soak`` against ``repro.sim.run_soak`` for both channel families
    (``table``: static and trace channels; ``ge``: Gilbert–Elliott): the
    float32 state after the last slot is bit-equal, and the float64
    moments agree within rtol 1e-12.  The moments are not held bit for
    bit because XLA may contract ``s + t·qtot`` into a fused multiply-add
    and eager torch has no cheap exact float64 one; in these runs they
    come out equal all the same.  Jain indices are within 1e-14: the
    port's ``jain_index`` scales by the largest share before squaring;
  * the harvest draw ``h_lo + h_span·u`` is what the reference's jitted
    scan computes — a fused multiply-add, which differs from the plain
    float32 ``a + b·u`` — and the arrivals ``D_base·(0.5 + u)`` are not
    fused;
  * bitwise chunk invariance at chunks 1, 7 and the whole horizon;
  * ``run_horizon`` over ``soak_observations`` retraces the soak;
  * ``policy_search`` marks the reference's pareto points, and
    ``frontier_dict`` and the frontier twin write the reference's schema;
  * ``SoakLane``/``PolicyCell``/``run_soak`` validation.
"""
import json
import math
from pathlib import Path

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

import repro.sim as ref_sim                                       # noqa: E402
import repro.sim.soak as ref_soak                                 # noqa: E402

import repro_torch.sim as port_sim                                # noqa: E402

from repro_torch.core.lyapunov import run_horizon                 # noqa: E402
from repro_torch.sim import (PolicyCell, SoakLane,                # noqa: E402
                             frontier_dict, policy_grid, policy_search,
                             run_soak, scenario_spec, soak_observations)
from repro_torch.sim import frontier                              # noqa: E402
from repro_torch.sim.soak import (_harvest, _lane_physics,        # noqa: E402
                                  initial_state)

FAMILIES = {
    "table": ("homogeneous", "heterogeneous-rates", "flash-crowd",
              "energy-harvesting-constrained"),
    "ge": ("fading-uplink",),
}
MOMENTS = ("mean_Q", "max_Q", "mean_H", "mean_E", "admitted", "delivered",
           "mean_y", "throughput", "utility")
STATE = ("Q", "H", "E", "R", "R_server")
BASELINE = (Path(__file__).resolve().parents[1] / "benchmarks" / "baselines"
            / "BENCH_lyapunov_frontier.json")


def _lanes(names, sim, V=8.0):
    return [sim.SoakLane(scenario=sim.scenario_spec(n).with_overrides(V=V))
            for n in names]


def _reference_carry(lanes, n_slots, chunk, warmup, seed=0):
    """The reference's final carry, as its ``run_soak`` builds it (which
    returns only the reduced moments)."""
    g = ref_soak._stack_group(lanes)
    key = jax.random.PRNGKey(seed)
    with jax.experimental.enable_x64():
        carry = ref_soak._init_carry(g)
        consts = {k: v for k, v in g.items()
                  if k not in ("kind", "S", "M", "E0", "capacity")}
        for step in range(math.ceil(n_slots / chunk)):
            k0 = step * chunk
            n = min(chunk, n_slots - k0)
            carry = ref_soak._soak_runner(g["kind"], n)(
                carry, consts, jnp.int32(k0), jnp.int32(warmup), key)
        return jax.tree_util.tree_map(np.asarray, carry)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_run_soak_matches_reference(family):
    n, chunk = 400, 150                 # a chunk that does not divide n
    names = FAMILIES[family]
    want = ref_sim.run_soak(_lanes(names, ref_sim), n, chunk=chunk, seed=5)
    got = run_soak(_lanes(names, port_sim), n,
                   chunk=chunk, seed=5, device="cpu")
    state, good, mom = _reference_carry(_lanes(names, ref_sim), n, chunk,
                                        n // 5, seed=5)
    for f in STATE:
        assert np.array_equal(_bits(getattr(state, f)),
                              _bits(got.final[f])), f
    if family == "ge":
        assert np.array_equal(good, got.final["good"])
    for f in MOMENTS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-12, atol=0, err_msg=f)
    np.testing.assert_allclose(got.mean_qtot, mom["s_q"] / (n - n // 5),
                               rtol=1e-12, atol=0)
    # the slope's error bound from rtol 1e-12 on Σq and Σt·q
    w = float(n - n // 5)
    s_t = w * (w - 1.0) / 2.0
    den = w * (w - 1.0) * w * (2.0 * w - 1.0) / 6.0 - s_t * s_t
    tol = 1e-12 * (w * np.abs(mom["s_tq"]) + s_t * np.abs(mom["s_q"])) / den
    assert np.all(np.abs(got.drift_slope - want.drift_slope) <= tol)
    np.testing.assert_allclose(got.jain, want.jain, rtol=1e-14, atol=0)


def test_harvest_and_arrivals_round_as_the_reference_scan():
    rng = np.random.default_rng(0)
    a, b, u = (rng.random((4096, 6)).astype(np.float32) * s
               for s in (3.0, 2.0, 1.0))
    fused = np.asarray(jax.jit(lambda a, b, u: a + b * u)(a, b, u))
    got = _harvest(a, b, u)
    assert np.array_equal(got.view(np.uint32), fused.view(np.uint32))
    # the trap: a plain float32 multiply-then-add differs in many entries
    assert np.count_nonzero(a + b * u != fused) > 100
    D = np.asarray(jax.jit(lambda d, u: d * (0.5 + u))(b, u))
    assert np.array_equal(D, b * (np.float32(0.5) + u))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_soak_is_chunk_invariant(family):
    n = 90
    lanes = _lanes(FAMILIES[family][:2], port_sim)
    base = run_soak(lanes, n, chunk=n, device="cpu")
    for chunk in (1, 7):
        alt = run_soak(lanes, n, chunk=chunk, device="cpu")
        for f in MOMENTS + ("drift_slope", "jain"):
            assert np.array_equal(getattr(base, f), getattr(alt, f)), \
                (chunk, f)
        for f in base.final:
            assert np.array_equal(base.final[f], alt.final[f]), (chunk, f)


def test_soak_observations_and_run_horizon_agree():
    lane = SoakLane(scenario=scenario_spec("flash-crowd")
                    .with_overrides(V=8.0))
    n = 150
    res = run_soak([lane], n, warmup=0, chunk=40, device="cpu")
    obs = soak_observations(lane, n, device="cpu")
    phys = _lane_physics(lane)
    state, dec = run_horizon(initial_state(lane, device="cpu"),
                             phys["sys"], obs)
    for f in STATE:
        assert np.array_equal(getattr(state, f).numpy(),
                              res.final[f][0]), f
    # the soak adds its moments one slot after the other, as cumsum does
    for f, x in (("admitted", dec.d), ("delivered", dec.c)):
        seq = np.cumsum(x.double().numpy(), axis=0)[-1]
        assert np.array_equal(getattr(res, f)[0], seq), f
    # the reference's observations: arrivals and rates bit-equal; its
    # eager harvest is the unfused a + b·u, which its own scan does not use
    ref_lane = ref_sim.SoakLane(scenario=ref_sim.scenario_spec(
        "flash-crowd").with_overrides(V=8.0))
    ref_obs = ref_sim.soak_observations(ref_lane, n)
    assert np.array_equal(obs.D.numpy(), np.asarray(ref_obs.D))
    assert np.array_equal(obs.r.numpy(), np.asarray(ref_obs.r))
    assert np.array_equal(obs.L.numpy(), np.asarray(ref_obs.L))
    np.testing.assert_allclose(obs.E_H.numpy(), np.asarray(ref_obs.E_H),
                               rtol=2 ** -23, atol=0)


def test_policy_search_marks_the_reference_pareto_points():
    names = ("heterogeneous-rates", "homogeneous", "fading-uplink")
    n = 300
    from benchmarks.paper_lyapunov import paper_cells as ref_paper_cells
    want = ref_sim.policy_search(
        ref_sim.policy_grid([ref_sim.scenario_spec(s) for s in names],
                            V_grid=(2.0, 8.0, 32.0)) + ref_paper_cells(), n)
    got = policy_search(
        policy_grid([scenario_spec(s) for s in names],
                    V_grid=(2.0, 8.0, 32.0)) + frontier.paper_cells(), n,
        device="cpu")
    assert [p.pareto for p in got] == [p.pareto for p in want]
    assert any(p.pareto for p in got)
    for p, q in zip(got, want):
        assert (p.cell.scenario.name, p.cell.V) == \
            (q.cell.scenario.name, q.cell.V)
        np.testing.assert_allclose(
            [p.throughput, p.mean_qtot, p.max_Q, p.mean_H, p.utility,
             p.capacity],
            [q.throughput, q.mean_qtot, q.max_Q, q.mean_H, q.utility,
             q.capacity], rtol=1e-12, atol=0)
    doc = frontier_dict(got, n_slots=n, warmup=n // 5)
    ref_doc = ref_sim.frontier_dict(want, n_slots=n, warmup=n // 5)
    assert doc.keys() == ref_doc.keys() and doc["schema"] == ref_doc["schema"]
    assert list(doc["scenarios"]) == list(ref_doc["scenarios"])
    for name, row in doc["scenarios"].items():
        ref_row = ref_doc["scenarios"][name]
        assert row.keys() == ref_row.keys()
        for p, q in zip(row["points"], ref_row["points"]):
            assert p.keys() == q.keys() and p["pareto"] == q["pareto"]


def test_frontier_twin_writes_the_reference_schema(tmp_path):
    out = tmp_path / "frontier.json"
    assert frontier.main(["--slots", "40", "--device", "cpu",
                          "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["schema"] == "lyapunov-frontier/v1"
    assert (doc["n_slots"], doc["warmup"]) == (40, 8)
    # the committed 1M-slot reference run names the same scenarios
    base = json.loads(BASELINE.read_text())["metrics"]
    assert {k.split(".")[1] for k in base} == set(doc["scenarios"])
    for name, row in doc["scenarios"].items():
        assert set(row) == {"points", "max_throughput", "max_jain",
                            "max_drift_ratio", "max_mean_qtot"}
        for p in row["points"]:
            assert set(p) == {"V", "theta_frac", "D_scale", "throughput",
                              "jain", "mean_qtot", "max_Q", "mean_H",
                              "drift_slope", "drift_ratio", "utility",
                              "capacity", "pareto"}
            assert np.isfinite(p["throughput"])
        assert row["max_throughput"] == max(p["throughput"]
                                            for p in row["points"])
    assert doc["config"]["n_cells"] == 24


def test_soak_lane_validation():
    sc = scenario_spec("homogeneous")
    with pytest.raises(TypeError):
        SoakLane(scenario="homogeneous")
    with pytest.raises(ValueError):
        SoakLane(scenario=sc, theta_frac=1.5)
    with pytest.raises(ValueError):
        SoakLane(scenario=sc, load=0.0)
    with pytest.raises(ValueError):
        PolicyCell(scenario=sc, V=-1.0)
    with pytest.raises(TypeError):
        policy_search([SoakLane(scenario=sc)], 10, device="cpu")
    with pytest.raises(ValueError, match="soak groups"):
        run_soak([SoakLane(scenario=sc),
                  SoakLane(scenario=scenario_spec("fading-uplink"))], 100,
                 device="cpu")
    with pytest.raises(ValueError, match="warmup"):
        run_soak([SoakLane(scenario=sc)], 10, warmup=10, device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        run_soak([SoakLane(scenario=sc)], 10, chunk=0, device="cpu")
    with pytest.raises(ValueError, match="at least one lane"):
        run_soak([], 10, device="cpu")
    with pytest.raises(ValueError, match="table"):
        soak_observations(SoakLane(scenario=scenario_spec("fading-uplink")),
                          10, device="cpu")
    assert torch.equal(
        initial_state(SoakLane(scenario=sc), device="cpu").E,
        torch.full((sc.M,), float(sc.energy.E0)))
