"""The port's batched fleet engines, held against its oracle and the JAX
package's engines.

  * ``batched`` and ``hybrid`` equal the port's event-driven oracle
    exactly — every ``EpochResult`` field, every ledger, each seed's RNG
    stream position — on every registry scenario × scheme (3 seeds × 2
    epochs), at any legal chunk and whichever lanes share the batch;
  * against ``repro.sim``'s batched engine the discrete outcomes are
    equal and the float64 ledgers agree within rtol 1e-5, atol 1e-9 (the
    tolerance of ``tests/test_torch_cluster.py``) — in fact every field
    is equal to the last bit, since the scheduler rounds as XLA does —
    and ``FleetSummary`` rows are equal as strings;
  * the facade's engine names and errors, and ``engine="device"`` equal
    to ``engine="batched"`` through each entry point.
"""
import jax
import jax.experimental
import numpy as np
import pytest

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

import repro.sim as ref_sim                                       # noqa: E402

import repro_torch.sim as port_sim                                # noqa: E402
from repro_torch.sim import (ENGINES, BatchedFleet, Fleet,        # noqa: E402
                             build_cluster, scenario_spec, summarize_fleet)
from repro_torch.sim.channel import TAPE_BLOCK                    # noqa: E402
from repro_torch.sim.cluster import SCHEMES                       # noqa: E402

SCENARIOS = sorted(port_sim.available_scenarios())
SEEDS = (0, 101, 1002)
N_EPOCHS = 2
COMM_ARRAYS = ("arrived", "bytes_offered", "bytes_admitted",
               "bytes_transmitted", "queue_residual", "pending_residual",
               "final_energy")
LEDGERS = COMM_ARRAYS[1:]


def assert_exact(a, b, ctx):
    """Every field of two EpochResults equal, floats to the last bit."""
    for f in ("time", "compute_time", "comm_time", "useful_task_time",
              "total_task_time", "executed_tasks", "redundancy",
              "n_stragglers", "stage2_triggered", "decode_ok", "K", "M"):
        assert getattr(a, f) == getattr(b, f), (ctx, f)
    np.testing.assert_array_equal(a.weights, b.weights, err_msg=ctx)
    np.testing.assert_array_equal(a.plan.slot_partition,
                                  b.plan.slot_partition, err_msg=ctx)
    np.testing.assert_array_equal(a.plan.slot_coeff, b.plan.slot_coeff,
                                  err_msg=ctx)
    for f in ("n_slots", "decode_time", "decode_ok", "min_energy",
              "max_overdraft", "idle_slots"):
        assert getattr(a.comm, f) == getattr(b.comm, f), (ctx, f)
    for f in COMM_ARRAYS:
        np.testing.assert_array_equal(getattr(a.comm, f),
                                      getattr(b.comm, f),
                                      err_msg=f"{ctx}: {f}")


def assert_close_to_reference(rr, rp, ctx):
    """Discrete outcomes equal; ledgers within rtol 1e-5, atol 1e-9."""
    assert rr.decode_ok == rp.decode_ok, ctx
    assert rr.stage2_triggered == rp.stage2_triggered, ctx
    assert rr.n_stragglers == rp.n_stragglers, ctx
    assert rr.comm.n_slots == rp.comm.n_slots, ctx
    assert rr.comm.idle_slots == rp.comm.idle_slots, ctx
    np.testing.assert_array_equal(rr.comm.arrived, rp.comm.arrived,
                                  err_msg=ctx)
    assert (rr.time, rr.compute_time, rr.comm_time) == \
        (rp.time, rp.compute_time, rp.comm_time), ctx
    np.testing.assert_array_equal(rr.weights, rp.weights, err_msg=ctx)
    for f in LEDGERS:
        np.testing.assert_allclose(getattr(rr.comm, f), getattr(rp.comm, f),
                                   rtol=1e-5, atol=1e-9,
                                   err_msg=f"{ctx}: {f}")
    np.testing.assert_allclose(
        [rr.comm.min_energy, rr.comm.max_overdraft],
        [rp.comm.min_energy, rp.comm.max_overdraft], rtol=1e-5, atol=1e-6,
        err_msg=ctx)


def _rng_states(clusters):
    return [c.engine.rng.bit_generator.state for c in clusters]


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_batched_and_hybrid_equal_the_oracle(scenario, scheme):
    spec = scenario_spec(scenario)
    oracle = [build_cluster(spec, scheme, s, device="cpu") for s in SEEDS]
    want = [[c.run_epoch(e) for c in oracle] for e in range(N_EPOCHS)]
    for compute in ("batched", "host"):          # engines batched, hybrid
        fleet = BatchedFleet(spec, scheme, SEEDS, compute=compute,
                             device="cpu")
        got = fleet.run(N_EPOCHS)
        for e in range(N_EPOCHS):
            for i, seed in enumerate(SEEDS):
                assert_exact(want[e][i], got[e][i],
                             f"{scenario}/{scheme}/{compute} seed={seed} "
                             f"epoch={e}")
        # each seed's stream sits where the oracle left it
        assert _rng_states(fleet.clusters) == _rng_states(oracle)
        assert fleet.chunk_counters["chunks"] >= N_EPOCHS


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("scenario", ["fading-uplink", "flash-crowd",
                                      "saturated-uplink",
                                      "heterogeneous-rates"])
def test_batched_engine_matches_reference_batched_engine(scenario, scheme):
    """The stateful channel (fading-uplink), the trace channel
    (flash-crowd), the longest epochs (saturated-uplink) and per-worker
    rates: the port on the CPU against ``repro.sim``'s batched engine."""
    ref = ref_sim.Fleet(ref_sim.scenario_spec(scenario)).run(
        scheme, SEEDS, n_epochs=N_EPOCHS, engine="batched")
    port = Fleet(scenario_spec(scenario)).run(
        scheme, SEEDS, n_epochs=N_EPOCHS, engine="batched", device="cpu")
    for e in range(N_EPOCHS):
        for i, seed in enumerate(SEEDS):
            ctx = f"{scenario}/{scheme} seed={seed} epoch={e}"
            assert_close_to_reference(ref.results[e][i], port.results[e][i],
                                      ctx)
            assert_exact(ref.results[e][i], port.results[e][i], ctx)
    assert ref.summary().row() == port.summary().row()


@pytest.mark.parametrize("scenario", ["homogeneous", "bursty-stragglers",
                                      "energy-harvesting-constrained"])
def test_fleet_summary_rows_equal_the_reference(scenario):
    for scheme in ("two-stage", "fractional"):
        want = ref_sim.run_fleet(ref_sim.scenario_spec(scenario), scheme,
                                 n_seeds=3, n_epochs=2)
        got = port_sim.run_fleet(scenario_spec(scenario), scheme,
                                 n_seeds=3, n_epochs=2, device="cpu")
        assert got.row() == want.row()
        assert got.noop_steps == want.noop_steps


def _fleet_results(spec, scheme, chunk, seeds=SEEDS):
    fleet = BatchedFleet(spec, scheme, seeds, chunk=chunk, device="cpu")
    return fleet, fleet.run(N_EPOCHS)


@pytest.mark.parametrize("scenario,scheme", [
    ("fading-uplink", "two-stage"), ("saturated-uplink", "cyclic"),
    ("flash-crowd", "uncoded")])
def test_results_do_not_change_with_the_chunk(scenario, scheme):
    spec = scenario_spec(scenario)
    base_fleet, base = _fleet_results(spec, scheme, None)
    for chunk in (32, 64, TAPE_BLOCK):
        fleet, got = _fleet_results(spec, scheme, chunk)
        for e in range(N_EPOCHS):
            for i in range(len(SEEDS)):
                assert_exact(base[e][i], got[e][i],
                             f"{scenario}/{scheme} chunk={chunk}")
        assert _rng_states(fleet.clusters) == _rng_states(
            base_fleet.clusters)


def test_a_slot_cap_that_is_no_multiple_of_the_chunk():
    """A cap of 45 slots (no power of two) stops lanes inside a chunk:
    the same results at chunks 32, 64 and 256, and the oracle's."""
    spec = scenario_spec("saturated-uplink").with_overrides(max_slots=45)
    oracle = [build_cluster(spec, "two-stage", s, device="cpu")
              for s in SEEDS]
    want = [[c.run_epoch(e) for c in oracle] for e in range(N_EPOCHS)]
    assert any(r.comm.n_slots == 45 for row in want for r in row)
    for chunk in (32, 64, TAPE_BLOCK):
        _, got = _fleet_results(spec, "two-stage", chunk)
        for e in range(N_EPOCHS):
            for i in range(len(SEEDS)):
                assert_exact(want[e][i], got[e][i], f"chunk={chunk}")


def test_chunk_must_divide_tape_block():
    spec = scenario_spec("homogeneous")
    for bad in (0, -32, 48, 100, TAPE_BLOCK * 2):
        with pytest.raises(ValueError, match="divisor of TAPE_BLOCK"):
            BatchedFleet(spec, "two-stage", [0], chunk=bad, device="cpu")


def _hetero_specs():
    """One structural group whose cells differ in comm physics."""
    base = scenario_spec("homogeneous")
    return [base, base.with_overrides(name="het-payload", grad_bytes=2.5),
            scenario_spec("saturated-uplink"),
            scenario_spec("energy-harvesting-constrained"),
            scenario_spec("heterogeneous-rates")]


def test_heterogeneous_stacked_fleet_equals_per_cell_runs():
    seeds = (0, 7)
    specs = _hetero_specs()
    clusters = [build_cluster(sp, "two-stage", s, device="cpu")
                for sp in specs for s in seeds]
    stacked = BatchedFleet(clusters=clusters, device="cpu").run(N_EPOCHS)
    lane = 0
    for sp in specs:
        alone = BatchedFleet(sp, "two-stage", seeds,
                             device="cpu").run(N_EPOCHS)
        for j, seed in enumerate(seeds):
            oracle = build_cluster(sp, "two-stage", seed, device="cpu")
            for e in range(N_EPOCHS):
                ctx = f"{sp.name} seed={seed} epoch={e}"
                assert_exact(alone[e][j], stacked[e][lane + j], ctx)
                assert_exact(oracle.run_epoch(e), stacked[e][lane + j], ctx)
        lane += len(seeds)


def test_fleet_rejects_mixed_structure_and_devices():
    a = build_cluster(scenario_spec("homogeneous"), "two-stage", 0,
                      device="cpu")
    b = build_cluster(scenario_spec("fading-uplink"), "two-stage", 0,
                      device="cpu")
    with pytest.raises(ValueError, match="share structure"):
        BatchedFleet(clusters=[a, b])
    with pytest.raises(ValueError, match="one device"):
        BatchedFleet(clusters=[a], device="meta")


def test_engine_names_and_errors_follow_the_reference():
    assert ENGINES == ref_sim.ENGINES
    assert port_sim.fleet.ENGINES is ENGINES
    spec = scenario_spec("homogeneous")
    with pytest.raises(ValueError, match="engine must be one of"):
        Fleet(spec).run("two-stage", (0,), engine="nope", device="cpu")
    with pytest.raises(ValueError, match="mesh= requires engine='device'"):
        Fleet(spec).run("two-stage", (0,), engine="batched", mesh="auto",
                        device="cpu")
    with pytest.raises(ValueError, match="chunk= is a batched-engine knob"):
        Fleet(spec).run("two-stage", (0,), engine="oracle", chunk=32,
                        device="cpu")
    with pytest.raises(ValueError, match="need seeds"):
        Fleet(spec).run("two-stage", (), device="cpu")


@pytest.mark.parametrize("call", [
    lambda spec, engine: Fleet(spec).run(
        "two-stage", (0, 7), n_epochs=2, engine=engine,
        device="cpu").summary(),
    lambda spec, engine: port_sim.run_fleet(
        spec, n_seeds=2, n_epochs=2, engine=engine, device="cpu"),
    lambda spec, engine: port_sim.sweep(
        [port_sim.ExperimentSpec(scenario=spec, scheme=s, n_seeds=2,
                                 n_epochs=2) for s in SCHEMES],
        engine=engine, device="cpu"),
], ids=["Fleet.run", "run_fleet", "sweep"])
def test_device_engine_equals_the_batched_engine(call):
    spec = scenario_spec("fading-uplink")
    assert call(spec, "device") == call(spec, "batched")


def test_fleet_run_and_wrappers_agree():
    spec = scenario_spec("bursty-stragglers")
    run = Fleet(spec).run("two-stage", (0, 1000), n_epochs=2, device="cpu")
    assert run.summary() == port_sim.run_fleet(
        spec, "two-stage", n_seeds=2, n_epochs=2, device="cpu")
    assert run.seed_major() == [run.results[e][i] for i in range(2)
                                for e in range(2)]
    rows = port_sim.compare_schemes(spec, n_seeds=2, n_epochs=2,
                                    device="cpu")
    assert list(rows) == list(SCHEMES)
    assert rows["two-stage"] == run.summary()
    assert summarize_fleet(spec.name, "two-stage", 2, 2,
                           run.seed_major()) == run.summary()
    direct = port_sim.run_fleet_batched(spec, seeds=(0, 1000), n_epochs=2,
                                        device="cpu")
    for e in range(2):
        for i in range(2):
            assert_exact(run.results[e][i], direct[e][i], "direct")
