"""The port's co-simulated EdgeCluster held against the JAX package's.

Every registry scenario × 4 schemes × 2 seeds × 3 epochs: the discrete
outcomes (decode_ok, slot count, arrival mask, stage-2 trigger, decode
weights, the RNG stream position) must be equal; the float64 ledgers that
accumulate float32 scheduler decisions agree within rtol 1e-5.
"""
import jax
import jax.experimental
import numpy as np
import pytest

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

import repro.sim as ref_sim                                       # noqa: E402

import repro_torch.sim as port_sim                                # noqa: E402

SCHEMES = ("two-stage", "cyclic", "fractional", "uncoded")
SCENARIOS = sorted(ref_sim.available_scenarios())
LEDGERS = ("bytes_offered", "bytes_admitted", "bytes_transmitted",
           "queue_residual", "pending_residual", "final_energy")


def _compare_epoch(rr, rp):
    assert rr.decode_ok == rp.decode_ok
    assert rr.stage2_triggered == rp.stage2_triggered
    assert rr.comm.n_slots == rp.comm.n_slots
    assert rr.comm.idle_slots == rp.comm.idle_slots
    np.testing.assert_array_equal(rr.comm.arrived, rp.comm.arrived)
    assert (rr.time, rr.compute_time, rr.comm_time) == \
        (rp.time, rp.compute_time, rp.comm_time)
    np.testing.assert_array_equal(rr.weights, rp.weights)
    np.testing.assert_array_equal(rr.plan.slot_partition,
                                  rp.plan.slot_partition)
    for f in LEDGERS:
        np.testing.assert_allclose(getattr(rr.comm, f), getattr(rp.comm, f),
                                   rtol=1e-5, atol=1e-9, err_msg=f)
    np.testing.assert_allclose(rr.comm.min_energy, rp.comm.min_energy,
                               rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(rr.comm.max_overdraft,
                               rp.comm.max_overdraft, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_run_epoch_matches_reference(scenario, scheme):
    for seed in (0, 5):
        ref = ref_sim.build_cluster(ref_sim.scenario_spec(scenario), scheme,
                                    seed)
        port = port_sim.build_cluster(port_sim.scenario_spec(scenario),
                                      scheme, seed, device="cpu")
        for epoch in range(3):
            _compare_epoch(ref.run_epoch(epoch), port.run_epoch(epoch))
            assert ref.engine.rng.bit_generator.state == \
                port.engine.rng.bit_generator.state


@pytest.mark.parametrize("scheme", SCHEMES)
def test_conservation_and_energy_invariants(scheme):
    spec = port_sim.scenario_spec("energy-harvesting-constrained")
    cl = port_sim.build_cluster(spec, scheme, 3, device="cpu")
    for epoch in range(3):
        c = cl.run_epoch(epoch).comm
        np.testing.assert_allclose(c.bytes_admitted,
                                   c.bytes_transmitted + c.queue_residual,
                                   rtol=1e-4, atol=1e-5)
        assert c.min_energy >= 0.0 and c.max_overdraft <= 1e-6


def test_faulted_epochs_terminate_with_zero_weights():
    spec = port_sim.scenario_spec("bursty-stragglers").with_overrides(
        fault_prob=0.5)
    ref = ref_sim.build_cluster(
        ref_sim.scenario_spec("bursty-stragglers").with_overrides(
            fault_prob=0.5), "two-stage", 1)
    port = port_sim.build_cluster(spec, "two-stage", 1, device="cpu")
    failed = 0
    for epoch in range(6):
        rr, rp = ref.run_epoch(epoch), port.run_epoch(epoch)
        _compare_epoch(rr, rp)
        if not rp.decode_ok:
            failed += 1
            assert not np.any(rp.weights)
    assert failed > 0


def test_cluster_defaults_to_the_card():
    import inspect
    for fn in (port_sim.build_cluster, port_sim.EdgeCluster.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
