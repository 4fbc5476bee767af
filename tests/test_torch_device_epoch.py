"""The port's device-resident epoch tail (``repro_torch.sim.device_epoch``)
held against its host tail and against the JAX package's device engine.

  * :func:`_pairwise_last` is numpy's pairwise ``.sum(-1)`` bit for bit,
    in float32 and float64, at every size regime (numpy arrays and torch
    tensors alike);
  * the stacked count/mask decode gates equal each job's exact
    ``is_decodable`` on random arrival masks;
  * ``engine="device"`` equals the port's host tail and ``repro.sim``'s
    device engine bit for bit — every ``EpochResult`` field, every ledger
    — on every registry scenario × scheme (2 seeds × 2 epochs), and
    leaves each seed's RNG stream where the host tail does;
  * the ``tail=``/``mesh=`` errors, the fallback to the host tail for
    per-slot series telemetry, and the host's waits for the device (one a
    chunk, one an epoch).
"""
import dataclasses

import jax
import jax.experimental
import numpy as np
import pytest
import torch

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

import repro.sim as ref_sim                                       # noqa: E402

from repro_torch.sim import (BatchedFleet, Fleet,                 # noqa: E402
                             available_scenarios, build_cluster,
                             scenario_spec)
from repro_torch.sim.channel import TAPE_BLOCK                    # noqa: E402
from repro_torch.sim.cluster import SCHEMES                       # noqa: E402
from repro_torch.sim.device_epoch import (_gate,                  # noqa: E402
                                          _pairwise_last, _stack_gates,
                                          device_comm)
from repro_torch.telemetry.recorder import (FleetRecorder,        # noqa: E402
                                            TelemetryConfig)

SEEDS = (0, 101)
N_EPOCHS = 2
COMM_ARRAYS = ("arrived", "bytes_offered", "bytes_admitted",
               "bytes_transmitted", "queue_residual", "pending_residual",
               "final_energy")


def assert_exact(a, b, ctx):
    """Every field of two EpochResults equal, floats to the last bit."""
    for f in ("time", "compute_time", "comm_time", "useful_task_time",
              "total_task_time", "executed_tasks", "redundancy",
              "n_stragglers", "stage2_triggered", "decode_ok", "K", "M"):
        assert getattr(a, f) == getattr(b, f), (ctx, f)
    np.testing.assert_array_equal(a.weights, b.weights, err_msg=ctx)
    for f in ("n_slots", "decode_time", "decode_ok", "min_energy",
              "max_overdraft", "idle_slots"):
        assert getattr(a.comm, f) == getattr(b.comm, f), (ctx, f)
    for f in COMM_ARRAYS:
        np.testing.assert_array_equal(getattr(a.comm, f),
                                      getattr(b.comm, f),
                                      err_msg=f"{ctx}: {f}")


# --------------------------------------------------------------------- #
# numpy-bitwise pairwise summation
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 127, 128, 129, 300])
def test_pairwise_last_is_bitwise_numpy_sum(n, dtype):
    rng = np.random.default_rng(n)
    # mixed magnitudes make every association order round differently
    x = (rng.standard_normal((5, n))
         * 10.0 ** rng.integers(-6, 7, (5, n))).astype(dtype)
    want = x.sum(-1)
    assert np.array_equal(_pairwise_last(x), want)
    got = _pairwise_last(torch.from_numpy(x)).numpy()
    assert got.dtype == dtype
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


# --------------------------------------------------------------------- #
# stacked decode gates ≡ the exact per-job gate
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("scenario", sorted(available_scenarios()))
def test_stacked_gate_matches_exact_gate_on_random_masks(scenario, scheme):
    spec = scenario_spec(scenario)
    clusters = [build_cluster(spec, scheme, s, device="cpu")
                for s in (0, 101, 1002)]
    rng = np.random.default_rng(7)
    M = clusters[0].M
    for epoch in range(2):          # epoch 1 exercises stage-2 variety
        jobs = [c.comm_job(epoch) for c in clusters]
        g = _stack_gates(jobs, M)
        for i, job in enumerate(jobs):
            masks = rng.random((200, M)) < rng.uniform(0.1, 0.9, (200, 1))
            lane = {k: torch.from_numpy(np.repeat(getattr(g, k)[i:i + 1],
                                                  200, axis=0))
                    for k in ("must", "cnt", "need", "has_work", "member",
                              "gvalid")}
            got = _gate(lane, torch.from_numpy(masks)).numpy()
            want = [job.is_decodable(m) for m in masks]
            assert got.tolist() == want, f"{scenario}/{scheme} lane {i}"


def test_stack_gates_rejects_missing_gates():
    spec = scenario_spec("homogeneous")
    clusters = [build_cluster(spec, "two-stage", s, device="cpu")
                for s in SEEDS]
    jobs = [c.comm_job(0) for c in clusters]
    jobs[1] = dataclasses.replace(jobs[1], gate=None)
    with pytest.raises(ValueError, match=r"lanes \[1\]"):
        _stack_gates(jobs, clusters[0].M)
    with pytest.raises(ValueError, match="gate"):
        device_comm(clusters, jobs)


# --------------------------------------------------------------------- #
# the device tail against the host tail and the reference's device engine
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("scenario", sorted(available_scenarios()))
def test_device_tail_equals_host_tail_and_reference(scenario, scheme):
    spec = scenario_spec(scenario)
    host = BatchedFleet(spec, scheme, SEEDS, device="cpu")
    dev = BatchedFleet(spec, scheme, SEEDS, tail="device", device="cpu")
    want, got = host.run(N_EPOCHS), dev.run(N_EPOCHS)
    ref = ref_sim.Fleet(ref_sim.scenario_spec(scenario)).run(
        scheme, SEEDS, n_epochs=N_EPOCHS, engine="device")
    for e in range(N_EPOCHS):
        for i, seed in enumerate(SEEDS):
            ctx = f"{scenario}/{scheme} seed={seed} epoch={e}"
            assert_exact(want[e][i], got[e][i], ctx + " host tail")
            assert_exact(ref.results[e][i], got[e][i], ctx + " reference")
    assert ([c.engine.rng.bit_generator.state for c in dev.clusters]
            == [c.engine.rng.bit_generator.state for c in host.clusters])


def test_device_tail_is_chunk_invariant_at_a_ragged_cap():
    """A cap of 45 slots stops lanes inside a chunk: the oracle's results
    at chunks 32, 64 and the full tape block."""
    spec = scenario_spec("saturated-uplink").with_overrides(max_slots=45)
    oracle = [build_cluster(spec, "two-stage", s, device="cpu")
              for s in SEEDS]
    want = [[c.run_epoch(e) for c in oracle] for e in range(N_EPOCHS)]
    assert any(r.comm.n_slots == 45 for row in want for r in row)
    for chunk in (32, 64, TAPE_BLOCK):
        got = BatchedFleet(spec, "two-stage", SEEDS, chunk=chunk,
                           tail="device", device="cpu").run(N_EPOCHS)
        for e in range(N_EPOCHS):
            for i in range(len(SEEDS)):
                assert_exact(want[e][i], got[e][i], f"chunk={chunk}")


def test_host_waits_once_a_chunk_and_once_an_epoch():
    spec = scenario_spec("saturated-uplink")
    fleet = BatchedFleet(spec, "two-stage", SEEDS, chunk=32, tail="device",
                         device="cpu")
    fleet.run(N_EPOCHS)
    cc = fleet.chunk_counters
    assert cc["chunks"] > N_EPOCHS
    assert cc["host_waits"] == cc["chunks"] + N_EPOCHS
    assert cc["slots"] == 32 * cc["chunks"]


# --------------------------------------------------------------------- #
# knobs, errors and the series-telemetry fallback
# --------------------------------------------------------------------- #
def test_tail_and_mesh_errors():
    spec = scenario_spec("homogeneous")
    with pytest.raises(ValueError, match="tail must be"):
        BatchedFleet(spec, "two-stage", SEEDS, tail="gpu", device="cpu")
    with pytest.raises(ValueError, match="mesh= requires tail='device'"):
        BatchedFleet(spec, "two-stage", SEEDS, mesh="auto", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BatchedFleet(spec, "two-stage", SEEDS, tail="device", mesh="auto",
                     device="cpu")
    with pytest.raises(NotImplementedError, match="launch/mesh"):
        Fleet(spec).run("two-stage", SEEDS, engine="device", mesh="auto",
                        device="cpu")


def test_series_telemetry_falls_back_to_host_tail():
    """Per-slot series need the chunk outputs the device tail never copies
    to the host: a series-collecting recorder takes the host tail — same
    results, series recorded; a series-free one keeps the device tail."""
    spec = scenario_spec("homogeneous")
    rec = FleetRecorder(TelemetryConfig(series=True))
    a = BatchedFleet(spec, "two-stage", SEEDS, tail="device",
                     telemetry=rec, device="cpu")
    b = BatchedFleet(spec, "two-stage", SEEDS, tail="device", device="cpu")
    ra, rb = a.run(1), b.run(1)
    for x, y in zip(ra[0], rb[0]):
        assert_exact(x, y, "series fallback")
    assert rec.series_keys()
    assert a.chunk_counters["host_waits"] == a.chunk_counters["chunks"]
    rec2 = FleetRecorder(TelemetryConfig(series=False))
    c = BatchedFleet(spec, "two-stage", SEEDS, tail="device",
                     telemetry=rec2, device="cpu")
    rc = c.run(1)
    for x, y in zip(rc[0], rb[0]):
        assert_exact(x, y, "series-free recorder")
    assert not rec2.series_keys()
    assert c.chunk_counters["host_waits"] == c.chunk_counters["chunks"] + 1


@pytest.mark.parametrize("series", [True, False])
def test_record_fleet_on_the_device_engine(series):
    """``record_fleet(engine="device")``: the batched engine's results,
    with series (host tail) or without (device tail)."""
    from repro_torch.telemetry import record_fleet
    spec = scenario_spec("fading-uplink")
    cfg = TelemetryConfig(series=series)
    got, rec = record_fleet(spec, seeds=SEEDS, n_epochs=N_EPOCHS,
                            engine="device", config=cfg, device="cpu")
    want, _ = record_fleet(spec, seeds=SEEDS, n_epochs=N_EPOCHS,
                           engine="batched", config=cfg, device="cpu")
    for e in range(N_EPOCHS):
        for x, y in zip(got[e], want[e]):
            assert_exact(x, y, f"series={series} epoch={e}")
    assert bool(rec.series_keys()) == series
