"""The port's fleet telemetry, held against the JAX package's.

  * **parity** — with a recorder, the batched engine's per-slot series
    (Q/H/E, admissions, transmissions, pending) equal the oracle's on
    every registry scenario × scheme, bit for bit;
  * **zero-cost off** — threading a recorder (enabled or disabled)
    through an engine leaves every epoch result bit-identical to the
    telemetry-free run;
  * **reductions and formats** — the metrics equal the reference's on
    seeded inputs (``jain_index`` gives 1.0 where the reference's squares
    underflow to NaN), JSONL and memory sinks round-trip, the reference's
    ``fleet_table`` of a port run's JSONL equals the port's, and the
    Chrome trace has one track per lane.
"""
import json

import jax
import jax.experimental
import numpy as np
import pytest
import torch

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

import repro.telemetry.metrics as ref_metrics                     # noqa: E402
import repro.telemetry.report as ref_report                       # noqa: E402

import repro_torch.data.pipeline as port_data                     # noqa: E402
import repro_torch.models.mlp as port_mlp                         # noqa: E402
import repro_torch.optim.optimizers as port_optim                 # noqa: E402
from repro_torch.sim import (BatchedFleet, Fleet,                 # noqa: E402
                             available_scenarios, build_cluster,
                             scenario_spec)
from repro_torch.sim.batched import reset_scan_compile_cache      # noqa: E402
from repro_torch.sim.cluster import SCHEMES, CommStats            # noqa: E402
from repro_torch.telemetry import (SERIES_FIELDS,                 # noqa: E402
                                   FleetRecorder, JsonlSink,
                                   MemorySink, TelemetryConfig,
                                   chrome_trace_events,
                                   compile_counts, jain_index,
                                   note_compile, record_fleet,
                                   write_chrome_trace)
from repro_torch.telemetry import metrics as port_metrics        # noqa: E402
from repro_torch.telemetry.report import (fleet_table,            # noqa: E402
                                          load_runs, main, run_row)
from repro_torch.train import CodedTrainer                        # noqa: E402

SEEDS = (0, 101)
N_EPOCHS = 2


def _oracle_recorded(spec, scheme, seeds, n_epochs, rec):
    out = []
    for lane, seed in enumerate(seeds):
        c = build_cluster(spec, scheme, seed, device="cpu")
        if rec is not None:
            c.telemetry_lane = lane
            c.telemetry = rec
        out.append([c.run_epoch(e) for e in range(n_epochs)])
    return [[out[i][e] for i in range(len(seeds))] for e in range(n_epochs)]


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("scenario", sorted(available_scenarios()))
def test_series_of_batched_engine_equal_the_oracles(scenario, scheme):
    spec = scenario_spec(scenario)
    rec_b, rec_o = FleetRecorder(), FleetRecorder()
    BatchedFleet(spec, scheme, SEEDS, telemetry=rec_b,
                 device="cpu").run(N_EPOCHS)
    _oracle_recorded(spec, scheme, SEEDS, N_EPOCHS, rec_o)
    assert rec_b.series_keys() == rec_o.series_keys() == [
        (lane, e) for lane in range(len(SEEDS)) for e in range(N_EPOCHS)]
    for key in rec_b.series_keys():
        sb, so = rec_b.comm_series(*key), rec_o.comm_series(*key)
        for f in SERIES_FIELDS:
            assert sb[f].dtype == so[f].dtype == np.float32
            np.testing.assert_array_equal(
                sb[f], so[f], err_msg=f"{scenario}/{scheme} {key} {f}")


def test_series_rows_match_ledger_totals():
    results, rec = record_fleet(scenario_spec("saturated-uplink"),
                                seeds=SEEDS, n_epochs=1, device="cpu")
    for lane, res in enumerate(results[0]):
        s = rec.comm_series(lane, 0)
        assert s["Q"].shape == (res.comm.n_slots, res.M)
        np.testing.assert_allclose(s["admitted"].astype(np.float64).sum(0),
                                   res.comm.bytes_admitted, rtol=1e-6)
        np.testing.assert_array_equal(s["Q"][-1].astype(np.float64),
                                      res.comm.queue_residual)


def _flat(rows):
    return [r for row in rows for r in row]


@pytest.mark.parametrize("engine", ["batched", "hybrid", "oracle"])
def test_results_bit_identical_with_and_without_telemetry(engine):
    spec = scenario_spec("fading-uplink")

    def run(telemetry):
        if engine == "oracle":
            return _oracle_recorded(spec, "two-stage", SEEDS, N_EPOCHS,
                                    telemetry)
        return BatchedFleet(spec, "two-stage", SEEDS, telemetry=telemetry,
                            compute={"batched": "batched",
                                     "hybrid": "host"}[engine],
                            device="cpu").run(N_EPOCHS)

    base = _flat(run(None))
    for rec in (FleetRecorder(), FleetRecorder(TelemetryConfig(
            enabled=False)), FleetRecorder(TelemetryConfig(series=False))):
        for rb, r2 in zip(base, _flat(run(rec))):
            assert (r2.time, r2.decode_ok, r2.comm.n_slots,
                    r2.comm.min_energy, r2.comm.max_overdraft) == (
                rb.time, rb.decode_ok, rb.comm.n_slots,
                rb.comm.min_energy, rb.comm.max_overdraft)
            for f in ("bytes_admitted", "bytes_transmitted",
                      "queue_residual", "final_energy", "arrived"):
                np.testing.assert_array_equal(getattr(r2.comm, f),
                                              getattr(rb.comm, f))


def test_disabled_recorder_collects_nothing():
    rec = FleetRecorder(TelemetryConfig(enabled=False))
    BatchedFleet(scenario_spec("homogeneous"), "two-stage", SEEDS,
                 telemetry=rec, device="cpu").run(1)
    assert not rec
    assert rec.series_keys() == [] and rec.spans == []
    assert rec.epoch_events() == []


def test_spans_epoch_events_and_build_counts():
    reset_scan_compile_cache()
    before = compile_counts()
    results, rec = record_fleet(scenario_spec("homogeneous"), seeds=SEEDS,
                                n_epochs=N_EPOCHS, engine="hybrid",
                                device="cpu")
    names = {s.name for s in rec.spans}
    # fleet-level phases plus the runtime's per-lane stage spans
    assert {"compute_phase", "comm", "decode", "stage1", "stage2"} <= names
    assert {s.meta["lane"] for s in rec.spans
            if s.name == "stage1"} == set(range(len(SEEDS)))
    assert all(s.t1 >= s.t0 for s in rec.spans)
    events = rec.epoch_events()
    assert len(events) == len(SEEDS) * N_EPOCHS
    for ev, res in zip(events, _flat(results)):
        assert ev["decode_ok"] == res.decode_ok
        assert ev["n_slots"] == res.comm.n_slots
        assert ev["bytes_admitted"] == list(res.comm.bytes_admitted)
    assert rec.compile_delta() == {"comm_scan": 1}
    assert compile_counts()["comm_scan"] == before.get("comm_scan", 0) + 1
    note_compile("kernel_build:probe")
    assert rec.compile_delta()["kernel_build:probe"] == 1


def test_oracle_spans_carry_lanes():
    _, rec = record_fleet(scenario_spec("homogeneous"), seeds=SEEDS,
                          n_epochs=1, engine="oracle", device="cpu")
    lanes = {(s.name, s.meta["lane"]) for s in rec.spans}
    for lane in range(len(SEEDS)):
        assert {("compute_phase", lane), ("comm", lane), ("decode", lane),
                ("stage1", lane), ("stage2", lane)} <= lanes


def test_trainer_records_the_reference_spans():
    rec = FleetRecorder()
    spec = scenario_spec("bursty-stragglers")
    tr = CodedTrainer(
        None, spec, "two-stage",
        port_data.SyntheticClassificationDataset(6, 4, 8, 2, device="cpu"),
        port_optim.adamw(1e-3),
        params=port_mlp.init_mlp(torch.Generator().manual_seed(0),
                                 dims=(8, 2), device="cpu"),
        loss_fn=port_mlp.mlp_loss, device="cpu", telemetry=rec)
    assert tr.run_epoch(0).decode_ok
    names = [s.name for s in rec.spans]
    for name in ("shard_grads", "encode", "decode_reduce",
                 "optimizer_step", "compute_phase", "comm", "decode",
                 "stage1", "stage2"):
        assert name in names
    assert rec.series_keys() == [(0, 0)]
    assert len(rec.epoch_events()) == 1


# --------------------------------------------------------------------- #
# derived metrics against the reference
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", range(4))
def test_metrics_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    q = rng.uniform(0, 5, (int(rng.integers(2, 40)), 6))
    assert port_metrics.queue_stability_drift(q) == \
        ref_metrics.queue_stability_drift(q)
    assert port_metrics.queue_stability_drift(q[:1]) == 0.0
    t = np.arange(q.shape[0], dtype=np.float64)
    qs = q.sum(1)
    moments = (q.shape[0], t.sum(), (t * t).sum(), qs.sum(), (t * qs).sum())
    assert port_metrics.slope_from_moments(*moments) == \
        ref_metrics.slope_from_moments(*moments)
    rows = [np.array(m) for m in moments]
    np.testing.assert_array_equal(
        port_metrics.slope_from_moments(*[np.stack([r, r]) for r in rows]),
        ref_metrics.slope_from_moments(*[np.stack([r, r]) for r in rows]))
    counts = rng.integers(0, 6, 12)
    for alpha in (0.1, 0.3, 1.0):
        np.testing.assert_array_equal(
            port_metrics.straggler_rate_ewma(counts, alpha),
            ref_metrics.straggler_rate_ewma(counts, alpha))
    with pytest.raises(ValueError):
        port_metrics.straggler_rate_ewma(counts, 0.0)
    x = rng.uniform(0, 3, 8) * (rng.random(8) < 0.7)
    assert jain_index(x) == pytest.approx(ref_metrics.jain_index(x),
                                          rel=1e-14)
    assert jain_index([]) == ref_metrics.jain_index([]) == 1.0
    assert jain_index(np.zeros(3)) == 1.0
    with pytest.raises(ValueError):
        jain_index([1.0, -1.0])


def test_jain_index_has_no_underflow():
    assert jain_index([1e-200]) == 1.0
    assert jain_index([1e-200, 1e-200]) == 1.0
    assert np.isnan(ref_metrics.jain_index([1e-200]))     # the reference's


def test_fleet_columns_match_the_reference():
    results, _ = record_fleet(scenario_spec("bursty-stragglers"),
                              seeds=SEEDS, n_epochs=2, device="cpu")
    flat = _flat(results)
    assert port_metrics.fleet_fairness(flat) == pytest.approx(
        ref_metrics.fleet_fairness(flat), rel=1e-14)
    assert port_metrics.mean_queue_residual(flat) == \
        ref_metrics.mean_queue_residual(flat)
    assert port_metrics.comm_stats_of(flat) == [r.comm for r in flat]
    assert port_metrics.fleet_fairness([]) == 1.0
    assert port_metrics.mean_queue_residual([]) == 0.0
    assert isinstance(flat[0].comm, CommStats)


# --------------------------------------------------------------------- #
# sinks, report, chrome trace
# --------------------------------------------------------------------- #
def test_jsonl_and_memory_sinks_round_trip(tmp_path):
    path = tmp_path / "telemetry.jsonl"
    mem = MemorySink()
    with JsonlSink(path) as sink:
        _, rec = record_fleet(scenario_spec("saturated-uplink"),
                              seeds=SEEDS, n_epochs=N_EPOCHS,
                              config=TelemetryConfig(sink_slots=True),
                              sinks=(sink, mem), device="cpu")
    lines = path.read_text().splitlines()
    assert sink.n_written == len(mem.events) == len(lines) > 0
    assert [json.loads(line) for line in lines] == mem.events
    kinds = [e["type"] for e in mem.events]
    assert kinds[0] == "run" and kinds[-1] == "compiles"
    assert {"epoch", "span", "slot"} <= set(kinds)
    slots = [e for e in mem.events if e["type"] == "slot"]
    n = sum(rec.comm_series(*k)["Q"].shape[0] for k in rec.series_keys())
    assert len(slots) == n
    first = rec.comm_series(slots[0]["lane"], slots[0]["epoch"])
    assert slots[0]["Q"] == first["Q"][0].tolist()


def test_report_table_equals_the_references(tmp_path, capsys):
    """Two runs in one file: the reference's reader and table give the
    port's rows and table, character for character."""
    path = tmp_path / "two_runs.jsonl"
    with JsonlSink(path) as sink:
        for scheme in ("two-stage", "uncoded"):
            record_fleet(scenario_spec("bursty-stragglers"), scheme,
                         seeds=SEEDS, n_epochs=N_EPOCHS, sinks=(sink,),
                         device="cpu")
    runs = load_runs([str(path)])
    ref_runs = ref_report.load_runs([str(path)])
    assert len(runs) == 2
    assert [run_row(r) for r in runs] == \
        [ref_report.run_row(r) for r in ref_runs]
    assert fleet_table(runs) == ref_report.fleet_table(ref_runs)
    row = run_row(runs[0])
    assert (row["scheme"], row["engine"], row["lanes"], row["epochs"]) == \
        ("two-stage", "batched", len(SEEDS), len(SEEDS) * N_EPOCHS)
    assert main([str(path)]) == 0
    assert capsys.readouterr().out.strip() == fleet_table(runs)
    assert main([str(path), "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == [run_row(r) for r in runs]
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"type": "epoch", "lane": 0}\n')
    with pytest.raises(ValueError, match="before any 'run' header"):
        load_runs([str(bad)])


def test_chrome_trace_export(tmp_path):
    _, rec = record_fleet(scenario_spec("homogeneous"), seeds=SEEDS,
                          n_epochs=1, engine="oracle", device="cpu")
    events = chrome_trace_events(rec)
    complete = [e for e in events if e["ph"] == "X"]
    assert complete and all(e["ts"] >= 0 and e["dur"] >= 0
                            for e in complete)
    assert {e["tid"] for e in complete} == {1, 2}    # one track per lane
    assert len(complete) == len(rec.spans)
    path = write_chrome_trace(rec, str(tmp_path / "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    assert doc["traceEvents"] == json.loads(json.dumps(events))
    assert doc["otherData"]["scenario"] == "homogeneous"


def test_recorder_validates_series_fields():
    rec = FleetRecorder()
    good = {f: np.zeros((3, 2)) for f in SERIES_FIELDS}
    rec.record_comm_series(0, 0, n_slots=2, **good)
    assert rec.comm_series(0, 0)["Q"].shape == (2, 2)   # trimmed
    with pytest.raises(ValueError, match="exactly"):
        rec.record_comm_series(0, 1, n_slots=2,
                               **{**good, "bogus": np.zeros((3, 2))})
    with pytest.raises(ValueError, match="rows <"):
        rec.record_comm_series(0, 1, n_slots=9, **good)
    with pytest.raises(ValueError, match="engine"):
        record_fleet(scenario_spec("homogeneous"), engine="warp-drive")
    with pytest.raises(TypeError, match="telemetry must be"):
        Fleet(scenario_spec("homogeneous")).run(telemetry="yes",
                                               device="cpu")
