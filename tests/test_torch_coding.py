"""The port's host control plane held bit for bit against the JAX package.

Coding matrices, span/decode, two-stage planning, the straggler predictor,
slot plans, the runtime's compute phase (with the RNG stream position),
the event engine, the channel models and the scenario specs are numpy in
both packages, so every array must be equal, not merely close.
"""
from itertools import combinations
from pathlib import Path

import jax
import jax.experimental
import numpy as np
import pytest

# jax 0.9 dropped ``jax.experimental.enable_x64``, which modules of the
# reference's ``repro.sim`` import by name
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

import repro.core.coded_step as ref_step                          # noqa: E402
import repro.core.coding as ref_coding                            # noqa: E402
import repro.sim as ref_sim                                       # noqa: E402
from repro.sim import channel as ref_channel                      # noqa: E402
from repro.sim import events as ref_events                        # noqa: E402

import repro_torch.core.coded_step as port_step                   # noqa: E402
import repro_torch.core.coding as port_coding                     # noqa: E402
import repro_torch.sim as port_sim                                # noqa: E402
from repro_torch.sim import channel as port_channel               # noqa: E402
from repro_torch.sim import events as port_events                 # noqa: E402

SCHEMES = ("two-stage", "cyclic", "fractional", "uncoded")
SCENARIOS = sorted(ref_sim.available_scenarios())
GOLDEN_DIR = Path(__file__).parent / "golden" / "scenario_specs"


def _same_scheme(a, b):
    np.testing.assert_array_equal(a.B, b.B)
    assert (a.s, a.kind, a.group_size) == (b.s, b.kind, b.group_size)
    np.testing.assert_array_equal(a.workers, b.workers)
    np.testing.assert_array_equal(a.partitions, b.partitions)
    if a.nodes is None:
        assert b.nodes is None
    else:
        np.testing.assert_array_equal(a.nodes, b.nodes)


# --------------------------------------------------------------------- #
# matrices, span, decode
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("M,s", [(4, 1), (5, 2), (6, 2), (7, 3)])
def test_cyclic_and_fractional_matrices_bitwise(M, s):
    _same_scheme(ref_coding.cyclic_repetition(M, s),
                 port_coding.cyclic_repetition(M, s))
    if M % (s + 1) == 0:
        _same_scheme(ref_coding.fractional_repetition(M, s),
                     port_coding.fractional_repetition(M, s))
    _same_scheme(ref_coding.uncoded(M, 2 * M), port_coding.uncoded(M, 2 * M))
    np.testing.assert_array_equal(ref_coding.default_nodes(M),
                                  port_coding.default_nodes(M))


@pytest.mark.parametrize("seed", range(8))
def test_vandermonde_code_and_supports_bitwise(seed):
    rng = np.random.default_rng(seed)
    M = int(rng.integers(3, 10))
    K = int(rng.integers(1, 12))
    s = int(rng.integers(0, min(3, M - 1) + 1))
    caps = rng.uniform(0.0, 3.0, size=M)
    assert (ref_coding.allocate_supports(K, s, caps)
            == port_coding.allocate_supports(K, s, caps))
    _same_scheme(ref_coding.vandermonde_code(K, s, caps),
                 port_coding.vandermonde_code(K, s, caps))


@pytest.mark.parametrize("name,M,s", [("cyclic", 6, 2), ("cyclic", 5, 1),
                                      ("fractional", 6, 1),
                                      ("fractional", 6, 2)])
def test_decode_weights_every_pattern_bitwise(name, M, s):
    ref = ref_coding.build_static_scheme(name, M, M, s)
    port = port_coding.build_static_scheme(name, M, M, s)
    assert ref_coding.satisfies_span(ref) == port_coding.satisfies_span(port)
    for n_dead in range(s + 2):
        for dead in combinations(range(M), n_dead):
            alive = np.ones(M, bool)
            alive[list(dead)] = False
            try:
                a_ref = ref_coding.decode_weights(ref, alive)
            except ValueError:
                with pytest.raises(ValueError):
                    port_coding.decode_weights(port, alive)
                continue
            np.testing.assert_array_equal(
                a_ref, port_coding.decode_weights(port, alive))
            np.testing.assert_array_equal(
                ref_coding.solve_decode(ref.B, alive),
                port_coding.solve_decode(port.B, alive))


def test_rs_decode_cache_returns_fresh_copies():
    scheme = port_coding.cyclic_repetition(6, 2)
    alive = np.array([1, 0, 1, 1, 0, 1], bool)
    a = port_coding.rs_decode_weights(scheme.nodes, alive, 2)
    np.testing.assert_array_equal(
        a, ref_coding.rs_decode_weights(scheme.nodes, alive, 2))
    a[:] = 99.0                                 # must not reach the cache
    b = port_coding.rs_decode_weights(scheme.nodes, alive, 2)
    assert b.flags.writeable and not np.any(b == 99.0)
    with pytest.raises(ValueError, match="exceed"):
        port_coding.rs_decode_weights(scheme.nodes, np.zeros(6, bool), 2)


# --------------------------------------------------------------------- #
# two-stage planner, predictor, slot plans
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("M,K,M1,s", [(6, 12, 4, 1), (6, 6, 4, 2),
                                      (8, 16, 5, 2), (5, 10, 3, 1)])
def test_two_stage_plans_bitwise(M, K, M1, s):
    rng = np.random.default_rng(M * 100 + K)
    ref_p = ref_coding.TwoStagePlanner(M, K, M1)
    port_p = port_coding.TwoStagePlanner(M, K, M1)
    for epoch in range(4):
        speeds = rng.uniform(0.5, 2.0, size=M)
        st1r, st1p = (ref_p.plan_stage1(epoch, speeds),
                      port_p.plan_stage1(epoch, speeds))
        _same_scheme(st1r.scheme, st1p.scheme)
        batched = port_p.plan_stage1_batched(epoch, speeds[None])[0]
        _same_scheme(st1r.scheme, batched.scheme)
        fin = rng.random(M1) < 0.5
        st2r = ref_p.plan_stage2(st1r, fin, s, speeds)
        st2p = port_p.plan_stage2(st1p, fin, s, speeds)
        assert st2r.triggered == st2p.triggered
        for f in ("active_workers", "uncovered_partitions",
                  "covered_partitions", "finished_workers"):
            np.testing.assert_array_equal(getattr(st2r, f),
                                          getattr(st2p, f))
        if st2r.triggered:
            _same_scheme(st2r.scheme, st2p.scheme)
            st2b = port_p.plan_stage2_batched(
                [st1p], fin[None], np.array([s]), speeds[None])[0]
            _same_scheme(st2r.scheme, st2b.scheme)
        plan_r = ref_step.build_slot_plan(
            [st1r.scheme] + ([st2r.scheme] if st2r.triggered else []), M)
        plan_p = port_step.build_slot_plan(
            [st1p.scheme] + ([st2p.scheme] if st2p.triggered else []), M)
        np.testing.assert_array_equal(plan_r.slot_partition,
                                      plan_p.slot_partition)
        np.testing.assert_array_equal(plan_r.slot_coeff, plan_p.slot_coeff)
        a = rng.standard_normal(M)
        np.testing.assert_array_equal(ref_step.slot_weights(plan_r, a),
                                      port_step.slot_weights(plan_p, a))


def test_predictor_bitwise():
    rng = np.random.default_rng(5)
    ref, port = ref_coding.StragglerPredictor(6), port_coding.StragglerPredictor(6)
    for _ in range(10):
        w = rng.choice(6, size=4, replace=False)
        t = rng.exponential(1.0, size=4)
        t[rng.random(4) < 0.2] = np.inf
        ref.update_times(w, t)
        port.update_times(w, t)
        n = int(rng.integers(0, 3))
        ref.update_straggler_count(n)
        port.update_straggler_count(n)
        np.testing.assert_array_equal(ref.speeds(), port.speeds())
        np.testing.assert_array_equal(ref.time_quantile(0.9),
                                      port.time_quantile(0.9))
        np.testing.assert_array_equal(ref.straggler_probs(1.1),
                                      port.straggler_probs(1.1))
        assert ref.predict_s(5) == port.predict_s(5)
        assert ref.suggest_deadline(2.0) == port.suggest_deadline(2.0)


# --------------------------------------------------------------------- #
# runtime compute phase: every scenario × scheme, RNG position included
# --------------------------------------------------------------------- #
def _rng_state(cluster):
    return cluster.engine.rng.bit_generator.state


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_compute_phase_and_rng_bitwise(scenario, scheme):
    ref = ref_sim.build_cluster(ref_sim.scenario_spec(scenario), scheme, 7)
    port = port_sim.build_cluster(port_sim.scenario_spec(scenario), scheme,
                                  7, device="cpu")
    for epoch in range(4):
        if scheme == "two-stage":
            pr = ref.runtime.compute_phase(epoch)
            pp = port.runtime.compute_phase(epoch)
            for f in ("t1", "tasks1", "finished", "ready_time"):
                np.testing.assert_array_equal(getattr(pr, f), getattr(pp, f))
            assert (pr.T_comp, pr.stage1_time, pr.stage1_useful,
                    pr.stage1_total_task_time, pr.stage1_executed) == \
                (pp.T_comp, pp.stage1_time, pp.stage1_useful,
                 pp.stage1_total_task_time, pp.stage1_executed)
            assert pr.triggered == pp.triggered
            if pr.triggered:
                _same_scheme(pr.st2.scheme, pp.st2.scheme)
                np.testing.assert_array_equal(pr.t2, pp.t2)
            must_r, w2_r, need_r = ref.runtime.decode_requirements(pr)
            must_p, w2_p, need_p = port.runtime.decode_requirements(pp)
            np.testing.assert_array_equal(must_r, must_p)
            np.testing.assert_array_equal(w2_r, w2_p)
            assert need_r == need_p
        else:
            jr, jp = ref.comm_job(epoch), port.comm_job(epoch)
            np.testing.assert_array_equal(jr.ready_time, jp.ready_time)
            assert jr.gate.kind == jp.gate.kind and \
                jr.gate.need == jp.gate.need
        assert _rng_state(ref) == _rng_state(port)


# --------------------------------------------------------------------- #
# event engine and channels
# --------------------------------------------------------------------- #
def test_event_engine_order_and_stream():
    ref, port = ref_events.EventEngine(3), port_events.EventEngine(3)
    times = np.random.default_rng(0).uniform(0, 5, size=20).round(1)
    for i, t in enumerate(times):
        ref.schedule(float(t), "e", i)
        port.schedule(float(t), "e", i)
    assert [(e.time, e.seq, e.payload) for e in ref.pop_until(3.0)] == \
        [(e.time, e.seq, e.payload) for e in port.pop_until(3.0)]
    assert ref.now == port.now
    with pytest.raises(ValueError, match="past"):
        port.schedule(0.0, "late")
    np.testing.assert_array_equal(ref.rng.random(5), port.rng.random(5))


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_channel_and_tape_bitwise(scenario):
    spec_r = ref_sim.scenario_spec(scenario)
    spec_p = port_sim.scenario_spec(scenario)
    ch_r, ch_p = spec_r.channel.build(), spec_p.channel.build()
    assert ch_r.physics_key() == ch_p.physics_key()
    rng_r, rng_p = np.random.default_rng(11), np.random.default_rng(11)
    tape_r = ref_channel.CommTape(ch_r, rng_r, 0.5, 0.5)
    tape_p = port_channel.CommTape(ch_p, rng_p, 0.5, 0.5)
    st_r = ch_r.init_state_np(tape_r.u_init)
    st_p = ch_p.init_state_np(tape_p.u_init)
    for k in range(300):                   # crosses a tape block
        tape_r.ensure(k)
        tape_p.ensure(k)
        r_r, st_r = ch_r.step_np(st_r, tape_r.channel_u(k), k)
        r_p, st_p = ch_p.step_np(st_p, tape_p.channel_u(k), k)
        np.testing.assert_array_equal(r_r, r_p)
        np.testing.assert_array_equal(tape_r.harvest(k), tape_p.harvest(k))
    assert rng_r.bit_generator.state == rng_p.bit_generator.state


# --------------------------------------------------------------------- #
# specs: registry and JSON round trip against the golden files
# --------------------------------------------------------------------- #
def test_registry_matches_reference():
    assert port_sim.available_scenarios() == ref_sim.available_scenarios()


@pytest.mark.parametrize("name", SCENARIOS)
def test_spec_json_roundtrip_matches_golden(name):
    spec = port_sim.scenario_spec(name)
    golden = (GOLDEN_DIR / f"{name}.json").read_text()
    assert spec.to_json() + "\n" == golden
    assert port_sim.ScenarioSpec.from_json(golden) == spec
    assert spec.to_json() == ref_sim.scenario_spec(name).to_json()


def test_spec_overrides_validate_like_the_reference():
    spec = port_sim.scenario_spec("homogeneous")
    with pytest.raises(ValueError, match="valid fields"):
        spec.with_overrides(not_a_field=1)
    over = spec.with_overrides(grad_bytes=0.5, tx_power=2.0, fault_prob=0.1)
    ref = ref_sim.scenario_spec("homogeneous").with_overrides(
        grad_bytes=0.5, tx_power=2.0, fault_prob=0.1)
    assert over.to_json() == ref.to_json()
    with pytest.raises(TypeError, match="scenario_spec"):
        port_sim.build_cluster("homogeneous")
