"""The port's SLO machinery (photon_ml_tpu_torch/slo/{spec,ledger}.py)
against the JAX package's, on the CPU.

  * Ports of tests/test_slo.py's TestSpec, TestLedger and TestFleetctlSLO,
    with their assertions kept, against the port's ``slo``.
  * Across packages: each package's ``slo-ledger.json`` is readable by the
    other and equal on the same recorded inputs (the phase walls apart);
    ``tools/fleetctl.py status`` and ``status --slo`` print the same thing
    for a port-written elastic fleet dir and SLO ledger as for JAX-written
    ones.
"""

import io
import json
import os
import re
import sys
from contextlib import redirect_stdout

import pytest

from photon_ml_tpu import slo as jslo
from photon_ml_tpu.parallel import elastic as jel
from photon_ml_tpu.parallel import multihost as jmh
from photon_ml_tpu.serve import FleetStats as JFleetStats
from photon_ml_tpu_torch import slo as tslo
from photon_ml_tpu_torch.parallel import elastic as tel
from photon_ml_tpu_torch.parallel import multihost as tmh
from photon_ml_tpu_torch.slo import (
    DEGRADATION_KINDS,
    FLEET_COUNTER_KINDS,
    SLO_LEDGER_FILE,
    PhaseSLO,
    SLOLedger,
    SLOSpec,
    SLOViolation,
)

pytestmark = pytest.mark.slo

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------


class TestSpec:
    def test_unknown_degradation_kind_refused(self):
        with pytest.raises(ValueError, match="unknown degradation"):
            PhaseSLO("p", p50_ms=1, p99_ms=2, allowed_degradations=("nope",))

    def test_inverted_latency_refused(self):
        with pytest.raises(ValueError, match="p50 <= p99"):
            PhaseSLO("p", p50_ms=5, p99_ms=2)

    def test_bad_budgets_refused(self):
        with pytest.raises(ValueError, match="fraction"):
            PhaseSLO("p", p50_ms=1, p99_ms=2, error_budget=1.5)
        with pytest.raises(ValueError, match="staleness"):
            PhaseSLO("p", p50_ms=1, p99_ms=2, staleness_budget=-1)

    def test_duplicate_phase_refused(self):
        p = PhaseSLO("p", p50_ms=1, p99_ms=2)
        with pytest.raises(ValueError, match="duplicate"):
            SLOSpec([p, p])

    def test_undeclared_phase_lookup_fails(self):
        spec = SLOSpec([PhaseSLO("a", p50_ms=1, p99_ms=2)])
        with pytest.raises(KeyError, match="no declared SLO"):
            spec.phase("b")

    def test_json_roundtrip(self, tmp_path):
        spec = SLOSpec([
            PhaseSLO("peak", p50_ms=10, p99_ms=100, error_budget=0.05, staleness_budget=3,
                     allowed_degradations=("hedged_fallback",), chaos_window=True),
            PhaseSLO("drain", p50_ms=5, p99_ms=50),
        ])
        path = str(tmp_path / "spec.json")
        spec.save(path)
        loaded = SLOSpec.load(path)
        assert loaded.to_json() == spec.to_json()
        assert loaded.phase("peak").chaos_window is True
        # the JAX package reads the port's spec file, and writes the same
        assert jslo.SLOSpec.load(path).to_json() == loaded.to_json()
        jslo.SLOSpec([
            jslo.PhaseSLO("peak", p50_ms=10, p99_ms=100, error_budget=0.05,
                          staleness_budget=3, allowed_degradations=("hedged_fallback",),
                          chaos_window=True),
            jslo.PhaseSLO("drain", p50_ms=5, p99_ms=50),
        ]).save(str(tmp_path / "j.json"))
        assert open(path).read() == open(str(tmp_path / "j.json")).read()

    def test_every_fleet_counter_kind_is_registered(self):
        for kind in FLEET_COUNTER_KINDS.values():
            assert kind in DEGRADATION_KINDS

    def test_the_kinds_and_counter_map_are_the_jax_packages(self):
        assert DEGRADATION_KINDS == jslo.DEGRADATION_KINDS
        assert FLEET_COUNTER_KINDS == jslo.FLEET_COUNTER_KINDS
        assert (tslo.SLO_LEDGER_FILE, tslo.SLO_LEDGER_FORMAT) == (jslo.SLO_LEDGER_FILE,
                                                                 jslo.SLO_LEDGER_FORMAT)
        assert sorted(tslo.__all__) == sorted(jslo.__all__)


# ---------------------------------------------------------------------------
# the ledger + the gate
# ---------------------------------------------------------------------------


def _spec(**kw):
    defaults = dict(p50_ms=1e6, p99_ms=1e6)
    defaults.update(kw)
    return SLOSpec([PhaseSLO("phase", **defaults)])


class TestLedger:
    def test_phase_protocol_enforced(self):
        led = SLOLedger(_spec())
        with pytest.raises(RuntimeError, match="no phase open"):
            led.record_request(0.001)
        led.begin_phase("phase")
        with pytest.raises(RuntimeError, match="still open"):
            led.begin_phase("phase")
        with pytest.raises(RuntimeError, match="still open"):
            led.finalize()
        led.end_phase()
        led.enforce()

    def test_clean_phase_passes(self):
        led = SLOLedger(_spec(p50_ms=100, p99_ms=200))
        led.begin_phase("phase")
        for _ in range(50):
            led.record_request(0.001, num_rows=2)
        rec = led.end_phase()
        assert rec["requests"] == 50 and rec["rows"] == 100
        assert rec["violations"] == []
        payload = led.enforce()
        assert payload["ok"] is True

    def test_p99_violation_detected(self):
        led = SLOLedger(_spec(p50_ms=0.4, p99_ms=0.5))
        led.begin_phase("phase")
        for _ in range(100):
            led.record_request(0.001)
        led.end_phase()
        with pytest.raises(SLOViolation, match="p99"):
            led.enforce()

    def test_error_budget_spend(self):
        led = SLOLedger(_spec(error_budget=0.10))
        led.begin_phase("phase")
        for _ in range(100):
            led.record_request(0.001)
        led.record_error(5)
        rec = led.end_phase()
        assert rec["error_budget"]["spend"] == pytest.approx(0.05)
        assert rec["error_budget"]["used"] == pytest.approx(0.5)
        led.enforce()

        led2 = SLOLedger(_spec(error_budget=0.01))
        led2.begin_phase("phase")
        for _ in range(100):
            led2.record_request(0.001)
        led2.record_error(5)
        led2.end_phase()
        with pytest.raises(SLOViolation, match="error-budget"):
            led2.enforce()

    def test_drops_outside_chaos_window_fail_even_in_budget(self):
        led = SLOLedger(_spec(error_budget=0.5, chaos_window=False))
        led.begin_phase("phase")
        for _ in range(100):
            led.record_request(0.001)
        led.record_drop()
        led.end_phase()
        with pytest.raises(SLOViolation, match="outside a declared chaos"):
            led.enforce()

        led2 = SLOLedger(_spec(error_budget=0.5, chaos_window=True))
        led2.begin_phase("phase")
        for _ in range(100):
            led2.record_request(0.001)
        led2.record_drop()
        led2.end_phase()
        led2.enforce()

    def test_staleness_budget(self):
        led = SLOLedger(_spec(staleness_budget=2))
        led.begin_phase("phase")
        led.record_request(0.001)
        led.mark_flip(1)
        led.record_stale_answer(3)
        rec = led.end_phase()
        assert rec["flip_generation"] == 1
        with pytest.raises(SLOViolation, match="staleness budget"):
            led.enforce()

    def test_mixed_generation_always_fails(self):
        led = SLOLedger(_spec())
        led.begin_phase("phase")
        led.record_request(0.001)
        led.record_mixed_generation()
        led.end_phase()
        with pytest.raises(SLOViolation, match="mixed-generation"):
            led.enforce()

    def test_divergence_always_fails(self):
        led = SLOLedger(_spec())
        led.begin_phase("phase")
        led.record_request(0.001)
        led.record_divergence()
        led.end_phase()
        with pytest.raises(SLOViolation, match="bitwise oracle"):
            led.enforce()

    def test_undeclared_degradation_fails_at_count_one(self):
        led = SLOLedger(_spec(allowed_degradations=()))
        led.begin_phase("phase")
        led.record_request(0.001)
        led.attribute("swap_abort_chaos", detail="injected barrier fault")
        rec = led.end_phase()
        assert rec["degradation_details"] == ["swap_abort_chaos: injected barrier fault"]
        with pytest.raises(SLOViolation, match="undeclared degradation"):
            led.enforce()

        led2 = SLOLedger(_spec(allowed_degradations=("swap_abort_chaos",)))
        led2.begin_phase("phase")
        led2.record_request(0.001)
        led2.attribute("swap_abort_chaos")
        led2.end_phase()
        led2.enforce()

    def test_unknown_attribution_kind_is_a_programming_error(self):
        led = SLOLedger(_spec())
        led.begin_phase("phase")
        with pytest.raises(ValueError, match="unknown degradation kind"):
            led.attribute("not_a_kind")
        led.end_phase()

    def test_fleet_counter_deltas_auto_attributed(self):
        from photon_ml_tpu_torch.serve import FleetStats

        stats = FleetStats()
        stats.record_hedge()  # pre-phase activity must NOT be attributed
        led = SLOLedger(_spec(allowed_degradations=("cold_entity_zero",)))
        led.begin_phase("phase", stats=stats)
        led.record_request(0.001)
        stats.record_degraded_rows(4)
        stats.record_routed_retry()
        rec = led.end_phase()
        assert rec["degradations"]["cold_entity_zero"] == 4
        assert rec["degradations"]["chaos_absorbed_retry"] == 1
        assert "hedged_fallback" not in rec["degradations"]
        with pytest.raises(SLOViolation, match="chaos_absorbed_retry"):
            led.enforce()

    def test_sidecar_roundtrip(self, tmp_path):
        led = SLOLedger(_spec())
        led.begin_phase("phase")
        led.record_request(0.002)
        led.record_bytes_moved(1234)
        led.end_phase()
        path = led.write(str(tmp_path))
        assert os.path.basename(path) == SLO_LEDGER_FILE
        with open(path) as f:
            payload = json.load(f)
        assert payload["format"] == 1
        assert payload["ok"] is True
        assert payload["totals"]["bytes_moved"] == 1234

    def test_sidecar_banked_even_over_budget(self, tmp_path):
        led = SLOLedger(_spec())
        led.begin_phase("phase")
        led.record_request(0.001)
        led.record_divergence()
        led.end_phase()
        path = led.write(str(tmp_path))
        with open(path) as f:
            payload = json.load(f)
        assert payload["ok"] is False and payload["violations_total"] == 1


# ---------------------------------------------------------------------------
# the sidecar across packages
# ---------------------------------------------------------------------------


def _day(pkg, stats):
    """The same recorded inputs through one package's ledger: two phases,
    fleet counters moving in the second."""
    s = tslo if pkg == "port" else jslo
    spec = s.SLOSpec([
        s.PhaseSLO("ramp", p50_ms=50, p99_ms=100),
        s.PhaseSLO("chaos", p50_ms=50, p99_ms=100, error_budget=0.1, staleness_budget=2,
                   allowed_degradations=("cold_entity_zero", "chaos_absorbed_retry",
                                         "dead_replica_skip", "replica_killed"),
                   chaos_window=True),
    ])
    led = s.SLOLedger(spec, exact_limit=64)
    led.begin_phase("ramp")
    for i in range(40):
        led.record_request(0.001 * (1 + i % 7), num_rows=1 + i % 3)
    led.record_bytes_moved(4096)
    led.end_phase()
    led.begin_phase("chaos", stats=stats)
    for i in range(200):  # past exact_limit: the streaming digest answers
        led.record_request(0.0005 * (1 + (i * 37) % 101), num_rows=2)
    stats.record_degraded_rows(7)
    stats.record_routed_retry()
    stats.record_dead_replica_skip()
    led.record_drop(3)
    led.record_stale_answer(1)
    led.mark_flip(1)
    led.attribute("replica_killed", detail="replica 1 killed under load")
    led.end_phase()
    return led


def _timeless(payload):
    for p in payload["phases"]:
        p.pop("duration_s")
        p.pop("qps")
    return payload


def test_each_package_reads_the_others_sidecar_and_they_are_equal(tmp_path):
    from photon_ml_tpu_torch.serve import FleetStats

    port = _day("port", FleetStats())
    jax_ = _day("jax", JFleetStats())
    tp = port.write(str(tmp_path / "port"))
    jp = jax_.write(str(tmp_path / "jax"))
    with open(tp) as f:
        port_payload = json.load(f)
    with open(jp) as f:
        jax_payload = json.load(f)
    assert port_payload["ok"] is True and port_payload["totals"]["degradations"] == {
        "chaos_absorbed_retry": 1, "cold_entity_zero": 7, "dead_replica_skip": 1,
        "replica_killed": 1}
    assert _timeless(port_payload) == _timeless(jax_payload)
    # the sidecar is plain JSON of one format: each package's spec reads
    # the other's, and its fleetctl aggregate is the same
    def as_json(spec):
        return json.loads(json.dumps(spec.to_json()))

    assert as_json(jslo.SLOSpec.from_json(port_payload["spec"])) == \
        as_json(tslo.SLOSpec.from_json(port_payload["spec"]))
    assert as_json(tslo.SLOSpec.from_json(jax_payload["spec"])) == \
        as_json(jslo.SLOSpec.from_json(jax_payload["spec"]))
    import fleetctl

    t = fleetctl.read_slo_ledgers([str(tmp_path / "port")])
    j = fleetctl.read_slo_ledgers([str(tmp_path / "jax")])
    assert t == j
    assert t["requests"] == 240 and t["ok"] is True


# ---------------------------------------------------------------------------
# fleetctl
# ---------------------------------------------------------------------------


class TestFleetctlSLO:
    def _bank(self, directory, *, divergent=0):
        led = SLOLedger(SLOSpec([PhaseSLO("peak", p50_ms=1e6, p99_ms=1e6)]))
        led.begin_phase("peak")
        for _ in range(10):
            led.record_request(0.001)
        led.record_divergence(divergent)
        if divergent:
            led.attribute("swap_abort_chaos")  # undeclared -> 2nd violation
        led.end_phase()
        led.write(str(directory))

    def test_aggregates_and_flags_over_budget(self, tmp_path):
        import fleetctl

        clean, dirty, torn = tmp_path / "clean", tmp_path / "dirty", tmp_path / "torn"
        clean.mkdir(), dirty.mkdir(), torn.mkdir()
        self._bank(clean)
        self._bank(dirty, divergent=2)
        (torn / SLO_LEDGER_FILE).write_text("{not json")
        agg = fleetctl.read_slo_ledgers(
            [str(clean), str(dirty), str(torn), str(tmp_path / "absent")])
        assert agg["sidecars"] == 2
        assert agg["unreadable"] == 1
        assert agg["requests"] == 20
        assert agg["ok"] is False
        assert agg["over_budget_total"] == 1
        flagged = agg["over_budget"][0]
        assert flagged["phase"] == "peak"
        assert any("diverged" in v for v in flagged["violations"])
        assert agg["phases"]["peak"]["requests"] == 20
        assert agg["phases"]["peak"]["violations"] == 2

    def test_nothing_scanned_returns_none(self, tmp_path):
        import fleetctl

        assert fleetctl.read_slo_ledgers([str(tmp_path)]) is None
        assert fleetctl.read_slo_ledgers([]) is None


def _elastic_fleet(pkg, fleet_dir):
    """A fleet dir as a running elastic job leaves it: committed membership
    v1, heartbeats, a pending v2 proposal, and both operator requests."""
    el, mh = (tel, tmh) if pkg == "port" else (jel, jmh)
    el.commit_membership(fleet_dir, el.FleetMembership(1, [0, 1, 2], {0: 0, 1: 1, 2: 0}))
    for h in range(3):
        mh.write_host_heartbeat(os.path.join(fleet_dir, "heartbeats"), h, step=4)
    el.propose_membership(fleet_dir, el.FleetMembership(2, [0, 1], {0: 0, 1: 1}),
                          "host 2 lost")
    el.declare_lost_hosts(fleet_dir, [2], reason="zone-b reclamation")
    el.request_scale_up(fleet_dir, {3: 1}, reason="capacity returned")


def _fleetctl(argv):
    import fleetctl

    out = io.StringIO()
    with redirect_stdout(out):
        assert fleetctl.main(argv) == 0
    return out.getvalue()


@pytest.mark.parametrize("with_slo", [False, True], ids=["status", "status-slo"])
def test_fleetctl_status_reads_the_port_as_the_jax_package(tmp_path, with_slo):
    from photon_ml_tpu_torch.serve import FleetStats

    text = {}
    for pkg in ("port", "jax"):
        fleet = str(tmp_path / f"{pkg}-fleet")
        _elastic_fleet(pkg, fleet)
        argv = ["status", fleet]
        if with_slo:
            slo_dir = str(tmp_path / f"{pkg}-slo")
            _day(pkg, FleetStats() if pkg == "port" else JFleetStats()).write(slo_dir)
            argv += ["--slo", slo_dir]
        out = _fleetctl(argv).replace(os.path.abspath(fleet), "<fleet>")
        text[pkg] = re.sub(r"\d+:\d+\.\ds", "<age>", out)
        status = json.loads(_fleetctl(argv + ["--json"]))
        assert sorted(status["heartbeat_ages"]) == ["0", "1", "2"]
        assert status["membership"]["version"] == 1
        assert status["pending_proposal"]["version"] == 2
        assert (status["slo"] is not None) == with_slo
    assert text["port"] == text["jax"]
    assert "pending proposal: v2 (host 2 lost)" in text["port"]
    if with_slo:
        assert "slo ledgers: 1 sidecars (0 unreadable); 240 requests" in text["port"]
        assert "slo: every phase within budget" in text["port"]
