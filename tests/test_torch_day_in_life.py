"""The port's day-in-the-life SLO harness (``photon_ml_tpu_torch.cli.day_in_life``)
against the JAX harness (tools/day_in_life.py): the same DayConfig fields and
defaults, the same declared SLOs (``build_spec``), the same diurnal curve and
chaos sites; the mini day of ``TestDayInLife.test_mini_day_end_to_end`` on the
CPU holds every lifecycle gate, its ledger is ``ok``, and ``tools/fleetctl.py``
reads its sidecar back. The real-retrain-and-kill sibling is ``slow``, as the
JAX one is."""

import dataclasses
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))

import day_in_life as jday  # noqa: E402
from photon_ml_tpu_torch.cli import day_in_life as tday  # noqa: E402
from photon_ml_tpu_torch.slo import SLO_LEDGER_FILE  # noqa: E402
from test_slo import LIFECYCLE_KINDS  # noqa: E402


def _as_json(spec):
    return json.loads(json.dumps(spec.to_json()))


def test_day_config_has_the_jax_fields_and_defaults():
    got = {f.name: f.default for f in dataclasses.fields(tday.DayConfig)}
    want = {f.name: f.default for f in dataclasses.fields(jday.DayConfig)}
    assert got.pop("device") == "cuda"  # the port's one field beyond the JAX harness's
    assert got == want


@pytest.mark.parametrize("slo_scale", [1.0, 2.5])
def test_build_spec_equals_the_jax_spec(slo_scale):
    cfg = lambda mod: mod.DayConfig(out_dir="x", slo_scale=slo_scale)
    assert _as_json(tday.build_spec(cfg(tday))) == _as_json(jday.build_spec(cfg(jday)))


def test_the_curve_sections_and_chaos_sites_are_the_jax_harness():
    assert tday.DIURNAL_CURVE == jday.DIURNAL_CURVE
    assert tday.SECTIONS == jday.SECTIONS and tday.SECTIONS_FLAG == jday.SECTIONS_FLAG
    with open(tday.__file__) as f:
        src = f.read()
    from test_chaos_coverage import DAY_IN_LIFE_REQUIRED_SITES

    for site in DAY_IN_LIFE_REQUIRED_SITES:
        assert f'"{site}"' in src, site


def test_the_synthetic_draws_are_the_jax_fixtures():
    """The day's synthetic data and model draw the JAX fixtures' numbers."""
    import numpy as np

    from game_test_utils import make_glmix_data

    want, wtruth = make_glmix_data(np.random.default_rng(20), num_users=96,
                                   rows_per_user_range=(4, 8), d_fixed=8, d_random=6)
    got, gtruth = tday._glmix_data(np.random.default_rng(20), num_users=96,
                                   rows_per_user_range=(4, 8), d_fixed=8, d_random=6)
    assert got.response.tobytes() == want.response.tobytes()
    assert got.user_of_row.tobytes() == want.ids["userId"].tobytes()
    for k in ("x_fixed", "x_random"):
        assert gtruth[k].tobytes() == wtruth[k].tobytes()
    rows = range(10)
    assert list(tday._game_avro_records(got, rows, gtruth)) == list(
        __import__("game_test_utils").game_avro_records(want, rows, wtruth))


def _assert_day(result, out_dir):
    led = result["ledger"]
    assert led["ok"] is True, led
    assert led["violations_total"] == 0
    assert [p["name"] for p in led["phases"]] == list(tday.DIURNAL_CURVE)
    for p in led["phases"]:
        assert p["requests"] > 0, p["name"]
        assert p["p99_ms"] >= p["p50_ms"] > 0.0, p["name"]
    degr = led["totals"]["degradations"]
    for kind in LIFECYCLE_KINDS:
        assert degr.get(kind, 0) >= 1, (kind, degr)
    assert led["totals"]["mixed_generation"] == 0
    assert led["totals"]["bytes_moved"] > 0
    with open(os.path.join(out_dir, SLO_LEDGER_FILE)) as f:
        assert json.load(f)["ok"] is True
    assert result["extra"]["population"]["universe"] >= 1_000_000
    assert result["extra"]["morning_batch_driver_bitwise"] is True
    # the sidecar is the one fleetctl reads
    import fleetctl

    agg = fleetctl.read_slo_ledgers([out_dir])
    assert agg["sidecars"] == 1 and agg["ok"] is True
    assert agg["requests"] == led["totals"]["requests"]


def test_mini_day_end_to_end(tmp_path):
    """The JAX mini day's config (synthetic models, in-process replicas),
    on the CPU."""
    result = tday.run_day(tday.DayConfig(
        out_dir=str(tmp_path), real_retrain=False, kill_arm=False, phase_seconds=1.0,
        peak_qps=60.0, traffic_threads=2, cold_pool=8, exact_limit=512, device="cpu"))
    _assert_day(result, str(tmp_path))
    assert result["extra"]["retrain_provenance_refused"] is True
    assert result["extra"]["migration_same_dtype_new_compiles"] == 0


def test_the_command_line_runs_the_day(tmp_path, capsys):
    result = tday.main(["--out-dir", str(tmp_path), "--synthetic-models", "--no-kill-arm",
                        "--no-dtype-migration", "--no-batch-oracle", "--phase-seconds", "0.5",
                        "--peak-qps", "40", "--traffic-threads", "2", "--device", "cpu"])
    assert '"ok": true' in capsys.readouterr().out
    assert result["ledger"]["ok"] is True
    assert result["extra"]["config"]["device"] == "cpu"


@pytest.mark.slow
def test_full_day_real_retrain_and_kill_arm(tmp_path):
    """The full-fat day: a real ``--warm-start-from`` delta retrain under
    traffic and the TCP replica kill arm, on the CPU."""
    result = tday.run_day(tday.DayConfig(
        out_dir=str(tmp_path), real_retrain=True, kill_arm=True, phase_seconds=2.0,
        peak_qps=80.0, traffic_threads=2, cold_pool=12, device="cpu"))
    _assert_day(result, str(tmp_path))
    degr = result["ledger"]["totals"]["degradations"]
    assert degr.get("replica_killed", 0) == 1
    assert "elastic_heartbeat_detect_s" in result["extra"]
