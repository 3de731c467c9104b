"""The port's execution plan (photon_ml_tpu_torch/compile/plan.py) and the
GAME driver's scheduler flags against the JAX package (CPU):

  * ``ExecutionPlan.resolve`` gives the JAX schedule, adaptive schedule,
    ladder and recorded decisions for the flag combinations the port runs,
    and raises the JAX ``PlanError`` words for the impossible pairs;
  * ``--plan``, ``--fused-cycle`` and the mesh raise "not yet ported";
  * ``--solve-compaction`` and ``--adaptive-schedule`` are validated as the
    JAX parser validates them;
  * the driver with ``--solve-compaction`` (host and device loops) matches
    the JAX driver at ``solver`` and writes the unscheduled run's model
    bytes; with ``--adaptive-schedule`` its skips, objectives and ledger
    match the JAX driver's, and the JAX loader reads the ledger it writes
    into ``retrain.json``.
"""

import json
import os

import numpy as np
import pytest

from photon_ml_tpu.cli import game_params as jparams
from photon_ml_tpu.cli import game_training_driver as jdriver
from photon_ml_tpu.compile import plan as jplan
from photon_ml_tpu.optim.convergence import ConvergenceLedger as JLedger
from photon_ml_tpu_torch.cli import game_params as tparams
from photon_ml_tpu_torch.cli import game_training_driver as tdriver
from photon_ml_tpu_torch.compile import compile_stats
from photon_ml_tpu_torch.compile.plan import ExecutionPlan, PlanError
from photon_ml_tpu_torch.optim.scheduler import solve_stats
from test_game_drivers import game_avro_dirs  # noqa: F401
from test_torch_game_driver import _argv
from tolerances import assert_allclose

COMBOS = [
    dict(),
    dict(solve_compaction="5"),
    dict(solve_compaction="device:3", shape_canonicalization="on"),
    dict(solve_compaction="on", shape_canonicalization="16:1.5", bucketed=True),
    dict(adaptive_schedule="on"),
    dict(adaptive_schedule="1e-3:2", bucketed=True),
    dict(adaptive_schedule="0", bucketed=True, solve_compaction="device"),
    dict(solve_compaction="4", vmapped_grid="auto"),
    dict(solve_compaction="4", vmapped_grid="true"),
    dict(adaptive_schedule="on", bucketed=True, vmapped_grid="true"),
    dict(adaptive_schedule="on", vmapped_grid="true"),
    dict(streaming=True),
    dict(streaming=True, bucketed=True),
    dict(streaming=True, adaptive_schedule="1e-3:2"),
    dict(streaming=True, solve_compaction="4", shape_canonicalization="on"),
    dict(fused_cycle=True),
    dict(fused_cycle=True, solve_compaction="on"),
    dict(fused_cycle=True, solve_compaction="device:4", shape_canonicalization="on"),
    dict(fused_cycle=True, streaming=True),
    dict(fused_cycle=True, streaming=True, solve_compaction="4"),
    dict(fused_cycle=True, adaptive_schedule="1e-4"),
    dict(fused_cycle=True, adaptive_schedule="on", bucketed=True),
    dict(fused_cycle=True, bucketed=True),
    dict(fused_cycle=True, plan="auto"),
]


def _plan_of(cls, kw):
    try:
        p = cls.resolve(**kw)
    except ValueError as e:
        return ("error", type(e).__name__, str(e))
    sched = p.schedule
    return (
        None if sched is None else (sched.chunk_size, sched.loop, sched.bucketer.describe()),
        None if p.adaptive is None else (p.adaptive.tolerance, p.adaptive.patience),
        None if p.bucketer is None else p.bucketer.describe(),
        [(d.policy, d.action, d.reason) for d in p.decisions],
        p.cycle_fusion,
        p.describe(),
    )


@pytest.mark.parametrize("kw", COMBOS, ids=[",".join(f"{k}={v}" for k, v in c.items()) or "defaults"
                                            for c in COMBOS])
def test_resolve_matches_jax(kw, monkeypatch):
    for env in ("PHOTON_SOLVE_CHUNK", "PHOTON_ADAPTIVE_SCHEDULE", "PHOTON_SHAPE_LADDER",
                "PHOTON_SPARSE_KERNEL", "PHOTON_PLAN"):
        monkeypatch.delenv(env, raising=False)
    got, want = _plan_of(ExecutionPlan, kw), _plan_of(jplan.ExecutionPlan, kw)
    assert got == want
    if got[0] == "error":
        with pytest.raises(PlanError):
            ExecutionPlan.resolve(**kw)


@pytest.mark.parametrize("kw,flag", [
    (dict(plan="auto"), "--plan"), (dict(fused_cycle=True), "--fused-cycle"),
    (dict(distributed=True), "--distributed"),
    (dict(plan="on"), "--plan")])
def test_unported_policies_raise(kw, flag):
    if flag == "--plan":
        # the planner is ported: "auto" and its spelling "on" plan, and the
        # planner's own tests hold its decisions (test_torch_cost_plan.py)
        plan = ExecutionPlan.resolve(**kw)
        assert plan.plan_mode == "auto" and plan.cost_model is not None
        assert plan.describe().endswith("plan=auto[static-priors]")
    elif flag == "--distributed":
        # the mesh is ported (parallel/, tests/test_torch_parallel.py), and
        # with streaming it resolves the per-host streaming coordinates
        # (parallel/perhost_streaming.py), as the JAX plan does
        assert ExecutionPlan.resolve(**kw).describe() == (
            "execution plan: ladder=off schedule=one-shot adaptive=off sharding=mesh "
            "sparse=off streaming=off")
        assert ExecutionPlan.resolve(streaming=True, **kw).describe() == (
            "execution plan: ladder=off schedule=one-shot adaptive=off "
            "sharding=perhost_streaming sparse=off streaming=on")
        p = ExecutionPlan.resolve(streaming=True, fused_cycle=True, **kw)
        assert p.cycle_fusion == "solve"
        assert p.describe() == jplan.ExecutionPlan.resolve(
            streaming=True, fused_cycle=True, **kw).describe()
    else:
        # the fused cycle is ported: the whole iteration fuses, and the
        # plan resolves and describes itself as the JAX plan does
        p = ExecutionPlan.resolve(**kw)
        assert p.cycle_fusion == "full" and p.fused_cycle
        assert p.describe() == jplan.ExecutionPlan.resolve(**kw).describe()
        assert p.describe().endswith("fused-cycle=full")
    assert ExecutionPlan.resolve(plan="off").describe() == \
        "execution plan: ladder=off schedule=one-shot adaptive=off sharding=none sparse=off " \
        "streaming=off"


@pytest.mark.parametrize("extra", [
    ["--solve-compaction", "sideways"], ["--solve-compaction", "device:off"],
    ["--adaptive-schedule", "1e-3:x"], ["--vmapped-grid", "true", "--solve-compaction", "4"],
    ["--vmapped-grid", "true", "--adaptive-schedule", "on", "--bucketed-random-effects", "true"],
    ["--solve-compaction", "device:6", "--adaptive-schedule", "1e-4:3"],
])
def test_scheduler_flags_validate_as_the_jax_parser(tmp_path, extra):
    argv = _argv("train", "validate", str(tmp_path / "o"), "LBFGS") + extra
    try:
        want = jparams.parse_training_params(argv)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tparams.parse_training_params(argv)
        assert str(e) in str(got.value) or str(got.value) in str(e)
        return
    got = tparams.parse_training_params(argv)
    assert (got.solve_compaction, got.adaptive_schedule) == \
        (want.solve_compaction, want.adaptive_schedule)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def scheduled_runs(game_avro_dirs):  # noqa: F811
    """The JAX driver with --solve-compaction 3, and the port's unscheduled
    run, on the Avro fixture."""
    train_dir, val_dir, base = game_avro_dirs
    jout, tout = os.path.join(base, "jax-sched"), os.path.join(base, "port-plain")
    jd = jdriver.main(_argv(train_dir, val_dir, jout, "LBFGS") + ["--solve-compaction", "3"])
    td = tdriver.main(_argv(train_dir, val_dir, tout, "LBFGS") + ["--device", "cpu"])
    return jd, td, tout


@pytest.mark.parametrize("spec", ["3", "device:3"])
def test_scheduled_driver_matches_jax_and_the_unscheduled_bytes(game_avro_dirs,  # noqa: F811
                                                                scheduled_runs, tmp_path, spec):
    train_dir, val_dir, _ = game_avro_dirs
    jd, plain, plain_out = scheduled_runs
    out = str(tmp_path / "port")
    solve_stats.reset()  # the registries are process-wide
    compile_stats.reset()
    td = tdriver.main(_argv(train_dir, val_dir, out, "LBFGS")
                      + ["--solve-compaction", spec, "--device", "cpu"])
    assert td.solve_schedule.loop == ("device" if spec.startswith("device") else "host")
    (_, jres, jm), (_, tres, tm) = jd.results[0], td.results[0]
    assert_allclose(tres.objective_history, jres.objective_history, kind="solver",
                    dtype=np.float32)
    assert_allclose(tm["AUC"], jm["AUC"], kind="solver", dtype=np.float32)
    # the scheduled run is bitwise the unscheduled one: the same model bytes
    assert tres.objective_history == plain.results[0][1].objective_history
    assert _tree(os.path.join(out, "best")) == _tree(os.path.join(plain_out, "best"))
    with open(os.path.join(out, "photon-ml-tpu-game.log")) as f:
        log = f.read()
    assert "execution plan: ladder=off schedule=compaction(chunk=3, " in log
    assert "solve compaction: 2 solves / 24 lanes;" in log
    assert "compile stats:" in log


def test_adaptive_driver_matches_jax(game_avro_dirs, tmp_path):  # noqa: F811
    train_dir, val_dir, _ = game_avro_dirs
    flags = ["--bucketed-random-effects", "true", "--adaptive-schedule", "10:1",
             "--num-iterations", "3"]
    outs = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    jd = jdriver.main(_argv(train_dir, val_dir, outs["jax"], "LBFGS") + flags)
    td = tdriver.main(_argv(train_dir, val_dir, outs["port"], "LBFGS") + flags
                      + ["--device", "cpu"])
    (_, jres, _), (_, tres, _) = jd.results[0], td.results[0]
    assert_allclose(tres.objective_history, jres.objective_history, kind="solver",
                    dtype=np.float32)
    tcoord, jcoord = td.combo_coords[0]["per-user"], jd.combo_coords[0]["per-user"]
    got = [(d.policy, d.action, d.reason) for d in tcoord.skip_decisions]
    assert got == [(d.policy, d.action, d.reason) for d in jcoord.skip_decisions]
    assert any(a == "skipped" for _, a, _ in got)
    # the port writes the bucketed coordinate's ledger into retrain.json
    # (the JAX driver writes a streaming coordinate's only); the JAX loader
    # reads it, with the JAX coordinate's own entries
    with open(os.path.join(outs["port"], "retrain.json")) as f:
        written = json.load(f)["coordinates"]["per-user"]["convergence_ledger"]
    port, jax_ = JLedger.from_json(written), jcoord._ledger
    assert port.gids() == jax_.gids() == list(range(len(tcoord.buckets)))
    for g in port.gids():
        a, b = port.entry(g), jax_.entry(g)
        assert (a["visits"], a["skips"], a["streak"]) == (b["visits"], b["skips"], b["streak"])
        assert_allclose(a["score"], b["score"], kind="solver", dtype=np.float32)
