"""The port's planner (photon_ml_tpu_torch.compile.cost and the planner
pass of ExecutionPlan.resolve) held against the JAX package's
(tests/test_cost_plan.py) on the same inputs: priors, the EMA, ``choose``,
drift and merge float for float; each package reads the other's
``cost-model.json``; ``--plan off`` resolves bitwise as without a planner;
explicit knobs win; a torn sidecar degrades with a recorded decision; the
``resolve(plan="auto")`` decisions equal the JAX package's. The GAME driver
under ``--plan auto`` writes the JAX driver's cost-model keys and planned
decisions (the realized values are each package's own: a trace is an XLA
trace there and a CUDA-graph capture here)."""

import json
import math
import os

import pytest

from photon_ml_tpu.compile import cost as jcost
from photon_ml_tpu.compile.plan import ExecutionPlan as JPlan
from photon_ml_tpu_torch.compile import cost
from photon_ml_tpu_torch.compile.cost import (
    CHUNK_PAUSE_COST,
    COST_MODEL_FILENAME,
    DRIFT_THRESHOLD,
    EMA_ALPHA,
    PRIOR_EASY_ITERS,
    PRIOR_HARD_ITERS,
    TRACE_COST,
    CostModel,
    WorkloadProfile,
)
from photon_ml_tpu_torch.compile.overrides import resolve_overrides, resolve_plan_mode
from photon_ml_tpu_torch.ops.features import sparse_transpose_forced
from photon_ml_tpu_torch.types import dtype_name
from photon_ml_tpu_torch.compile.plan import ExecutionPlan, PlanDecision
from photon_ml_tpu_torch.optim.convergence import ConvergenceLedger
from photon_ml_tpu_torch.optim.scheduler import SolveRecord, SolveStats

PROFILES = {
    "skewed": dict(num_lanes=512, max_rows=3200, median_rows=32, dim=16),
    "uniform": dict(num_lanes=512, max_rows=32, median_rows=32, dim=16),
    "unknown": dict(),
    "sparse-skewed": dict(num_lanes=64, max_rows=900, median_rows=20, dim=40, density=0.05),
    "sparse-uniform": dict(num_lanes=2048, max_rows=12, median_rows=10, dim=9, density=0.6),
}
SKEWED = WorkloadProfile(**PROFILES["skewed"])
UNIFORM = WorkloadProfile(**PROFILES["uniform"])
POLICIES = {
    "schedule": ("one-shot", "chunk:2", "chunk:4", "chunk:8", "chunk:16", "chunk:32",
                 "device:8", "device:16", "chunk:oops"),
    "ladder": ("off", "on", "sideways"),
    "sparse": ("dense", "segment", "scatter", "flat", "pallas"),
    "prefetch": ("2", "0", "4"),
    "blocking": ("keep", "reblock"),
    "sharding": ("none", "mesh", "perhost_streaming"),
}


@pytest.fixture(autouse=True)
def _clean_plan_env(monkeypatch):
    for var in ("PHOTON_PLAN", "PHOTON_SHAPE_LADDER", "PHOTON_SOLVE_CHUNK",
                "PHOTON_SPARSE_KERNEL", "PHOTON_PREFETCH_DEPTH", "PHOTON_ADAPTIVE_SCHEDULE"):
        monkeypatch.delenv(var, raising=False)


def _both(name):
    kw = PROFILES[name]
    return WorkloadProfile(**kw), jcost.WorkloadProfile(**kw)


# ---------------------------------------------------------------------------
# the cost algebra, float for float
# ---------------------------------------------------------------------------


def test_constants_are_the_jax_packages():
    for name in ("CHUNK_PAUSE_COST", "COST_MODEL_FILENAME", "COST_MODEL_FORMAT",
                 "DRIFT_THRESHOLD", "EMA_ALPHA", "PRIOR_EASY_ITERS", "PRIOR_HARD_ITERS",
                 "REBLOCK_IMBALANCE", "TRACE_COST", "_DRIFT_LOG_CAP"):
        assert getattr(cost, name) == getattr(jcost, name), name


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_priors_and_choices_equal_jax(profile):
    mine, theirs = _both(profile)
    assert (mine.signature(), mine.skew()) == (theirs.signature(), theirs.skew())
    m, j = CostModel(), jcost.CostModel()
    for policy, actions in POLICIES.items():
        for action in actions:
            assert m.prior(policy, action, mine) == j.prior(policy, action, theirs), \
                (policy, action)
        cands = tuple(a for a in actions if a not in ("chunk:oops", "sideways"))
        assert m.choose(policy, cands, mine) == j.choose(policy, cands, theirs)


def test_schedule_priors_pay_skew_and_the_pause_tariff():
    m, lanes = CostModel(), SKEWED.num_lanes
    assert m.prior("schedule", "one-shot", SKEWED) == lanes * PRIOR_HARD_ITERS
    hard_frac = 8.0 / lanes
    for c in (2, 8, 32):
        per_easy = math.ceil(PRIOR_EASY_ITERS / c) * c
        per_hard = math.ceil(PRIOR_HARD_ITERS / c) * c
        expect = lanes * ((1.0 - hard_frac) * per_easy + hard_frac * per_hard) \
            + CHUNK_PAUSE_COST * math.ceil(PRIOR_HARD_ITERS / c)
        assert m.prior("schedule", f"chunk:{c}", SKEWED) == expect
    assert m.prior("schedule", "chunk:oops", SKEWED) == float("inf")
    with pytest.raises(ValueError, match="no candidates"):
        m.choose("schedule", (), SKEWED)


def _observations(model, sig_profile):
    model.observe("schedule", "chunk:8", sig_profile, 1000.0)
    model.observe("schedule", "chunk:8", sig_profile, 2000.0)
    model.observe("ladder", "on", sig_profile, 100.0, predicted=100.0)
    model.observe("ladder", "on", sig_profile, 100.0 * (1 + DRIFT_THRESHOLD) + 1,
                  predicted=100.0)
    model.observe("blocking", "keep", sig_profile, 1.25)


def test_ema_drift_and_merge_equal_jax():
    mine, theirs = _both("skewed")
    m, j = CostModel(), jcost.CostModel()
    _observations(m, mine)
    _observations(j, theirs)
    assert m.to_json() == j.to_json()
    assert m.predict("schedule", "chunk:8", mine) == EMA_ALPHA * 2000.0 + (1 - EMA_ALPHA) * 1000.0
    assert m.predict("schedule", "chunk:8", UNIFORM) == m.prior("schedule", "chunk:8", UNIFORM)
    assert m.drifted() == j.drifted() and len(m.drifted()) == 4  # all but the first ladder one
    assert m.choose("schedule", POLICIES["schedule"][:8], mine) == \
        j.choose("schedule", POLICIES["schedule"][:8], theirs)
    other, jother = CostModel(), jcost.CostModel()
    other.observe("schedule", "chunk:8", mine, 400.0)
    jother.observe("schedule", "chunk:8", theirs, 400.0)
    merged, jmerged = m.merge(other), j.merge(jother)
    assert merged.to_json() == jmerged.to_json()
    assert merged.observations["schedule=chunk:8@skewed"]["n"] == 3
    assert merged.source == "static-priors+static-priors"


@pytest.mark.parametrize("costs", [None, {}, {0: 10.0, 1: 11.0}, {0: 10.0, 1: 40.0, 2: 9.0}])
def test_reblock_recommendation_equals_jax(costs):
    assert CostModel().reblock_recommendation(costs) == \
        jcost.CostModel().reblock_recommendation(costs)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_sidecar(tmp_path, writer):
    mine, theirs = _both("skewed")
    model = CostModel() if writer == "port" else jcost.CostModel()
    _observations(model, mine if writer == "port" else theirs)
    path = model.save(str(tmp_path))
    assert os.listdir(tmp_path) == [COST_MODEL_FILENAME]
    got, want = CostModel.load(str(tmp_path)), jcost.CostModel.load(str(tmp_path))
    assert got.to_json() == want.to_json() == model.to_json()
    assert got.source == want.source == path


@pytest.mark.parametrize("payload", ['{"format": 1, "obs', '{"format": 99}',
                                     '{"format": 1, "observations": 3}', "[]"])
def test_a_torn_or_foreign_sidecar_loads_as_none(tmp_path, payload):
    (tmp_path / COST_MODEL_FILENAME).write_text(payload)
    assert CostModel.load(str(tmp_path)) is None
    assert jcost.CostModel.load(str(tmp_path)) is None


# ---------------------------------------------------------------------------
# the planner pass
# ---------------------------------------------------------------------------


def _decisions(plan):
    return [(d.policy, d.action, d.reason, d.predicted_cost, d.realized_cost)
            for d in plan.decisions]


def _resolved(plan):
    return (plan.bucketer.describe() if plan.bucketer else None,
            plan.schedule.describe() if plan.schedule else None, plan.sparse_kernel,
            plan.prefetch_depth, plan.sparse_candidates, plan.plan_mode, plan.describe())


RESOLVE_CASES = {
    "defaults": dict(),
    "explicit-knobs": dict(solve_compaction="4", shape_canonicalization="on", prefetch_depth=7),
    "device-loop": dict(solve_compaction="device:6"),
    "streaming-bucketed": dict(streaming=True, bucketed=True),
    "adaptive-bucketed": dict(adaptive_schedule="on", bucketed=True),
    "vmapped-grid": dict(vmapped_grid="true"),
    "sparse-forced": dict(sparse_kernel="pallas"),
}


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("case", sorted(RESOLVE_CASES))
def test_resolve_auto_decisions_equal_jax(profile, case):
    mine, theirs = _both(profile)
    kw = RESOLVE_CASES[case]
    got = ExecutionPlan.resolve(plan="auto", workload=mine, **kw)
    want = JPlan.resolve(plan="auto", workload=theirs, **kw)
    assert _decisions(got) == _decisions(want)
    assert _resolved(got) == _resolved(want)


@pytest.mark.parametrize("case", sorted(RESOLVE_CASES))
def test_plan_off_resolves_bitwise_as_without_a_planner(tmp_path, case):
    kw = RESOLVE_CASES[case]
    p = ExecutionPlan.resolve(**kw)
    q = ExecutionPlan.resolve(plan="off", workload=SKEWED, cost_model_dir=str(tmp_path), **kw)
    for field in ("bucketer", "schedule", "adaptive", "sparse_kernel",
                  "prefetch_depth", "decisions", "sparse_candidates", "streaming"):
        assert getattr(p, field) == getattr(q, field), field
    assert p.describe() == q.describe() and "plan=" not in q.describe()
    assert q.plan_mode == "off" and q.cost_model is None
    q.record_realized("schedule", 123.0)
    assert q.save_cost_model(str(tmp_path)) is None
    assert not os.path.exists(tmp_path / COST_MODEL_FILENAME)
    assert _decisions(q) == _decisions(JPlan.resolve(**kw))


def test_plan_mode_grammar_and_overrides(monkeypatch):
    for spec, mode in ((None, "off"), ("", "off"), ("OFF", "off"), ("none", "off"),
                       ("auto", "auto"), ("on", "auto"), ("1", "auto"), ("true", "auto")):
        assert resolve_plan_mode(spec) == mode
    with pytest.raises(ValueError, match="PHOTON_PLAN"):
        ExecutionPlan.resolve(plan="definitely-not-a-mode")
    monkeypatch.setenv("PHOTON_PLAN", "auto")
    assert ExecutionPlan.resolve().plan_mode == "auto"
    assert ExecutionPlan.resolve(plan="off").plan_mode == "off"  # the flag wins
    monkeypatch.setenv("PHOTON_ML_TPU_DTYPE", "float64")
    monkeypatch.setenv("PHOTON_ML_TPU_SPARSE_TRANSPOSE", "0")
    monkeypatch.setenv("PHOTON_DONATE", "0")  # no buffer donation in torch: not read
    o = resolve_overrides()
    assert (o.plan_mode, o.dtype, o.sparse_transpose, o.donate) == (
        "auto", "float64", False, True)
    assert (o.dtype, o.sparse_transpose) == (dtype_name(), sparse_transpose_forced())


def test_explicit_knobs_always_win_under_auto():
    p = ExecutionPlan.resolve(plan="auto", workload=SKEWED, solve_compaction="4",
                              shape_canonicalization="on", prefetch_depth=7)
    assert p.schedule.chunk_size == 4 and p.prefetch_depth == 7
    pinned = [d for d in p.decisions if d.policy == "schedule" and d.action == "pinned"]
    assert len(pinned) == 1 and pinned[0].planned_choice() is None
    assert not [d for d in p.decisions if d.policy in ("ladder", "prefetch")]


def test_unsupported_topologies_still_raise_under_auto():
    for kw in (dict(fused_cycle=True), dict(distributed=True)):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            ExecutionPlan.resolve(plan="auto", workload=SKEWED, **kw)


def test_sidecar_sources_are_recorded_decisions(tmp_path):
    src = lambda p: next(d for d in p.decisions if d.policy == "cost-model")
    p = ExecutionPlan.resolve(plan="auto", workload=SKEWED)
    assert src(p).action == "priors" and p.cost_model.source == "static-priors"
    p = ExecutionPlan.resolve(plan="auto", workload=SKEWED, cost_model_dir=str(tmp_path))
    assert src(p).action == "degraded" and "static priors" in src(p).reason
    (tmp_path / COST_MODEL_FILENAME).write_text('{"format": 1, "obs')
    p = ExecutionPlan.resolve(plan="auto", workload=SKEWED, cost_model_dir=str(tmp_path))
    assert src(p).action == "degraded"
    assert [d for d in p.decisions if d.policy == "schedule"]  # it still planned
    j = JPlan.resolve(plan="auto", workload=jcost.WorkloadProfile(**PROFILES["skewed"]),
                      cost_model_dir=str(tmp_path))
    assert _decisions(p) == _decisions(j)


REALIZED = (("schedule", 9332.0), ("ladder", 250.0), ("sharding", 8432.0), ("blocking", 2.0))


def _fed_back(plan_cls, directory, profile):
    plan = plan_cls.resolve(plan="auto", workload=profile, cost_model_dir=directory)
    for policy, realized in REALIZED:
        plan.record_realized(policy, realized)
    plan.save_cost_model(directory)
    return plan


def test_realized_feedback_and_the_warm_rerun_equal_jax(tmp_path):
    mine, theirs = _both("skewed")
    pdir, jdir = tmp_path / "p", tmp_path / "j"
    pdir.mkdir(), jdir.mkdir()
    for _ in range(2):  # a cold run, then a warm one that reads the sidecar
        p = _fed_back(ExecutionPlan, str(pdir), mine)
        j = _fed_back(JPlan, str(jdir), theirs)
        assert [d[1:] for d in _decisions(p)][1:] == [d[1:] for d in _decisions(j)][1:]
    assert (pdir / COST_MODEL_FILENAME).read_bytes() == (jdir / COST_MODEL_FILENAME).read_bytes()
    sched = next(d for d in p.decisions if d.policy == "schedule")
    assert sched.realized_cost == 9332.0 and "realized=9332" in sched.describe()
    assert next(d for d in p.decisions if d.policy == "cost-model").action == "loaded"
    # a torn tmp file from a crashed write leaves the sidecar as it was
    (pdir / (COST_MODEL_FILENAME + ".tmp")).write_text('{"form')
    assert CostModel.load(str(pdir)).to_json() == jcost.CostModel.load(str(jdir)).to_json()


def test_a_pathological_ladder_cost_flips_the_ladder_off(tmp_path):
    plan = ExecutionPlan.resolve(plan="auto", workload=SKEWED, cost_model_dir=str(tmp_path))
    assert plan.bucketer is not None
    off_prior = plan.cost_model.prior("ladder", "off", SKEWED)
    plan.record_realized("ladder", 4.0 * off_prior)
    plan.record_realized("ladder", 4.0 * off_prior)
    plan.save_cost_model(str(tmp_path))
    warm = ExecutionPlan.resolve(plan="auto", workload=SKEWED, cost_model_dir=str(tmp_path))
    dec = next(d for d in warm.decisions if d.policy == "ladder")
    assert dec.planned_choice() == "off" and warm.bucketer is None
    assert TRACE_COST > 0


def test_the_drivers_profile_plans_the_default_knobs():
    """The GAME driver passes no workload: its signature is ``unknown``, and
    the priors keep one-shot solves, the ladder off, depth 2 and the
    blocking, so no device loop ever meets a plain slab family through
    the planner."""
    p = ExecutionPlan.resolve(plan="auto")
    planned = {d.policy: d.planned_choice() for d in p.decisions if d.planned_choice()}
    assert planned == {"schedule": "one-shot", "ladder": "off", "prefetch": "2",
                       "blocking": "keep", "sharding": "none"}
    assert p.schedule is None and p.bucketer is None and p.sparse_kernel is None


def test_realized_plan_cost_and_observed_costs():
    stats = SolveStats()
    assert stats.realized_plan_cost() is None
    stats.record(SolveRecord("a", lanes=4, max_iteration=10, executed=25, baseline=40,
                             chunks=[None, None, None]))
    assert stats.realized_plan_cost() == 25 + CHUNK_PAUSE_COST * 3
    ledger = ConvergenceLedger()
    ledger.observe(0, 0.5, executed=30, epoch=1)
    ledger.observe(0, 0.1, executed=10, epoch=2)
    ledger.record_skip(1, epoch=2)
    assert ledger.observed_costs() == {0: 20.0}


def test_plan_decision_describes_costs_as_jax():
    from photon_ml_tpu.compile.plan import PlanDecision as JDecision

    for kw in (dict(), dict(predicted_cost=12.4), dict(predicted_cost=12.4, realized_cost=99.6)):
        for action in ("pinned", "planned:chunk:8"):
            mine, theirs = PlanDecision("schedule", action, "why", **kw), \
                JDecision("schedule", action, "why", **kw)
            assert mine.describe() == theirs.describe()
            assert mine.planned_choice() == theirs.planned_choice()


def test_the_manifest_carries_the_cost_model_only_under_auto(tmp_path):
    from photon_ml_tpu.retrain.manifest import RetrainManifest as JManifest
    from photon_ml_tpu_torch.retrain.manifest import RetrainManifest

    m = CostModel()
    m.observe("schedule", "chunk:8", SKEWED, 900.0)
    base = dict(output_dir=str(tmp_path), model_dir=str(tmp_path), task="LOGISTIC_REGRESSION",
                file_stats=[], ingest_inputs=[], ingest_digest="d", updating_sequence=[],
                coordinates={})
    RetrainManifest(cost_model=m.to_json(), **base).save(str(tmp_path))
    assert JManifest.load(str(tmp_path)).cost_model == m.to_json()
    path = RetrainManifest(**base).save(str(tmp_path))
    assert "cost_model" not in json.load(open(path))
    assert RetrainManifest.load(str(tmp_path)).cost_model is None


@pytest.fixture(scope="module")
def planned_driver_runs(tmp_path_factory):
    """Both GAME drivers under --plan auto on the same Avro: a cold run,
    then a warm run from it."""
    import numpy as np

    from game_test_utils import make_glmix_data, write_game_avro
    from photon_ml_tpu.cli import game_training_driver as jdriver
    from photon_ml_tpu_torch.cli import game_training_driver as tdriver

    base = tmp_path_factory.mktemp("plan")
    gd, truth = make_glmix_data(np.random.default_rng(5), num_users=12,
                                rows_per_user_range=(6, 10), d_fixed=4, d_random=3)
    train = str(base / "train")
    os.makedirs(train)
    write_game_avro(os.path.join(train, "part-0.avro"), gd, range(gd.num_rows), truth)
    flags = [
        "--train-input-dirs", train, "--task-type", "LOGISTIC_REGRESSION",
        "--feature-shard-id-to-feature-section-keys-map",
        "global:fixedFeatures|per_user:userFeatures",
        "--updating-sequence", "fixed,per-user",
        "--fixed-effect-data-configurations", "fixed:global,1",
        "--random-effect-data-configurations", "per-user:userId,per_user,1,-1,-1,-1,INDEX_MAP",
        "--fixed-effect-optimization-configurations", "fixed:20,1e-7,0.01,1,LBFGS,L2",
        "--random-effect-optimization-configurations", "per-user:15,1e-6,0.1,1,LBFGS,L2",
        "--streaming-random-effects", "true", "--plan", "auto", "--num-iterations", "2",
    ]
    # a new lambda: nothing freezes, every coordinate re-solves warm
    wflags = [("per-user:15,1e-6,0.2,1,LBFGS,L2" if f == "per-user:15,1e-6,0.1,1,LBFGS,L2"
               else f) for f in flags]
    from photon_ml_tpu.compile import compile_stats as jcompile_stats
    from photon_ml_tpu.optim.scheduler import solve_stats as jsolve_stats
    from photon_ml_tpu_torch.compile import compile_stats
    from photon_ml_tpu_torch.optim.scheduler import solve_stats

    def fresh(main):
        """A driver run whose realized costs are its own, as in a process
        of its own (the stats registries are process-wide)."""
        def run(argv):
            for stats in (jsolve_stats, jcompile_stats, solve_stats, compile_stats):
                stats.reset()
            return main(argv)
        return run

    jmain, tmain = fresh(jdriver.main), fresh(tdriver.main)
    runs = {}
    for pkg, main, extra in (("jax", jmain, []), ("port", tmain, ["--device", "cpu"])):
        cold = str(base / f"{pkg}-cold")
        runs[pkg, "cold"] = main(flags + ["--output-dir", cold] + extra), cold
    # each warm run reads the JAX cold run's sidecar and retrain.json, so
    # both plan from the same realized costs; the port's own warm run reads
    # its own
    jcold, pcold = runs["jax", "cold"][1], runs["port", "cold"][1]
    for key, main, prior, extra in (("jax", jmain, jcold, []),
                                    ("port", tmain, jcold, ["--device", "cpu"]),
                                    ("own", tmain, pcold, ["--device", "cpu"])):
        warm = str(base / f"{key}-warm")
        runs[key, "warm"] = main(wflags + ["--output-dir", warm, "--warm-start-from", prior]
                                 + extra), warm
    return runs


def _planned(driver):
    return [(d.policy, d.action, d.predicted_cost) for d in driver.plan.decisions
            if d.policy != "cost-model"]


@pytest.mark.parametrize("run", ["cold", "warm"])
def test_the_drivers_plan_and_cost_model_keys_match_jax(planned_driver_runs, run):
    (port, pout), (jax, jout) = planned_driver_runs["port", run], planned_driver_runs["jax", run]
    assert _planned(port) == _planned(jax)
    src = lambda d: next(x for x in d.plan.decisions if x.policy == "cost-model").action
    assert src(port) == src(jax) == ("degraded" if run == "cold" else "loaded")
    mine = json.load(open(os.path.join(pout, COST_MODEL_FILENAME)))
    theirs = json.load(open(os.path.join(jout, COST_MODEL_FILENAME)))
    # the port records what it measured: no ladder key where no CUDA graph
    # was captured (the JAX run traces on every run)
    assert set(mine["observations"]) <= set(theirs["observations"])
    assert "blocking=keep@unknown" in mine["observations"]
    manifest = json.load(open(os.path.join(pout, "retrain.json")))
    assert manifest["cost_model"] == mine
    assert CostModel.load(pout).to_json() == mine


def test_the_ports_own_warm_run_reads_its_sidecar(planned_driver_runs):
    own, out = planned_driver_runs["own", "warm"]
    src = next(x for x in own.plan.decisions if x.policy == "cost-model")
    assert src.action == "loaded" and "port-cold" in src.reason
    assert own.delta_plan is not None and not own.delta_plan.short_circuit
    assert own._warm_fixed and own._warm_spilled  # warm-started, nothing frozen
    assert not own._frozen_blocks.get("per-user")
    blocking = next(d for d in own.plan.decisions if d.policy == "blocking")
    assert blocking.realized_cost is not None
    assert json.load(open(os.path.join(out, COST_MODEL_FILENAME)))["observations"][
        "blocking=keep@unknown"]["n"] == 2
