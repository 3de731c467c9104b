"""The port's fused descent cycle (``CoordinateDescent(fused_cycle=True)``,
``--fused-cycle``) against its own per-update descent and the JAX package's
fused cycle (CPU).

Each iteration runs every coordinate's solve in its fixed-trip form with no
host read between updates, so the fused run is held BITWISE to the port's
unfused run (LBFGS and TRON random effects; the dense stack and the
``pallas`` slab family, whose plain version runs here; the bucketed
coordinate through the driver), and to JAX ``fused_cycle=True`` at the
``solver`` tolerance of tests/tolerances.py. Ports of
tests/test_game_training.py:165-259 and ``::test_full_game_four_coordinate_cycle``,
tests/test_resilience.py:384-409, tests/test_adaptive_schedule.py:608-613,
tests/test_perhost_streaming.py:389-397 and tests/test_game_drivers.py:966-985.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from game_test_utils import make_full_game_data, make_glmix_data
from photon_ml_tpu.algorithm.coordinate_descent import CoordinateDescent as JCD
from photon_ml_tpu.algorithm.fixed_effect import FixedEffectCoordinate as JFixed
from photon_ml_tpu.algorithm.random_effect import RandomEffectCoordinate as JRandom
from photon_ml_tpu.data.game import RandomEffectDataConfig as JReConfig
from photon_ml_tpu.data.game import build_fixed_effect_batch as j_fe_batch
from photon_ml_tpu.data.game import build_random_effect_dataset as j_build
from photon_ml_tpu.ops import losses as jlosses
from photon_ml_tpu.ops.regularization import RegularizationContext as JReg
from photon_ml_tpu.optim.common import OptimizerConfig as JConfig
from photon_ml_tpu.optim.problem import GLMOptimizationProblem as JProblem
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import interop
from photon_ml_tpu_torch.algorithm.coordinate_descent import CoordinateDescent
from photon_ml_tpu_torch.algorithm.factored_random_effect import (
    FactoredRandomEffectCoordinate,
    MFOptimizationConfig,
)
from photon_ml_tpu_torch.algorithm.fixed_effect import FixedEffectCoordinate
from photon_ml_tpu_torch.algorithm.random_effect import RandomEffectCoordinate
from photon_ml_tpu_torch.checkpoint import CoordinateDescentCheckpointer
from photon_ml_tpu_torch.cli import game_params as tparams
from photon_ml_tpu_torch.cli import game_training_driver as tdriver
from photon_ml_tpu_torch.compile.plan import ExecutionPlan, PlanError
from photon_ml_tpu_torch.data import game as tgame
from photon_ml_tpu_torch.evaluation.evaluators import EvaluatorType, area_under_roc_curve, \
    evaluator_for
from photon_ml_tpu_torch.ops import losses as tlosses
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optim.common import HostReads, OptimizerConfig
from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.resilience.guards import DivergenceGuard
from photon_ml_tpu_torch.types import OptimizerType, TaskType
from test_game_drivers import game_avro_dirs  # noqa: F401
from test_torch_game import _port_data
from test_torch_game_driver import _argv
from tolerances import assert_allclose

TOL = 1e-4  # a decided stopping step in f32 (tests/test_torch_game.py)
OPTIMIZERS = ["LBFGS", "TRON"]


@pytest.fixture(scope="module")
def glmix():
    rng = np.random.default_rng(41)
    data, _ = make_glmix_data(rng, num_users=8, rows_per_user_range=(6, 20), d_fixed=6,
                              d_random=4)
    vdata, _ = make_glmix_data(np.random.default_rng(5), num_users=8,
                               rows_per_user_range=(3, 6), d_fixed=6, d_random=4)
    return data, _port_data(data), vdata, _port_data(vdata)


FE_CFG, RE_CFG = JConfig(max_iterations=30, tolerance=1e-6), JConfig(max_iterations=30,
                                                                      tolerance=TOL)
FE_REG, RE_REG = JReg.l2(0.1), JReg.l2(0.5)


def _port_coords(tdata, re_optimizer, spec="off"):
    conv = lambda x: interop.from_jax_numpy(x, "cpu")
    return {
        "fixed": FixedEffectCoordinate(
            tgame.build_fixed_effect_batch(tdata, "global", device="cpu"),
            GLMOptimizationProblem(TaskType.LOGISTIC_REGRESSION, OptimizerType.LBFGS,
                                   conv(FE_CFG), conv(FE_REG))),
        "per-user": RandomEffectCoordinate(
            tgame.build_random_effect_dataset(
                tdata, tgame.RandomEffectDataConfig("userId", "per_user"), device="cpu"),
            TaskType.LOGISTIC_REGRESSION, OptimizerType(re_optimizer), conv(RE_CFG),
            conv(RE_REG), sparse_kernel=spec),
    }


def _jax_coords(jdata, re_optimizer):
    return {
        "fixed": JFixed(j_fe_batch(jdata, "global", dense=True),
                        JProblem(JTask.LOGISTIC_REGRESSION, JOpt.LBFGS, FE_CFG, FE_REG)),
        "per-user": JRandom(j_build(jdata, JReConfig("userId", "per_user")),
                            JTask.LOGISTIC_REGRESSION, JOpt(re_optimizer), RE_CFG, RE_REG,
                            sparse_kernel="off"),
    }


def _port_cd(glmix, re_optimizer, fused, spec="off", guard=None):
    _, tdata, _, tvdata = glmix
    labels = torch.from_numpy(tdata.response)
    val_fe = tgame.build_fixed_effect_batch(tvdata, "global", device="cpu").features
    evals = {"AUC": (evaluator_for(EvaluatorType.AUC),
                     {"labels": torch.from_numpy(tvdata.response)})}
    return CoordinateDescent(_port_coords(tdata, re_optimizer, spec),
                             lambda s: torch.sum(tlosses.logistic.loss(s, labels)),
                             lambda p: val_fe.matvec(p["fixed"]), evals,
                             divergence_guard=guard, fused_cycle=fused)


def _bits(result):
    return (result.objective_history, result.validation_history,
            {n: w.numpy().tobytes() for n, w in result.coefficients.items()},
            result.total_scores.numpy().tobytes())


@pytest.mark.parametrize("spec", ["off", "pallas"])
@pytest.mark.parametrize("re_optimizer", OPTIMIZERS)
def test_fused_cycle_is_bitwise_the_unfused_descent(glmix, re_optimizer, spec):
    n = glmix[1].num_rows
    unfused = _port_cd(glmix, re_optimizer, False, spec).run(num_iterations=2, num_rows=n)
    reads0 = HostReads.count
    fused = _port_cd(glmix, re_optimizer, True, spec).run(num_iterations=2, num_rows=n)
    assert _bits(fused) == _bits(unfused)
    assert len(fused.objective_history) == len(fused.validation_history) == 4
    # the histories are read once an iteration, and the solves read nothing
    assert HostReads.count - reads0 == 2
    assert list(fused.timings) == ["(fused-cycle)"] and fused.trackers == {}


@pytest.mark.parametrize("re_optimizer", OPTIMIZERS)
def test_fused_cycle_matches_jax_fused_cycle(glmix, re_optimizer):
    """The port's fused cycle against JAX ``fused_cycle=True`` (the JAX
    test_fused_cycle_matches_unfused, across packages)."""
    jdata, tdata, vdata, _ = glmix
    labels = jnp.asarray(jdata.response)
    j_val_fe = j_fe_batch(vdata, "global", dense=True).features
    from photon_ml_tpu.evaluation.evaluators import EvaluatorType as JEvType
    from photon_ml_tpu.evaluation.evaluators import evaluator_for as j_evaluator

    j_evals = {"AUC": (j_evaluator(JEvType.AUC), {"labels": jnp.asarray(vdata.response)})}
    want = JCD(_jax_coords(jdata, re_optimizer),
               lambda s: jnp.sum(jlosses.logistic.loss(s, labels)),
               lambda p: j_val_fe.matvec(p["fixed"]), j_evals, fused_cycle=True).run(
        num_iterations=2, num_rows=jdata.num_rows)
    got = _port_cd(glmix, re_optimizer, True).run(num_iterations=2, num_rows=tdata.num_rows)
    assert len(got.objective_history) == len(want.objective_history) == 4
    assert_allclose(got.objective_history, want.objective_history, kind="solver",
                    dtype=np.float32)
    assert_allclose([m["AUC"] for m in got.validation_history],
                    [float(m["AUC"]) for m in want.validation_history], kind="solver",
                    dtype=np.float32)
    for name in ("fixed", "per-user"):
        assert_allclose(got.coefficients[name].numpy(), np.asarray(want.coefficients[name]),
                        kind="solver")
    assert_allclose(got.total_scores.numpy(), np.asarray(want.total_scores), kind="solver")
    assert "(fused-cycle)" in got.timings and "(fused-cycle)" in want.timings


@pytest.mark.parametrize("re_optimizer", OPTIMIZERS)
def test_fused_cycle_checkpoint_iteration_granularity(glmix, tmp_path, re_optimizer):
    """Fused checkpoints land at iteration boundaries and resume bit-exactly
    into a fresh fused run; a run stopped after one iteration resumes to
    the two-iteration run's bytes."""
    n = glmix[1].num_rows
    ck = lambda d: CoordinateDescentCheckpointer(str(tmp_path / d), run_fingerprint="f")
    full = _port_cd(glmix, re_optimizer, True).run(num_iterations=2, num_rows=n,
                                                    checkpointer=ck("ck"))
    assert ck("ck").latest_step() == 4  # 2 iterations x 2 coordinates
    resumed = _port_cd(glmix, re_optimizer, True).run(num_iterations=2, num_rows=n,
                                                       checkpointer=ck("ck"))
    assert _bits(resumed) == _bits(full)
    _port_cd(glmix, re_optimizer, True).run(num_iterations=1, num_rows=n,
                                            checkpointer=ck("half"))
    assert ck("half").latest_step() == 2
    finished = _port_cd(glmix, re_optimizer, True).run(num_iterations=2, num_rows=n,
                                                        checkpointer=ck("half"))
    assert _bits(finished) == _bits(full)


@pytest.mark.parametrize("re_optimizer", OPTIMIZERS)
def test_fused_resume_rejects_mid_iteration_checkpoint(glmix, tmp_path, re_optimizer):
    """A per-update checkpoint taken mid-iteration cannot resume into the
    fused cycle, with the JAX message."""
    n = glmix[1].num_rows
    ck_dir = str(tmp_path / "ck")
    _port_cd(glmix, re_optimizer, False).run(
        num_iterations=1, num_rows=n,
        checkpointer=CoordinateDescentCheckpointer(ck_dir, run_fingerprint="x"))
    shutil.rmtree(os.path.join(ck_dir, "step-2"))
    ck = CoordinateDescentCheckpointer(ck_dir, run_fingerprint="x")
    assert ck.latest_step() == 1
    with pytest.raises(ValueError, match="mid-iteration") as err:
        _port_cd(glmix, re_optimizer, True).run(num_iterations=1, num_rows=n,
                                                checkpointer=ck)
    assert str(err.value) == (
        "fused_cycle resume requires an iteration-aligned checkpoint; restored step 1 "
        "is mid-iteration (coordinates=2). Re-run unfused to finish the partial "
        "iteration first.")


def test_fused_cycle_refuses_frozen_and_host_bound_coordinates(glmix):
    n = glmix[1].num_rows
    cd = _port_cd(glmix, "LBFGS", True)
    init = {name: c.initial_coefficients() for name, c in cd.coordinates.items()}
    with pytest.raises(ValueError, match="frozen coordinates cannot compose with fused_cycle"):
        cd.run(num_iterations=1, num_rows=n, initial_params=init, frozen={"fixed"})
    cd.coordinates["per-user"].cd_jit = False  # as a scheduled coordinate is
    with pytest.raises(ValueError, match=r"\['per-user'\] hold multihost-sharded arrays"):
        cd.run(num_iterations=1, num_rows=n)


class _Counting:
    """Counts 0 -> 1 -> 2 each update (tests/test_resilience.py)."""

    def __init__(self, n, diverge_at=None):
        self.n, self.diverge_at = n, diverge_at

    def initial_coefficients(self):
        return torch.zeros(1)

    def update(self, offsets, init, **_):
        nxt = init + 1.0
        if self.diverge_at is None:
            return nxt, None
        return torch.where(init >= self.diverge_at, torch.full_like(init, float("nan")),
                           nxt), None

    def score(self, params):
        return torch.broadcast_to(params, (self.n,))

    def regularization_term(self, params, *_):
        return torch.sum(params) * 0.0


def test_fused_cycle_rollback_keeps_histories_aligned():
    """Iterations 3 and 4 diverge and roll back whole iterations as
    ``(fused-cycle)``; the histories keep one entry per update."""
    n = 4
    coords = {"a": _Counting(n, diverge_at=2.0), "b": _Counting(n)}
    cd = CoordinateDescent(coords, training_loss=lambda s: torch.sum(s), fused_cycle=True,
                           divergence_guard=DivergenceGuard())
    result = cd.run(num_iterations=4, num_rows=n)
    assert [e.action for e in result.guard_events] == ["rollback", "rollback"]
    assert all(e.coordinate == "(fused-cycle)" for e in result.guard_events)
    assert float(result.coefficients["a"][0]) == 2.0
    assert float(result.coefficients["b"][0]) == 2.0
    assert len(result.objective_history) == 8
    assert np.isfinite(result.objective_history).all()


@pytest.mark.parametrize("fused", [False, True])
def test_full_game_four_coordinate_cycle(fused):
    """The four-coordinate full GAME stack (fixed, per-user, per-item,
    factored per-artist) of tests/test_game_training.py: the objective
    decreases across cycles, scores are finite, AUC is strong, and the
    fused run is bitwise the unfused one."""
    rng = np.random.default_rng(9)
    jdata, _ = make_full_game_data(rng, num_users=20, num_items=8, num_artists=4,
                                   rows_per_user_range=(6, 12), d_fixed=5, d_user=3,
                                   d_item=3, d_artist=4)
    data = _port_data(jdata)

    def coords():
        re = lambda id_name, shard: RandomEffectCoordinate(
            tgame.build_random_effect_dataset(
                data, tgame.RandomEffectDataConfig(id_name, shard), device="cpu"),
            TaskType.LOGISTIC_REGRESSION, OptimizerType.LBFGS,
            OptimizerConfig(max_iterations=15, tolerance=1e-6), RegularizationContext.l2(1e-1))
        return {
            "fixed": FixedEffectCoordinate(
                tgame.build_fixed_effect_batch(data, "global", device="cpu"),
                GLMOptimizationProblem(TaskType.LOGISTIC_REGRESSION, OptimizerType.LBFGS,
                                       OptimizerConfig(max_iterations=20, tolerance=1e-7),
                                       RegularizationContext.l2(1e-2))),
            "per-user": re("userId", "per_user"),
            "per-item": re("itemId", "per_item"),
            "per-artist": FactoredRandomEffectCoordinate(
                dataset=tgame.build_random_effect_dataset(
                    data, tgame.RandomEffectDataConfig("artistId", "per_artist",
                                                       projector="IDENTITY"), device="cpu"),
                task=TaskType.LOGISTIC_REGRESSION,
                mf_config=MFOptimizationConfig(1, 2),
                re_optimizer_config=OptimizerConfig(max_iterations=8, tolerance=1e-6),
                latent_optimizer_config=OptimizerConfig(max_iterations=8, tolerance=1e-6)),
        }

    labels = torch.from_numpy(data.response)
    loss = lambda s: torch.sum(tlosses.logistic.loss(s, labels))
    result = CoordinateDescent(coords(), loss, fused_cycle=fused).run(2, data.num_rows)
    objs = result.objective_history
    assert len(objs) == 8 and objs[-1] <= objs[0]
    assert torch.isfinite(result.total_scores).all()
    assert float(area_under_roc_curve(result.total_scores, labels)) > 0.8
    if fused:
        plain = CoordinateDescent(coords(), loss).run(2, data.num_rows)
        assert plain.objective_history == objs
        assert plain.total_scores.numpy().tobytes() == result.total_scores.numpy().tobytes()


def test_adaptive_fused_cycle_impossible():
    """tests/test_adaptive_schedule.py:608-613, with the JAX message."""
    from photon_ml_tpu.compile.plan import ExecutionPlan as JPlan

    with pytest.raises(PlanError, match="adaptive-schedule") as err:
        ExecutionPlan.resolve(adaptive_schedule="1e-4", fused_cycle=True)
    with pytest.raises(ValueError) as jerr:
        JPlan.resolve(adaptive_schedule="1e-4", fused_cycle=True)
    assert str(err.value) == str(jerr.value)


def test_streaming_fused_cycle_parses_and_fuses_per_solve(tmp_path):
    """tests/test_perhost_streaming.py:389-397: the streaming x fused-cycle
    combination parses, and the plan fuses per block solve."""
    argv = _argv("train", "validate", str(tmp_path / "o"), "LBFGS") + [
        "--streaming-random-effects", "true", "--fused-cycle", "true"]
    p = tparams.parse_training_params(argv)
    assert p.streaming_random_effects and p.fused_cycle
    from photon_ml_tpu.cli.game_params import parse_training_params as jparse

    j = jparse(argv)
    assert (j.streaming_random_effects, j.fused_cycle) == (True, True)
    plan = ExecutionPlan.resolve(streaming=True, fused_cycle=True)
    assert plan.cycle_fusion == "solve"


def test_multihost_driver_refuses_the_fused_cycle_as_jax(tmp_path):
    from photon_ml_tpu.cli import game_multihost_driver as jmh
    from photon_ml_tpu.cli.game_params import parse_training_params as jparse
    from photon_ml_tpu_torch.cli import game_multihost_driver as tmh

    argv = _argv("train", "validate", str(tmp_path / "o"), "LBFGS") + ["--fused-cycle", "true"]
    with pytest.raises(ValueError) as terr:
        tmh._check_multihost_support(tparams.parse_training_params(argv))
    with pytest.raises(ValueError) as jerr:
        jmh._check_multihost_support(jparse(argv))
    assert "['--fused-cycle']" in str(terr.value) and "['--fused-cycle']" in str(jerr.value)


@pytest.mark.parametrize("re_optimizer", OPTIMIZERS)
def test_driver_fused_cycle_is_bitwise_the_unfused_driver_and_matches_jax(
        game_avro_dirs, tmp_path, re_optimizer):  # noqa: F811
    """``--fused-cycle true`` through the GAME driver: the saved model is
    byte-equal to the unfused driver's; the objective and the metrics match
    the JAX driver's ``--fused-cycle true`` run at ``solver``."""
    from photon_ml_tpu.cli import game_training_driver as jdriver

    train_dir, val_dir, _ = game_avro_dirs
    argv = lambda out: _argv(train_dir, val_dir, str(tmp_path / out), re_optimizer)
    plain = tdriver.main(argv("plain") + ["--device", "cpu"])
    reads0 = HostReads.count
    fused = tdriver.main(argv("fused") + ["--device", "cpu", "--fused-cycle", "true"])
    assert fused.plan.cycle_fusion == "full"
    # the whole driver run reads back the histories once an iteration and
    # nothing else that the solver loops count
    assert HostReads.count - reads0 == 2
    (_, pres, pmet), (_, fres, fmet) = plain.results[0], fused.results[0]
    assert fres.objective_history == pres.objective_history and fmet == pmet
    assert _tree_bytes(str(tmp_path / "fused" / "best")) == \
        _tree_bytes(str(tmp_path / "plain" / "best"))
    jd = jdriver.main(argv("jax") + ["--fused-cycle", "true"])
    (_, jres, jmet) = jd.results[0]
    assert_allclose(fres.objective_history, jres.objective_history, kind="solver",
                    dtype=np.float32)
    assert_allclose(fmet["AUC"], jmet["AUC"], kind="solver", dtype=np.float32)


def test_bucketed_plus_fused_cycle(game_avro_dirs, tmp_path):  # noqa: F811
    """tests/test_game_drivers.py:966-985: --bucketed-random-effects with
    --fused-cycle, here bitwise the unfused bucketed driver, and its AUC
    within the JAX test's 5e-3 of the plain driver's."""
    train_dir, val_dir, _ = game_avro_dirs
    argv = lambda out: _argv(train_dir, val_dir, str(tmp_path / out), "LBFGS") + [
        "--device", "cpu", "--bucketed-random-effects", "true"]
    plain = tdriver.main(argv("bucketed"))
    fused = tdriver.main(argv("fused") + ["--fused-cycle", "true"])
    local = tdriver.main(_argv(train_dir, val_dir, str(tmp_path / "local"), "LBFGS")
                         + ["--device", "cpu"])
    (_, pres, pmet), (_, fres, fmet) = plain.results[0], fused.results[0]
    assert fres.objective_history == pres.objective_history and fmet == pmet
    assert _tree_bytes(str(tmp_path / "fused" / "best")) == \
        _tree_bytes(str(tmp_path / "bucketed" / "best"))
    assert fmet["AUC"] == pytest.approx(local.results[0][2]["AUC"], abs=5e-3)


def test_delta_retrain_resolves_frozen_coordinates_warm_under_the_fused_cycle(
        game_avro_dirs, tmp_path):  # noqa: F811
    """The delta retrain's frozen coordinates re-solve warm under
    ``--fused-cycle``, logged as the JAX driver logs it: day 1 changes only
    the random effect's optimizer, so the fixed effect is classified
    unchanged, and the fused run solves it anyway."""
    train_dir, val_dir, _ = game_avro_dirs
    tdriver.main(_argv(train_dir, val_dir, str(tmp_path / "day0"), "LBFGS")
                 + ["--device", "cpu"])
    warm = ["--device", "cpu", "--warm-start-from", str(tmp_path / "day0")]
    unfused = tdriver.main(_argv(train_dir, val_dir, str(tmp_path / "day1"), "TRON") + warm)
    assert unfused.delta_plan.frozen_coordinates() == {"fixed"}
    fused = tdriver.main(_argv(train_dir, val_dir, str(tmp_path / "day1f"), "TRON") + warm
                         + ["--fused-cycle", "true"])
    with open(os.path.join(str(tmp_path / "day1f"), "photon-ml-tpu-game.log")) as f:
        log = f.read()
    assert ("delta retrain: --fused-cycle compiles every coordinate into one program — "
            "frozen coordinates re-solve warm instead of skipping") in log
    # re-solved from the prior model, the fixed effect moves off it
    assert fused.results[0][1].objective_history != unfused.results[0][1].objective_history


def _tree_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            with open(os.path.join(dirpath, name), "rb") as f:
                out[os.path.relpath(os.path.join(dirpath, name), root)] = f.read()
    return out
