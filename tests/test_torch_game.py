"""The port's GAME training pieces against the JAX package (CPU): the
random-effect dataset build (byte-equal), the random-effect coordinate's
update and score (LBFGS and TRON; dense stack, and slab with the ``pallas``
spec, whose plain version runs on the CPU), and ``CoordinateDescent.run``
over a fixed and a random effect on ``make_glmix_data``.

Solver outputs at the ``solver`` tolerance of tests/tolerances.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from game_test_utils import make_glmix_data
from photon_ml_tpu.algorithm.coordinate_descent import CoordinateDescent as JCD
from photon_ml_tpu.algorithm.fixed_effect import FixedEffectCoordinate as JFixed
from photon_ml_tpu.algorithm.random_effect import RandomEffectCoordinate as JRandom
from photon_ml_tpu.algorithm.random_effect import global_coefficients as j_global
from photon_ml_tpu.data.game import RandomEffectDataConfig as JReConfig
from photon_ml_tpu.data.game import build_fixed_effect_batch as j_fe_batch
from photon_ml_tpu.data.game import build_random_effect_dataset as j_build
from photon_ml_tpu.evaluation.evaluators import EvaluatorType as JEvType
from photon_ml_tpu.evaluation.evaluators import evaluator_for as j_evaluator
from photon_ml_tpu.ops import losses as jlosses
from photon_ml_tpu.ops.regularization import RegularizationContext as JReg
from photon_ml_tpu.optim.common import OptimizerConfig as JConfig
from photon_ml_tpu.optim.problem import GLMOptimizationProblem as JProblem
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import interop
from photon_ml_tpu_torch.algorithm.coordinate_descent import CoordinateDescent
from photon_ml_tpu_torch.algorithm.fixed_effect import FixedEffectCoordinate
from photon_ml_tpu_torch.algorithm.random_effect import RandomEffectCoordinate, global_coefficients
from photon_ml_tpu_torch.data import game as tgame
from photon_ml_tpu_torch.evaluation.evaluators import EvaluatorType, evaluator_for
from photon_ml_tpu_torch.ops import fused_sparse as tfs
from photon_ml_tpu_torch.ops import losses as tlosses
from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.types import OptimizerType, TaskType
from tolerances import assert_allclose

TOL = 1e-4  # a decided stopping step in f32 (see tests/test_torch_tron.py)


def _port_data(jdata):
    """The same GameData as the port's host container."""
    return tgame.GameData(
        response=jdata.response, offset=jdata.offset, weight=jdata.weight,
        ids=dict(jdata.ids), id_vocabs=dict(jdata.id_vocabs),
        shards={k: tgame.HostFeatures(f.indptr, f.indices, f.values, f.dim)
                for k, f in jdata.shards.items()},
    )


@pytest.fixture(scope="module")
def glmix():
    rng = np.random.default_rng(41)
    data, _ = make_glmix_data(rng, num_users=8, rows_per_user_range=(6, 20), d_fixed=6,
                              d_random=4)
    return data, _port_data(data)


CONFIGS = {
    "plain": dict(random_effect_id="userId", feature_shard_id="per_user"),
    "capped": dict(random_effect_id="userId", feature_shard_id="per_user",
                   active_upper_bound=9, passive_lower_bound=2),
    "identity-sharded": dict(random_effect_id="userId", feature_shard_id="global",
                             projector="IDENTITY", num_shards=3),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_random_effect_dataset_is_byte_equal(glmix, name):
    jdata, tdata = glmix
    want = j_build(jdata, JReConfig(**CONFIGS[name]))
    got = tgame.build_random_effect_dataset(tdata, tgame.RandomEffectDataConfig(**CONFIGS[name]),
                                            device="cpu")
    assert (got.num_entities, got.global_dim) == (want.num_entities, want.global_dim)
    for field in tgame.RandomEffectDataset.TENSOR_FIELDS:
        g, e = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert g.dtype == e.dtype and g.shape == e.shape, field
        assert g.tobytes() == e.tobytes(), field


def test_random_effect_dataset_refuses_unported_projections(glmix):
    """Pearson feature selection is still refused; the RANDOM projection is
    ported (held against the JAX build in tests/test_torch_projectors.py)."""
    _, tdata = glmix
    cfg = tgame.RandomEffectDataConfig("userId", "per_user", features_to_samples_ratio=0.5)
    with pytest.raises(ValueError, match="not yet ported"):
        tgame.build_random_effect_dataset(tdata, cfg, device="cpu")
    cfg = tgame.RandomEffectDataConfig("userId", "per_user", projector="RANDOM",
                                       random_projection_dim=2)
    ds = tgame.build_random_effect_dataset(tdata, cfg, device="cpu")
    assert ds.projection_matrix is not None and ds.local_dim == 3


@pytest.mark.parametrize("spec", ["off", "pallas", "scatter"])
@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_random_effect_update_and_score_match_jax(glmix, optimizer, spec):
    jdata, tdata = glmix
    cfg = JReConfig("userId", "per_user")
    jds = j_build(jdata, cfg)
    tds = tgame.build_random_effect_dataset(tdata, tgame.RandomEffectDataConfig("userId", "per_user"),
                                            device="cpu")
    jcfg = JConfig(max_iterations=40, tolerance=TOL)
    reg = JReg.l2(0.3)
    jc = JRandom(jds, JTask.LOGISTIC_REGRESSION, JOpt(optimizer), jcfg, reg, sparse_kernel="off")
    tc = RandomEffectCoordinate(tds, TaskType.LOGISTIC_REGRESSION, OptimizerType(optimizer),
                                interop.from_jax_numpy(jcfg, "cpu"),
                                interop.from_jax_numpy(reg, "cpu"), sparse_kernel=spec)
    assert (tc.slab is None) == (spec == "off")
    if tc.slab is not None:
        assert tc.slab.kernel == spec
    resid = np.random.default_rng(2).normal(scale=0.3, size=jdata.num_rows).astype(np.float32)
    w_j, res_j = jc.update(jnp.asarray(resid), jc.initial_coefficients())
    w_t, res_t = tc.update(torch.from_numpy(resid), tc.initial_coefficients())
    assert tuple(w_t.shape) == (tds.num_entities, tds.local_dim)
    assert_allclose(w_t.numpy(), np.asarray(w_j), kind="solver")
    assert_allclose(res_t.value.numpy(), np.asarray(res_j.value), kind="solver")
    assert res_t.reason.tolist() == np.asarray(res_j.reason).tolist()
    assert_allclose(tc.score(w_t).numpy(), np.asarray(jc.score(w_j)), kind="solver")
    assert_allclose(global_coefficients(tds, w_t).numpy(), np.asarray(j_global(jds, w_j)),
                    kind="solver")
    assert_allclose(tc.regularization_term(w_t).numpy(),
                    np.asarray(jc.regularization_term(w_j)), kind="solver")
    var_t = tc.coefficient_variances(w_t, torch.from_numpy(resid))
    var_j = jc.coefficient_variances(w_j, jnp.asarray(resid))
    assert_allclose(var_t.numpy(), np.asarray(var_j), kind="solver")


def test_random_effect_auto_spec_is_not_ported(glmix):
    _, tdata = glmix
    tds = tgame.build_random_effect_dataset(tdata, tgame.RandomEffectDataConfig("userId", "per_user"),
                                            device="cpu")
    with pytest.raises(ValueError, match="not yet ported"):
        RandomEffectCoordinate(tds, TaskType.LOGISTIC_REGRESSION, sparse_kernel="auto")


@pytest.mark.parametrize("spec", ["off", "pallas"])
@pytest.mark.parametrize("re_optimizer", ["LBFGS", "TRON"])
def test_coordinate_descent_matches_jax(glmix, monkeypatch, re_optimizer, spec):
    jdata, tdata = glmix
    monkeypatch.setenv("PHOTON_SPARSE_KERNEL", spec)
    vrng = np.random.default_rng(5)
    vdata, _ = make_glmix_data(vrng, num_users=8, rows_per_user_range=(3, 6), d_fixed=6, d_random=4)

    fe_cfg, re_cfg = JConfig(max_iterations=30, tolerance=1e-6), JConfig(max_iterations=30, tolerance=TOL)
    fe_reg, re_reg = JReg.l2(0.1), JReg.l2(0.5)
    loss = jlosses.logistic
    labels = jnp.asarray(jdata.response)

    j_coords = {
        "fixed": JFixed(j_fe_batch(jdata, "global", dense=True),
                        JProblem(JTask.LOGISTIC_REGRESSION, JOpt.LBFGS, fe_cfg, fe_reg)),
        "per-user": JRandom(j_build(jdata, JReConfig("userId", "per_user")),
                            JTask.LOGISTIC_REGRESSION, JOpt(re_optimizer), re_cfg, re_reg,
                            sparse_kernel="off"),
    }
    j_val_fe = j_fe_batch(vdata, "global", dense=True).features
    j_scorer = lambda p: j_val_fe.matvec(p["fixed"])
    j_evals = {"AUC": (j_evaluator(JEvType.AUC), {"labels": jnp.asarray(vdata.response)})}
    want = JCD(j_coords, lambda s: jnp.sum(loss.loss(s, labels)), j_scorer, j_evals).run(
        num_iterations=2, num_rows=jdata.num_rows)

    t_coords = {
        "fixed": FixedEffectCoordinate(
            tgame.build_fixed_effect_batch(tdata, "global", device="cpu"),
            GLMOptimizationProblem(TaskType.LOGISTIC_REGRESSION, OptimizerType.LBFGS,
                                   interop.from_jax_numpy(fe_cfg, "cpu"),
                                   interop.from_jax_numpy(fe_reg, "cpu"))),
        "per-user": RandomEffectCoordinate(
            tgame.build_random_effect_dataset(
                tdata, tgame.RandomEffectDataConfig("userId", "per_user"), device="cpu"),
            TaskType.LOGISTIC_REGRESSION, OptimizerType(re_optimizer),
            interop.from_jax_numpy(re_cfg, "cpu"), interop.from_jax_numpy(re_reg, "cpu")),
    }
    assert (t_coords["per-user"].slab is not None) == (spec == "pallas")
    t_val_fe = tgame.build_fixed_effect_batch(_port_data(vdata), "global", device="cpu").features
    t_labels = torch.from_numpy(jdata.response)
    t_evals = {"AUC": (evaluator_for(EvaluatorType.AUC),
                       {"labels": torch.from_numpy(vdata.response)})}
    got = CoordinateDescent(t_coords, lambda s: torch.sum(tlosses.logistic.loss(s, t_labels)),
                            lambda p: t_val_fe.matvec(p["fixed"]), t_evals).run(
        num_iterations=2, num_rows=tdata.num_rows)

    assert len(got.objective_history) == len(want.objective_history) == 4
    assert_allclose(got.objective_history, want.objective_history, kind="solver", dtype=np.float32)
    assert_allclose(got.total_scores.numpy(), np.asarray(want.total_scores), kind="solver")
    assert_allclose([m["AUC"] for m in got.validation_history],
                    [m["AUC"] for m in want.validation_history], kind="solver", dtype=np.float32)
    for name in ("fixed", "per-user"):
        assert_allclose(got.coefficients[name].numpy(), np.asarray(want.coefficients[name]),
                        kind="solver")
    assert set(got.trackers) == {"fixed", "per-user"}
    assert tuple(got.trackers["per-user"].reason.shape) == (8,)


def test_slab_of_a_dataset_runs_the_kernel_spec_from_the_environment(glmix, monkeypatch):
    _, tdata = glmix
    tds = tgame.build_random_effect_dataset(tdata, tgame.RandomEffectDataConfig("userId", "per_user"),
                                            device="cpu")
    monkeypatch.setenv("PHOTON_SPARSE_KERNEL", "pallas:128")
    coord = RandomEffectCoordinate(tds, TaskType.LOGISTIC_REGRESSION)
    assert coord.slab.kernel == "pallas:128"
    assert torch.equal(coord.slab.to_dense(), tds.x)
    monkeypatch.setenv("PHOTON_SPARSE_KERNEL", "off")
    assert RandomEffectCoordinate(tds, TaskType.LOGISTIC_REGRESSION).slab is None
    assert dataclasses.replace(coord, sparse_kernel="segment").slab.kernel == "segment"
    assert isinstance(coord.slab, tfs.SparseSlab)
