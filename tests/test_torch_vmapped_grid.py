"""The port's lambda-batched GLM grid (``training.train_glm_grid_vmapped``)
against the JAX package's on the same seeded inputs (CPU, ``solver``
tolerance of tests/tolerances.py), and against the port's own sequential
warm-started grid at tests/test_optimizers.py:279-346's tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops.features import DenseFeatures as JDense
from photon_ml_tpu.ops.normalization import NormalizationContext as JNorm
from photon_ml_tpu.ops.objective import GLMBatch as JBatch
from photon_ml_tpu.ops.regularization import RegularizationContext as JReg
from photon_ml_tpu.optim.common import OptimizerConfig as JConfig
from photon_ml_tpu.optim.problem import GLMOptimizationProblem as JProblem
from photon_ml_tpu.training import train_glm_grid_vmapped as j_vmapped
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import interop
from photon_ml_tpu_torch.ops.features import DenseFeatures, SparseFeatures
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMBatch
from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.training import train_glm_grid, train_glm_grid_vmapped
from photon_ml_tpu_torch.types import OptimizerType, TaskType
from tolerances import assert_allclose

CASES = {
    "logistic-lbfgs-l2": ("LOGISTIC_REGRESSION", "LBFGS", JReg.l2(1.0),
                          JConfig(max_iterations=80, tolerance=1e-10)),
    "logistic-owlqn-l1": ("LOGISTIC_REGRESSION", "LBFGS", JReg.l1(1.0),
                          JConfig(max_iterations=80, tolerance=1e-8)),
    "linear-tron-l2": ("LINEAR_REGRESSION", "TRON", JReg.l2(1.0),
                       JConfig(max_iterations=15, tolerance=1e-8)),
    "poisson-tron-l2": ("POISSON_REGRESSION", "TRON", JReg.l2(1.0),
                        JConfig(max_iterations=15, tolerance=1e-8)),
}
LAMS = [0.1, 1.0, 10.0]


def _data(task, n=300, d=7, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = (rng.normal(size=d) * 0.5).astype(np.float32)
    margin = x @ w
    if task == "LOGISTIC_REGRESSION":
        y = (1.0 / (1.0 + np.exp(-margin)) > rng.random(n)).astype(np.float32)
    elif task == "POISSON_REGRESSION":
        y = rng.poisson(np.exp(np.clip(margin, -3, 3))).astype(np.float32)
    else:
        y = (margin + rng.normal(size=n) * 0.1).astype(np.float32)
    return x, y


def _problems(case):
    task, opt, reg, cfg = CASES[case]
    conv = lambda v: interop.from_jax_numpy(v, "cpu")
    return (JProblem(JTask(task), JOpt(opt), cfg, reg),
            GLMOptimizationProblem(TaskType(task), OptimizerType(opt), conv(cfg), conv(reg)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_vmapped_grid_matches_the_jax_vmapped_grid(case):
    x, y = _data(CASES[case][0])
    jp, tp = _problems(case)
    want = j_vmapped(jp, JBatch.create(JDense(jnp.asarray(x)), jnp.asarray(y)),
                     JNorm.identity(), LAMS)
    got = train_glm_grid_vmapped(tp, GLMBatch.create(DenseFeatures(torch.from_numpy(x)),
                                                     torch.from_numpy(y)),
                                 NormalizationContext.identity(), LAMS)
    assert got.weights == want.weights == [10.0, 1.0, 0.1]
    for mt, mj, rt, rj in zip(got.models, want.models, got.results, want.results):
        assert_allclose(mt.coefficients.means.numpy(), np.asarray(mj.coefficients.means),
                        kind="solver")
        assert_allclose(rt.value.numpy(), np.asarray(rj.value), kind="solver")
        assert int(rt.iterations) > 0


@pytest.mark.parametrize("case", ["logistic-lbfgs-l2", "linear-tron-l2"])
def test_vmapped_grid_matches_the_sequential_grid(case):
    """Cold lanes against the warm-started chain: the same optima at the
    tolerance tests/test_optimizers.py holds the JAX pair to."""
    x, y = _data(CASES[case][0])
    _, tp = _problems(case)
    batch = GLMBatch.create(DenseFeatures(torch.from_numpy(x)), torch.from_numpy(y))
    norm = NormalizationContext.identity()
    seq = train_glm_grid(tp, batch, norm, LAMS)
    par = train_glm_grid_vmapped(tp, batch, norm, LAMS)
    assert par.weights == seq.weights == [10.0, 1.0, 0.1]
    for ms, mp in zip(seq.models, par.models):
        np.testing.assert_allclose(mp.coefficients.means.numpy(),
                                   ms.coefficients.means.numpy(), rtol=2e-3, atol=2e-4)


def test_vmapped_grid_with_tron_shrinks_the_heavier_lambda():
    """tests/test_optimizers.py's TRON case: the heavier lambda's lane has
    the smaller solution."""
    x, y = _data("LINEAR_REGRESSION", n=200, d=5, seed=1)
    _, tp = _problems("linear-tron-l2")
    par = train_glm_grid_vmapped(tp, GLMBatch.create(DenseFeatures(torch.from_numpy(x)),
                                                     torch.from_numpy(y)),
                                 NormalizationContext.identity(), [0.5, 5.0])
    assert par.weights == [5.0, 0.5]
    n_heavy, n_light = (float(torch.linalg.vector_norm(m.coefficients.means))
                        for m in par.models)
    assert n_heavy < n_light


def test_normalization_and_variances_follow_each_lane():
    """With a normalization context and --compute-variance, each lane is the
    single-lambda solve of that lambda (its own run, cold) and carries its
    own variances."""
    x, y = _data("LOGISTIC_REGRESSION", n=240, d=6, seed=9)
    _, tp = _problems("logistic-lbfgs-l2")
    import dataclasses

    tp = dataclasses.replace(tp, compute_variance=True)
    factors = torch.linspace(0.5, 2.0, 6)
    shifts = torch.linspace(-0.3, 0.3, 6)
    norm = NormalizationContext(factors=factors, shifts=shifts)
    batch = GLMBatch.create(DenseFeatures(torch.from_numpy(x)), torch.from_numpy(y))
    par = train_glm_grid_vmapped(tp, batch, norm, LAMS)
    for lam, model in zip(par.weights, par.models):
        alone, _ = tp.run(batch, norm, reg_weight=lam)
        assert_allclose(model.coefficients.means.numpy(), alone.coefficients.means.numpy(),
                        kind="solver")
        assert_allclose(model.coefficients.variances.numpy(),
                        alone.coefficients.variances.numpy(), kind="solver")


def test_sparse_features_evaluate_lane_by_lane():
    """A sparse batch has no one product: its lanes evaluate one by one
    and still match the dense batch's lanes."""
    x, y = _data("LOGISTIC_REGRESSION", n=200, d=6, seed=4)
    x[np.abs(x) < 0.7] = 0.0
    _, tp = _problems("logistic-lbfgs-l2")
    dense = train_glm_grid_vmapped(
        tp, GLMBatch.create(DenseFeatures(torch.from_numpy(x)), torch.from_numpy(y)),
        NormalizationContext.identity(), LAMS)
    k = int((x != 0).sum(1).max())
    idx = np.zeros((len(x), k), np.int32)
    val = np.zeros((len(x), k), np.float32)
    for r, row in enumerate(x):
        cols = np.nonzero(row)[0]
        idx[r, :len(cols)], val[r, :len(cols)] = cols, row[cols]
    feats = SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val), x.shape[1])
    sparse = train_glm_grid_vmapped(tp, GLMBatch.create(feats, torch.from_numpy(y)),
                                    NormalizationContext.identity(), LAMS)
    for a, b in zip(dense.models, sparse.models):
        assert_allclose(b.coefficients.means.numpy(), a.coefficients.means.numpy(),
                        kind="solver")
