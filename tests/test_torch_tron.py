"""TRON in the port against the JAX package (CPU): lanes of per-entity
problems on dense stacks and on sparse slabs, through the random effect's
lane closures of both packages (the JAX ones vmapped), and one problem
through ``GLMOptimizationProblem.run``.

Coefficients and objective at the ``solver`` tolerance of tests/tolerances.py
(f32 ulp noise compounds over the CG and trust-region steps); the
convergence reasons equal and the iteration counts within 2, as in
tests/test_torch_lbfgs.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.algorithm.random_effect import entity_lane_fns as j_lane_fns
from photon_ml_tpu.ops import fused_sparse as jfs
from photon_ml_tpu.ops.features import DenseFeatures as JDense
from photon_ml_tpu.ops.normalization import NormalizationContext as JNorm
from photon_ml_tpu.ops.objective import GLMBatch as JBatch
from photon_ml_tpu.ops.regularization import RegularizationContext as JReg
from photon_ml_tpu.optim.common import OptimizerConfig as JConfig
from photon_ml_tpu.optim.problem import GLMOptimizationProblem as JProblem
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import interop
from photon_ml_tpu_torch.algorithm.random_effect import entity_lane_fns
from photon_ml_tpu_torch.ops import fused_sparse as tfs
from photon_ml_tpu_torch.ops import losses
from photon_ml_tpu_torch.ops.features import DenseFeatures
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMBatch, GLMObjective
from photon_ml_tpu_torch.optim import tron
from photon_ml_tpu_torch.optim.common import OptimizerConfig
from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.types import OptimizerType, TaskType
from tolerances import assert_allclose

TASKS = ["LOGISTIC_REGRESSION", "LINEAR_REGRESSION", "POISSON_REGRESSION"]
# TRON's default 1e-5 sits at the f32 noise floor of these small objectives,
# where which test stops a lane (function values, no improvement, gradient)
# is ulp noise; 1e-4 stops every lane on a decided step
TOL = 1e-4


def _lanes(task, seed=3, e=6, m=24, d=12):
    rng = np.random.default_rng(seed)
    x = np.where(rng.random((e, m, d)) < 0.3, rng.normal(size=(e, m, d)), 0.0).astype(np.float32)
    x[..., -1] = 1.0
    w_true = rng.normal(size=(e, d)).astype(np.float32)
    z = 0.5 * np.einsum("emd,ed->em", x, w_true)
    if task == "LINEAR_REGRESSION":
        y = (z + rng.normal(size=(e, m))).astype(np.float32)
    elif task == "POISSON_REGRESSION":
        y = rng.poisson(np.exp(0.3 * z)).astype(np.float32)
    else:
        y = (rng.random((e, m)) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    off = rng.normal(scale=0.1, size=(e, m)).astype(np.float32)
    wt = np.ones((e, m), np.float32)
    wt[:, -4:] = 0.0  # padding rows
    wt[0, 10:] = 0.0  # a lane with few rows
    return x, y, off, wt


def _compare(got, want):
    assert_allclose(got.coefficients.numpy(), np.asarray(want.coefficients), kind="solver")
    assert_allclose(got.value.numpy(), np.asarray(want.value), kind="solver")
    assert got.reason.tolist() == np.asarray(want.reason).tolist()
    # near convergence the last accepted steps hinge on ulp noise
    assert np.all(np.abs(got.iterations.numpy() - np.asarray(want.iterations)) <= 2)


@pytest.mark.parametrize("layout", ["dense", "slab-scatter", "slab-pallas"])
@pytest.mark.parametrize("task", TASKS)
def test_tron_lanes_match_vmapped_jax(task, layout):
    x, y, off, wt = _lanes(task)
    cfg = JConfig(max_iterations=15, tolerance=TOL)
    reg = JReg.l2(0.5)
    j_solve = j_lane_fns(JTask(task), JOpt.TRON, cfg, reg)[0]
    if layout == "dense":
        jfeats, tfeats = jnp.asarray(x), torch.from_numpy(x)
    else:
        jfeats = jfs.build_sparse_slab(x, bucketer="off", kernel="scatter")
        tfeats = tfs.build_sparse_slab(torch.from_numpy(x), kernel=layout.split("-")[1])
    w0 = np.zeros(x.shape[::2], np.float32)
    want = jax.vmap(j_solve)(jfeats, jnp.asarray(y), jnp.asarray(off), jnp.asarray(wt),
                             jnp.asarray(w0))
    solve = entity_lane_fns(TaskType(task), OptimizerType.TRON, interop.from_jax_numpy(cfg, "cpu"),
                            interop.from_jax_numpy(reg, "cpu"))[0]
    t = torch.from_numpy
    got = solve(tfeats, t(y), t(off), t(wt), t(w0))
    assert tuple(got.coefficients.shape) == w0.shape and tuple(got.reason.shape) == (6,)
    _compare(got, want)


def test_tron_resumes_exactly_from_a_paused_state():
    x, y, off, wt = _lanes("LOGISTIC_REGRESSION", seed=9)
    t = torch.from_numpy
    batch = GLMBatch(DenseFeatures(t(x)), t(y), t(off), t(wt))
    obj = GLMObjective(losses.for_task(TaskType.LOGISTIC_REGRESSION))
    norm, cfg = NormalizationContext.identity(), OptimizerConfig.tron_default()
    vg = lambda w: obj.value_and_grad(w, batch, norm, 0.5)
    hvp = lambda w, v: obj.hessian_vector(w, v, batch, norm, 0.5)
    w0 = torch.zeros((6, 12))
    once = tron.tron_minimize_lanes(vg, hvp, w0, cfg)
    state = tron.tron_advance_(vg, hvp, tron.tron_init_(vg, w0, cfg), cfg, iteration_limit=3)
    assert int(state.iteration.max()) <= 3
    resumed = tron.tron_result(tron.tron_advance_(vg, hvp, state, cfg, iteration_limit=None))
    for a, b in zip(once, resumed):
        if a is not None:  # bitwise, NaN history padding included
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("task", TASKS)
def test_tron_problem_run_matches_jax(task):
    x, y, off, wt = _lanes(task, seed=5, e=1, m=300, d=10)
    x, y, off, wt = x[0], y[0], off[0], wt[0]
    jb = JBatch(JDense(jnp.asarray(x)), jnp.asarray(y), jnp.asarray(off), jnp.asarray(wt))
    _, want = JProblem(JTask(task), JOpt.TRON, JConfig(max_iterations=15, tolerance=TOL),
                       JReg.l2(1.0)).run(jb, JNorm.identity())
    t = torch.from_numpy
    tb = GLMBatch(DenseFeatures(t(x)), t(y), t(off), t(wt))
    _, got = GLMOptimizationProblem(TaskType(task), OptimizerType.TRON,
                                    OptimizerConfig(max_iterations=15, tolerance=TOL),
                                    RegularizationContext.l2(1.0)).run(
        tb, NormalizationContext.identity())
    assert got.coefficients.shape == (10,)
    _compare(got, want)
    # the single-problem entry point runs the same lane of one
    obj = GLMOptimizationProblem(TaskType(task)).objective
    norm = NormalizationContext.identity()
    direct = tron.tron_minimize_(lambda w: obj.value_and_grad(w, tb, norm, 1.0),
                                 lambda w, v: obj.hessian_vector(w, v, tb, norm, 1.0),
                                 torch.zeros(10), OptimizerConfig(max_iterations=15, tolerance=TOL))
    for a, b in zip(direct, got):
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_tron_refuses_what_the_jax_package_refuses():
    with pytest.raises(ValueError, match="twice-differentiable"):
        GLMOptimizationProblem(TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM, OptimizerType.TRON)
    for reg in (RegularizationContext.l1(1.0), RegularizationContext.elastic_net(1.0, 0.5)):
        with pytest.raises(ValueError, match="L1/ELASTIC_NET"):
            GLMOptimizationProblem(TaskType.LOGISTIC_REGRESSION, OptimizerType.TRON,
                                   regularization=reg)
