"""LBFGS / OWL-QN in the port against the JAX package: the same batch and
start point through ``GLMOptimizationProblem.run`` of both packages (CPU).

Coefficients and objective at the ``solver`` tolerance of tests/tolerances.py
(f32 ulp noise compounds over iterations); the convergence reason equal and
the iteration count within 2; under L1 the exact zeros in the same
coordinates (the OWL-QN orthant machinery).
"""

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
from photon_ml_tpu.types import NormalizationType as JNormType
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import interop
from photon_ml_tpu_torch.ops.features import DenseFeatures as TDense
from photon_ml_tpu_torch.ops.objective import GLMBatch as TBatch
from photon_ml_tpu_torch.optim import lbfgs
from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem as TProblem
from photon_ml_tpu_torch.types import ConvergenceReason, TaskType
from tolerances import assert_allclose

TASKS = ["LOGISTIC_REGRESSION", "LINEAR_REGRESSION", "POISSON_REGRESSION",
         "SMOOTHED_HINGE_LOSS_LINEAR_SVM"]
REGS = {
    "L2": JReg.l2(1.0),
    "L1": JReg.l1(25.0),
    "ELASTIC_NET": JReg.elastic_net(25.0, 0.6),
}


def _data(task, seed=11, n=400, d=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:, -1] = 1.0
    w_true = rng.normal(size=d).astype(np.float32)
    w_true[: d // 2] = 0.0  # irrelevant features: L1 should zero them
    z = 0.5 * (x @ w_true)
    if task == "LINEAR_REGRESSION":
        y = (z + rng.normal(size=n)).astype(np.float32)
    elif task == "POISSON_REGRESSION":
        y = rng.poisson(np.exp(0.3 * z)).astype(np.float32)
    else:
        y = (rng.random(n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    off = rng.normal(scale=0.1, size=n).astype(np.float32)
    wt = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    wt[-5:] = 0.0  # padding rows
    jb = JBatch(JDense(jnp.asarray(x)), jnp.asarray(y), jnp.asarray(off), jnp.asarray(wt))
    t = torch.from_numpy
    tb = TBatch(TDense(t(x)), t(y), t(off), t(wt))
    return x, jb, tb


@pytest.mark.parametrize("reg_name", sorted(REGS))
@pytest.mark.parametrize("task", TASKS)
def test_problem_run_matches_jax(task, reg_name):
    x, jb, tb = _data(task)
    reg = REGS[reg_name]
    w0 = np.full(x.shape[1], 0.01, np.float32)  # the same non-zero start point
    jnorm = JNorm.build(JNormType.STANDARDIZATION, mean=jnp.asarray(x.mean(0)),
                        std=jnp.asarray(x.std(0)), intercept_id=x.shape[1] - 1)
    jp = JProblem(JTask(task), optimizer_config=JConfig(max_iterations=60, tolerance=1e-6),
                  regularization=reg, compute_variance=True)
    tp = TProblem(TaskType(task), optimizer_config=interop.from_jax_numpy(jp.optimizer_config, "cpu"),
                  regularization=interop.from_jax_numpy(reg, "cpu"), compute_variance=True)
    jm, jr = jp.run(jb, jnorm, init_coefficients=jnp.asarray(w0))
    tm, tr = tp.run(tb, interop.from_jax_numpy(jnorm, "cpu"), init_coefficients=torch.from_numpy(w0))

    jw = np.asarray(jm.coefficients.means)
    tw = tm.coefficients.means.numpy()
    assert_allclose(tw, jw, kind="solver")
    assert_allclose(tr.value.numpy(), np.asarray(jr.value), kind="solver")
    assert_allclose(tm.coefficients.variances.numpy(), np.asarray(jm.coefficients.variances),
                    kind="solver")
    assert int(tr.reason) == int(jr.reason)
    assert abs(int(tr.iterations) - int(jr.iterations)) <= 2
    hist = tr.value_history.numpy()
    assert hist.shape == (61,)
    assert np.isfinite(hist[: int(tr.iterations) + 1]).all()
    assert np.isnan(hist[int(tr.iterations) + 1:]).all()
    if reg.l1_weight > 0:
        assert (jw == 0).sum() >= 3, "the fixture should produce exact zeros"
        np.testing.assert_array_equal(tw == 0, jw == 0)


def test_lanes_are_independent_and_track_coefficients():
    """Two lanes with different problems advance independently: each equals
    its own one-lane solve, including the per-iteration snapshots."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(6, 6)).astype(np.float32))
    h = [a @ a.T + torch.eye(6), 3.0 * torch.eye(6)]
    b = [torch.ones(6), torch.arange(6.0)]

    def quad(i):
        return lambda w: (0.5 * w @ h[i] @ w - b[i] @ w, h[i] @ w - b[i])

    def lanes(w):
        vals, grads = zip(*(quad(i)(w[i]) for i in range(2)))
        return torch.stack(vals), torch.stack(grads)

    cfg = interop.from_jax_numpy(JConfig(max_iterations=30, tolerance=1e-7), "cpu")
    both = lbfgs.lbfgs_minimize_lanes(lanes, torch.zeros((2, 6)), cfg, track_coefficients=True)
    for i in range(2):
        one = lbfgs.lbfgs_minimize(quad(i), torch.zeros(6), cfg, track_coefficients=True)
        assert int(both.iterations[i]) == int(one.iterations)
        torch.testing.assert_close(both.coefficients[i], one.coefficients)
        torch.testing.assert_close(both.coefficient_history[i], one.coefficient_history,
                                   equal_nan=True)
        assert int(one.reason) != ConvergenceReason.NOT_CONVERGED
        torch.testing.assert_close(one.coefficients, torch.linalg.solve(h[i], b[i]),
                                   rtol=1e-4, atol=1e-4)
