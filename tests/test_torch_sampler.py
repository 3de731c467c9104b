"""The port's down-samplers against the JAX package (CPU): the binary and
the uniform sampler give bit-equal weights for several seeds, rates and
weightings (the uniform draws are ``jax.random.uniform``'s, reproduced in
``utils/prng.py``), and a down-sampled fixed-effect solve matches the JAX
coordinate's at the ``solver`` tolerance of tests/tolerances.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from game_test_utils import make_glmix_data
from photon_ml_tpu.algorithm.fixed_effect import FixedEffectCoordinate as JFixed
from photon_ml_tpu.data import sampler as jsampler
from photon_ml_tpu.data.game import build_fixed_effect_batch as j_fe_batch
from photon_ml_tpu.ops.features import DenseFeatures as JDense
from photon_ml_tpu.ops.objective import GLMBatch as JBatch
from photon_ml_tpu.ops.regularization import RegularizationContext as JReg
from photon_ml_tpu.optim.common import OptimizerConfig as JConfig
from photon_ml_tpu.optim.problem import GLMOptimizationProblem as JProblem
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import interop
from photon_ml_tpu_torch.algorithm import fixed_effect
from photon_ml_tpu_torch.algorithm.fixed_effect import FixedEffectCoordinate
from photon_ml_tpu_torch.data import game as tgame
from photon_ml_tpu_torch.data import sampler as tsampler
from photon_ml_tpu_torch.ops.features import DenseFeatures
from photon_ml_tpu_torch.ops.objective import GLMBatch
from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.types import OptimizerType, TaskType
from photon_ml_tpu_torch.utils import prng
from tolerances import assert_allclose


def _batches(n, seed, weighted):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    y = (rng.random(n) < 0.3).astype(np.float32)
    w = (rng.uniform(0.25, 4.0, n) if weighted else np.ones(n)).astype(np.float32)
    off = np.zeros(n, np.float32)
    jb = JBatch(JDense(jnp.asarray(x)), jnp.asarray(y), jnp.asarray(off), jnp.asarray(w))
    tb = GLMBatch(DenseFeatures(torch.from_numpy(x)), torch.from_numpy(y),
                  torch.from_numpy(off), torch.from_numpy(w))
    return jb, tb


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("rate", [0.05, 0.3, 0.5, 0.7, 0.999])
@pytest.mark.parametrize("seed", [0, 7, 20261017])
@pytest.mark.parametrize("kind", ["binary", "default"])
def test_sampled_weights_are_bit_equal_to_jax(kind, seed, rate, weighted):
    jb, tb = _batches(1003, seed + 1, weighted)
    jfn = getattr(jsampler, f"down_sample_{kind}")
    tfn = getattr(tsampler, f"down_sample_{kind}")
    want = np.asarray(jfn(jb, rate, jax.random.PRNGKey(seed)).weights)
    got = tfn(tb, rate, prng.prng_key(seed)).weights.numpy()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    kept = got > 0
    assert 0 < kept.sum() <= len(got)
    if kind == "binary":
        assert np.all(kept[tb.labels.numpy() > 0.5])


@pytest.mark.parametrize("task", ["LOGISTIC_REGRESSION", "LINEAR_REGRESSION", "POISSON_REGRESSION"])
def test_maybe_down_sample_dispatches_like_jax(task):
    jb, tb = _batches(517, 3, True)
    want = np.asarray(jsampler.maybe_down_sample(jb, JTask(task), 0.4, 7).weights)
    got = tsampler.maybe_down_sample(tb, TaskType(task), 0.4, 7).weights.numpy()
    assert got.tobytes() == want.tobytes()
    for rate in (None, 1.0):
        assert tsampler.maybe_down_sample(tb, TaskType(task), rate, 7) is tb


@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_down_sampled_fixed_effect_solve_matches_jax(optimizer):
    data, _ = make_glmix_data(np.random.default_rng(5), num_users=30,
                              rows_per_user_range=(8, 20), d_fixed=6, d_random=2)
    port = tgame.GameData(
        response=data.response, offset=data.offset, weight=data.weight,
        ids=dict(data.ids), id_vocabs=dict(data.id_vocabs),
        shards={k: tgame.HostFeatures(f.indptr, f.indices, f.values, f.dim)
                for k, f in data.shards.items()},
    )
    cfg, reg = JConfig(max_iterations=40, tolerance=1e-7), JReg.l2(0.5)
    jc = JFixed(j_fe_batch(data, "global", dense=True),
                JProblem(JTask.LOGISTIC_REGRESSION, JOpt(optimizer), cfg, reg),
                down_sampling_rate=0.4)
    tc = FixedEffectCoordinate(
        tgame.build_fixed_effect_batch(port, "global", device="cpu"),
        GLMOptimizationProblem(TaskType.LOGISTIC_REGRESSION, OptimizerType(optimizer),
                               interop.from_jax_numpy(cfg, "cpu"),
                               interop.from_jax_numpy(reg, "cpu")),
        down_sampling_rate=0.4)
    assert fixed_effect.DOWN_SAMPLING_SEED == jc.seed == 7
    resid = np.random.default_rng(6).normal(scale=0.2, size=data.num_rows).astype(np.float32)
    w_j, res_j = jc.update(jnp.asarray(resid), jc.initial_coefficients())
    w_t, res_t = tc.update(torch.from_numpy(resid), tc.initial_coefficients())
    assert_allclose(w_t.numpy(), np.asarray(w_j), kind="solver")
    assert_allclose(float(res_t.value), float(res_j.value), kind="solver", dtype=np.float32)
    # the sample moved the solve: the full-data solve lands elsewhere
    full = FixedEffectCoordinate(tc.batch, tc.problem)
    w_full, _ = full.update(torch.from_numpy(resid), full.initial_coefficients())
    assert not torch.allclose(w_full, w_t, rtol=1e-2, atol=1e-3)
    # the same key every update: a second update from the same start repeats
    w_again, _ = tc.update(torch.from_numpy(resid), tc.initial_coefficients())
    assert torch.equal(w_again, w_t)
