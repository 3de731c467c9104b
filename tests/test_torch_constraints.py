"""Box constraints in the port against the JAX package (CPU): the constraint
strings of tests/test_constraints.py parse to the same map or raise the same
error in both, and bounded LBFGS, OWL-QN and TRON solves agree with the JAX
solves at the ``solver`` tolerance with every coefficient in its box, the
bounds broadcasting over a solver's lanes."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops.features import DenseFeatures as JDense
from photon_ml_tpu.ops.normalization import NormalizationContext as JNorm
from photon_ml_tpu.ops.objective import GLMBatch as JBatch
from photon_ml_tpu.ops.regularization import RegularizationContext as JReg
from photon_ml_tpu.optim import constraints as jcons
from photon_ml_tpu.optim.common import OptimizerConfig as JConfig
from photon_ml_tpu.optim.problem import GLMOptimizationProblem as JProblem
from photon_ml_tpu.types import OptimizerType as JOpt, TaskType as JTask
from photon_ml_tpu_torch.ops.features import DenseFeatures
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMBatch
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optim import constraints as tcons
from photon_ml_tpu_torch.optim import lbfgs, tron
from photon_ml_tpu_torch.optim.common import OptimizerConfig
from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.types import OptimizerType, TaskType
from tolerances import assert_allclose


def _key(name, term=""):
    return name + jcons.DELIMITER + term


FEATURE_MAP = {_key("a", "1"): 0, _key("a", "2"): 1, _key("b", "1"): 2, _key("(INTERCEPT)"): 3}

# the strings of tests/test_constraints.py, plus the intercept-key default
STRINGS = {
    "exact": '[{"name": "a", "term": "1", "lowerBound": -0.5, "upperBound": 0.5}]',
    "one_bound": '[{"name": "b", "term": "1", "lowerBound": 0.0}]',
    "term_wildcard": '[{"name": "a", "term": "*", "upperBound": 1.0}]',
    "full_wildcard": '[{"name": "*", "term": "*", "lowerBound": -1.0, "upperBound": 1.0}]',
    "wildcard_not_alone": '[{"name": "a", "term": "1", "lowerBound": 0.0},'
                          ' {"name": "*", "term": "*", "lowerBound": -1.0}]',
    "name_wildcard_alone": '[{"name": "*", "term": "1", "lowerBound": 0}]',
    "both_infinite": '[{"name": "a", "term": "1"}]',
    "inverted": '[{"name": "a", "term": "1", "lowerBound": 1.0, "upperBound": -1.0}]',
    "duplicate": '[{"name": "a", "term": "1", "upperBound": 1.0},'
                 ' {"name": "a", "term": "*", "upperBound": 2.0}]',
    "unknown": '[{"name": "zzz", "term": "9", "upperBound": 1.0}]',
    "not_a_list": '{"name": "a", "term": "1", "upperBound": 1.0}',
    "no_term": '[{"name": "a", "upperBound": 1.0}]',
}


def _outcome(parse, text, **kw):
    try:
        return "ok", parse(text, FEATURE_MAP, **kw)
    except ValueError as e:
        return "error", str(e)


@pytest.mark.parametrize("intercept_key", [None, _key("(INTERCEPT)")], ids=["default", "named"])
@pytest.mark.parametrize("case", sorted(STRINGS))
def test_parse_matches_the_jax_package(case, intercept_key):
    kw = {} if intercept_key is None else {"intercept_key": intercept_key}
    assert _outcome(tcons.parse_constraint_string, STRINGS[case], **kw) == \
        _outcome(jcons.parse_constraint_string, STRINGS[case], **kw)
    assert tcons.INTERCEPT_KEY == jcons.INTERCEPT_KEY


def test_from_map_and_project_match():
    cmap = {0: (-0.5, 0.5), 2: (0.0, 2.0)}
    w = np.asarray([3.0, 3.0, -1.0, -7.0], np.float32)
    got = tcons.BoxConstraints.from_map(4, cmap).project(torch.from_numpy(w))
    want = jcons.BoxConstraints.from_map(4, cmap).project(jnp.asarray(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _data(seed, n=300, d=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d).astype(np.float32) * 2.0
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-(x @ w)))).astype(np.float32)
    wt = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    return x, y, wt


BOX = ((-0.4, 0.4), (-np.inf, 0.3), (-0.2, np.inf), (-1.0, 1.0))


def _bounds(d):
    lower = np.full(d, -np.inf, np.float32)
    upper = np.full(d, np.inf, np.float32)
    for j, (lo, hi) in enumerate(BOX * (d // len(BOX))):
        lower[j], upper[j] = lo, hi
    return lower, upper


@pytest.mark.parametrize("optimizer,reg", [
    ("LBFGS", "L2"), ("OWLQN", "L1"), ("OWLQN", "ELASTIC_NET"), ("TRON", "L2")])
def test_bounded_solve_matches_the_jax_package(optimizer, reg):
    x, y, wt = _data(3)
    d = x.shape[1]
    lower, upper = _bounds(d)
    opt = "TRON" if optimizer == "TRON" else "LBFGS"
    cfg = dict(max_iterations=100, tolerance=1e-6)
    make_reg = {"L2": "l2", "L1": "l1"}
    jreg = (JReg.elastic_net(0.5, 0.5) if reg == "ELASTIC_NET"
            else getattr(JReg, make_reg[reg])(0.5))
    treg = (RegularizationContext.elastic_net(0.5, 0.5) if reg == "ELASTIC_NET"
            else getattr(RegularizationContext, make_reg[reg])(0.5))
    jprob = JProblem(JTask.LOGISTIC_REGRESSION, JOpt(opt), JConfig(**cfg), jreg,
                     constraints=jcons.BoxConstraints(jnp.asarray(lower), jnp.asarray(upper)))
    tprob = GLMOptimizationProblem(
        TaskType.LOGISTIC_REGRESSION, OptimizerType(opt), OptimizerConfig(**cfg), treg,
        constraints=tcons.BoxConstraints(torch.from_numpy(lower), torch.from_numpy(upper)))
    jmodel, jres = jprob.run(JBatch(JDense(jnp.asarray(x)), jnp.asarray(y), jnp.zeros(len(y)),
                                    jnp.asarray(wt)), JNorm.identity())
    tbatch = GLMBatch(DenseFeatures(torch.from_numpy(x)), torch.from_numpy(y),
                      torch.zeros(len(y)), torch.from_numpy(wt))
    tmodel, tres = tprob.run(tbatch, NormalizationContext.identity())
    w = tmodel.means_as_numpy()
    assert np.all(w >= lower) and np.all(w <= upper)
    free = dataclasses.replace(tprob, constraints=None).run(tbatch, NormalizationContext.identity())
    w_free = free[0].means_as_numpy()
    assert not (np.all(w_free >= lower) and np.all(w_free <= upper)), "the box binds nothing"
    assert_allclose(w, np.asarray(jmodel.coefficients.means), kind="solver")
    assert_allclose(float(tres.value), float(jres.value), kind="solver", dtype=np.float32)
    assert int(tres.reason) == int(jres.reason)


def _blocked_problem(lanes):
    """A bound blocks each lane's dominant descent direction: w0 <= 0, and
    w1 free with its optimum at 1 (test_constraints.py's case), scaled per
    lane."""
    scale = torch.arange(1, lanes + 1, dtype=torch.float32)[:, None]

    def vg(w):
        f = (w[:, 0] - 3.0) ** 2 + 0.5 * (w[:, 1] - 1.0) ** 2
        g = torch.stack([2.0 * (w[:, 0] - 3.0), w[:, 1] - 1.0], -1)
        return f * scale[:, 0], g * scale

    def hvp(w, v):
        return torch.stack([2.0 * v[:, 0], v[:, 1]], -1) * scale

    bounds = (torch.tensor([-np.inf, -np.inf]), torch.tensor([0.0, np.inf]))
    return vg, hvp, bounds


@pytest.mark.parametrize("solver", ["LBFGS", "TRON"])
def test_bound_blocked_direction_converges_on_every_lane(solver):
    vg, hvp, bounds = _blocked_problem(3)
    w0 = torch.zeros((3, 2))
    cfg = OptimizerConfig(max_iterations=100 if solver == "LBFGS" else 50, tolerance=1e-9)
    if solver == "LBFGS":
        res = lbfgs.lbfgs_minimize_lanes(vg, w0, cfg, bounds=bounds)
    else:
        res = tron.tron_minimize_lanes(vg, hvp, w0, cfg, bounds=bounds)
    np.testing.assert_allclose(res.coefficients.numpy(), np.tile([0.0, 1.0], (3, 1)), atol=1e-3)
    # a lane of the batch is the lane solved alone
    one_vg = lambda w: tuple(t[:1] for t in vg(torch.cat([w, w, w])))
    if solver == "LBFGS":
        alone = lbfgs.lbfgs_minimize_lanes(one_vg, w0[:1], cfg, bounds=bounds)
    else:
        alone = tron.tron_minimize_lanes(one_vg, lambda w, v: hvp(torch.cat([w] * 3),
                                                                   torch.cat([v] * 3))[:1],
                                         w0[:1], cfg, bounds=bounds)
    torch.testing.assert_close(alone.coefficients[0], res.coefficients[0], rtol=0, atol=0)


def test_w0_outside_the_box_is_clipped_first():
    vg, hvp, bounds = _blocked_problem(1)
    w0 = torch.tensor([[5.0, 0.0]])
    cfg = OptimizerConfig(max_iterations=1, tolerance=1e-9)
    for res in (lbfgs.lbfgs_minimize_lanes(vg, w0, cfg, bounds=bounds),
                tron.tron_minimize_lanes(vg, hvp, w0, cfg, bounds=bounds)):
        assert float(res.coefficients[0, 0]) <= 0.0
        assert float(res.value_history[0, 0]) == pytest.approx(float(vg(torch.tensor([[0.0, 0.0]]))[0]))
