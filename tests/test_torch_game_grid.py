"""The port's lambda grid against the JAX package (CPU): the grid grammar
(``config_grid``, ``parse_factored_config_map``), ``CoordinateDescent.
run_grid`` against the JAX ``run_grid`` (objective histories, coefficients
and the best combo at the ``solver`` tolerance of tests/tolerances.py), the
port's grid bit for bit against its own per-combo ``run()``, and per-cycle
grid checkpoints: a stop at every iteration boundary resumes bitwise, and
the leaves and structure equal the JAX grid checkpointer's.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from game_test_utils import make_glmix_data
from photon_ml_tpu import checkpoint as jckpt
from photon_ml_tpu.algorithm.coordinate_descent import CoordinateDescent as JCD
from photon_ml_tpu.algorithm.fixed_effect import FixedEffectCoordinate as JFixed
from photon_ml_tpu.algorithm.random_effect import RandomEffectCoordinate as JRandom
from photon_ml_tpu.cli import game_params as jparams
from photon_ml_tpu.data.game import RandomEffectDataConfig as JReConfig
from photon_ml_tpu.data.game import build_fixed_effect_batch as j_fe_batch
from photon_ml_tpu.data.game import build_random_effect_dataset as j_build
from photon_ml_tpu.ops import losses as jlosses
from photon_ml_tpu.ops.regularization import RegularizationContext as JReg
from photon_ml_tpu.optim.common import OptimizerConfig as JConfig
from photon_ml_tpu.optim.problem import GLMOptimizationProblem as JProblem
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import checkpoint as tckpt
from photon_ml_tpu_torch import interop
from photon_ml_tpu_torch.algorithm.coordinate_descent import CoordinateDescent
from photon_ml_tpu_torch.algorithm.factored_random_effect import (
    FactoredRandomEffectCoordinate,
    MFOptimizationConfig,
)
from photon_ml_tpu_torch.algorithm.fixed_effect import FixedEffectCoordinate
from photon_ml_tpu_torch.algorithm.random_effect import RandomEffectCoordinate
from photon_ml_tpu_torch.cli import game_params as tparams
from photon_ml_tpu_torch.data import game as tgame
from photon_ml_tpu_torch.ops import losses as tlosses
from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.resilience import preemption
from photon_ml_tpu_torch.resilience.guards import DivergenceGuard
from photon_ml_tpu_torch.types import OptimizerType, TaskType
from tolerances import assert_allclose

FE_CFG, RE_CFG = JConfig(max_iterations=25, tolerance=1e-9), JConfig(max_iterations=30, tolerance=1e-8)
FE_LAMBDAS, RE_LAMBDAS = [0.01, 1.0, 10.0], [0.1, 0.1, 0.5]
ITERS = 2


@pytest.fixture(autouse=True)
def _clean_preemption_state():
    preemption.reset()
    yield
    preemption.reset()


@pytest.fixture(scope="module")
def glmix():
    data, _ = make_glmix_data(np.random.default_rng(20261017), num_users=10,
                              rows_per_user_range=(4, 16), d_fixed=4, d_random=3)
    port = tgame.GameData(
        response=data.response, offset=data.offset, weight=data.weight,
        ids=dict(data.ids), id_vocabs=dict(data.id_vocabs),
        shards={k: tgame.HostFeatures(f.indptr, f.indices, f.values, f.dim)
                for k, f in data.shards.items()},
    )
    return data, port


# --- the grammar -------------------------------------------------------------

GRIDS = [
    ("fixed:50,1e-7,0.01,1,LBFGS,L2", "per-user:40,1e-6,0.1,1,LBFGS,L2"),
    ("fixed:50,1e-7,0.01,1,LBFGS,L2;fixed:50,1e-7,1,1,LBFGS,L2;fixed:50,1e-7,10,0.5,TRON,L2",
     "per-user:40,1e-6,0.1,1,LBFGS,L2;per-user:40,1e-6,1,1,LBFGS,L1"),
    ("fixed:50,1e-7,0.01,1,LBFGS,L2|other:20,1e-5,0,1,TRON,NONE;", None),
    (None, "a:1,1e-3,2,1,LBFGS,ELASTIC_NET;;b:3,1e-4,0.5,0.25,LBFGS,L1"),
    ("fixed:50,1e-7,0.01,0,LBFGS,L2", None),  # rate 0 raises
    ("fixed:50,1e-7,0.01,1,LBFGS", None),  # five parts raise
    ("fixed:50,1e-7,0.01,1,NEWTON,L2", None),  # unknown optimizer raises
]


def _outcome(fn):
    try:
        return "ok", fn()
    except (ValueError, KeyError) as e:
        return "raises", type(e).__name__


def _combos(params):
    return [{k: (v.optimizer.value, v.max_iterations, v.tolerance, v.reg_weight,
                 v.reg_type.value, v.down_sampling_rate) for k, v in c.items()}
            for c in params.config_grid()]


@pytest.mark.parametrize("fe,re", GRIDS, ids=[str(i) for i in range(len(GRIDS))])
def test_config_grid_equals_the_jax_grid(fe, re):
    def grid(mod):
        return lambda: _combos(mod.GameTrainingParams(
            train_input_dirs=["t"], output_dir="o", updating_sequence=["fixed"],
            fixed_effect_data_configs={"fixed": mod.FixedEffectDataSpec("global", 1)},
            fixed_effect_opt_grid=mod.parse_coordinate_config_grid(fe),
            random_effect_opt_grid=mod.parse_coordinate_config_grid(re)))

    got, want = _outcome(grid(tparams)), _outcome(grid(jparams))
    assert got == want
    if got[0] == "ok":
        assert len(got[1]) == (len(tparams.parse_coordinate_config_grid(fe))
                               * len(tparams.parse_coordinate_config_grid(re)))


FACTORED = [
    "per-user:10,1e-5,1,1,LBFGS,L2:10,1e-5,1,1,LBFGS,L2:2,2",
    "a:20,1e-6,0.1,1,TRON,L2:15,1e-5,0.5,1,TRON,L2:3,4|b:5,1e-3,0,1,LBFGS,NONE:5,1e-3,2,1,LBFGS,L1:1,8",
    "",
    None,
    "per-user:10,1e-5,1,1,LBFGS,L2:10,1e-5,1,1,LBFGS,L2:2",  # mfIters without latentDim
    "per-user:10,1e-5,1,1,LBFGS,L2:10,1e-5,1,1,LBFGS,L2",  # no MF part
    "per-user:10,1e-5,1,1,LBFGS,L2:10,1e-5,1,1,LBFGS,L2:x,2",  # not an int
    "per-user:10,1e-5,1,1,LBFGS:10,1e-5,1,1,LBFGS,L2:2,2",  # five parts
]


def _factored(mod, s):
    return {k: (v.random_effect.optimizer.value, v.random_effect.reg_weight,
                v.latent_factor.optimizer.value, v.latent_factor.reg_type.value,
                v.mf_num_iterations, v.latent_dim)
            for k, v in mod.parse_factored_config_map(s).items()}


@pytest.mark.parametrize("s", FACTORED, ids=[str(i) for i in range(len(FACTORED))])
def test_factored_config_map_equals_the_jax_parser(s):
    assert _outcome(lambda: _factored(tparams, s)) == _outcome(lambda: _factored(jparams, s))


@pytest.mark.parametrize("mode,want", [("true", "true"), ("TRUE", "true"), ("auto", "auto"),
                                       ("false", "false"), ("0", "false")])
def test_vmapped_grid_and_factored_flags_parse_like_the_jax_parser(mode, want):
    argv = ["--train-input-dirs", "t", "--task-type", "LOGISTIC_REGRESSION",
            "--output-dir", "o", "--updating-sequence", "fixed,per-user",
            "--fixed-effect-data-configurations", "fixed:global,1",
            "--random-effect-data-configurations", "per-user:userId,per_user,1,-1,-1,-1,INDEX_MAP",
            "--factored-random-effect-optimization-configurations", FACTORED[0],
            "--vmapped-grid", mode]
    got, ref = tparams.parse_training_params(argv), jparams.parse_training_params(argv)
    assert got.vmapped_grid == ref.vmapped_grid == want
    assert _factored(tparams, FACTORED[0]) == {
        k: (v.random_effect.optimizer.value, v.random_effect.reg_weight,
            v.latent_factor.optimizer.value, v.latent_factor.reg_type.value,
            v.mf_num_iterations, v.latent_dim) for k, v in ref.factored_configs.items()}
    assert sorted(got.factored_configs) == ["per-user"]


def test_validate_counts_factored_names_and_normalizes_vmapped_grid():
    def params(mod, **kw):
        return mod.GameTrainingParams(train_input_dirs=["t"], output_dir="o",
                                      updating_sequence=["fixed", "mf"],
                                      fixed_effect_data_configs={
                                          "fixed": mod.FixedEffectDataSpec("global", 1)}, **kw)

    spec = tparams.parse_factored_config_map("mf" + FACTORED[0][len("per-user"):])
    p = params(tparams, factored_configs=spec, vmapped_grid=True)
    p.validate()
    assert p.vmapped_grid == "true"
    with pytest.raises(ValueError, match="coordinate 'mf' has no data configuration"):
        params(tparams).validate()
    with pytest.raises(ValueError, match="vmapped_grid must be"):
        params(tparams, factored_configs=spec, vmapped_grid="sometimes").validate()


# --- run_grid ------------------------------------------------------------------

def _port_coords(glmix):
    _, data = glmix
    return {
        "fixed": FixedEffectCoordinate(
            tgame.build_fixed_effect_batch(data, "global", device="cpu"),
            GLMOptimizationProblem(TaskType.LOGISTIC_REGRESSION, OptimizerType.LBFGS,
                                   interop.from_jax_numpy(FE_CFG, "cpu"),
                                   interop.from_jax_numpy(JReg.l2(FE_LAMBDAS[0]), "cpu"))),
        "re": RandomEffectCoordinate(
            tgame.build_random_effect_dataset(data, tgame.RandomEffectDataConfig("userId", "per_user"),
                                              device="cpu"),
            TaskType.LOGISTIC_REGRESSION, OptimizerType.LBFGS,
            interop.from_jax_numpy(RE_CFG, "cpu"),
            interop.from_jax_numpy(JReg.l2(RE_LAMBDAS[0]), "cpu"), sparse_kernel="off"),
    }


def _port_cd(glmix, coords=None):
    labels = torch.from_numpy(glmix[1].response)
    return CoordinateDescent(coords or _port_coords(glmix),
                             lambda s: torch.sum(tlosses.logistic.loss(s, labels)))


def _jax_cd(glmix):
    data, _ = glmix
    coords = {
        "fixed": JFixed(j_fe_batch(data, "global", dense=True),
                        JProblem(JTask.LOGISTIC_REGRESSION, JOpt.LBFGS, FE_CFG, JReg.l2(FE_LAMBDAS[0]))),
        "re": JRandom(j_build(data, JReConfig("userId", "per_user")), JTask.LOGISTIC_REGRESSION,
                      JOpt.LBFGS, RE_CFG, JReg.l2(RE_LAMBDAS[0]), sparse_kernel="off"),
    }
    labels = jnp.asarray(data.response)
    return JCD(coords, lambda s: jnp.sum(jlosses.logistic.loss(s, labels)))


LAMBDAS = {"fixed": FE_LAMBDAS, "re": RE_LAMBDAS}


def test_run_grid_matches_the_jax_run_grid(glmix):
    n = glmix[1].num_rows
    want = _jax_cd(glmix).run_grid({k: jnp.asarray(v) for k, v in LAMBDAS.items()}, ITERS, n)
    got = _port_cd(glmix).run_grid(LAMBDAS, ITERS, n)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert len(g.objective_history) == len(w.objective_history) == 2 * ITERS
        assert_allclose(g.objective_history, w.objective_history, kind="solver", dtype=np.float32)
        for name in LAMBDAS:
            assert_allclose(g.coefficients[name].numpy(), np.asarray(w.coefficients[name]),
                            kind="solver")
        assert_allclose(g.total_scores.numpy(), np.asarray(w.total_scores), kind="solver")
        assert list(g.timings) == list(w.timings) == ["(grid)"]
    # the best combo by final objective
    best = lambda rs: int(np.argmin([r.objective_history[-1] for r in rs]))
    assert best(got) == best(want)


@pytest.mark.parametrize("warm", [False, True])
def test_run_grid_is_bitwise_the_per_combo_run(glmix, warm):
    """Cold, and with every combo warm-started from one point (each
    coordinate then contributes its scores from step zero, as in run())."""
    n = glmix[1].num_rows
    init = None
    if warm:
        first = _port_cd(glmix).run_grid({k: v[:1] for k, v in LAMBDAS.items()}, 1, n)[0]
        init = first.coefficients
    grid = _port_cd(glmix).run_grid(LAMBDAS, ITERS, n, init_params=init)
    for i, res in enumerate(grid):
        coords = _port_coords(glmix)
        fixed, re = coords["fixed"], coords["re"]
        fixed.problem = dataclasses.replace(
            fixed.problem, regularization=fixed.problem.regularization.with_weight(FE_LAMBDAS[i]))
        re.regularization = re.regularization.with_weight(RE_LAMBDAS[i])
        one = _port_cd(glmix, coords).run(ITERS, n, initial_params=init)
        assert res.objective_history == one.objective_history
        for name in LAMBDAS:
            assert torch.equal(res.coefficients[name], one.coefficients[name]), (i, name)
        assert torch.equal(res.total_scores, one.total_scores)


def test_run_grid_refuses_a_coordinate_without_reg_weight(glmix):
    _, data = glmix
    ds = tgame.build_random_effect_dataset(
        data, tgame.RandomEffectDataConfig("userId", "per_user", projector="IDENTITY"),
        device="cpu")
    coords = {"mf": FactoredRandomEffectCoordinate(ds, TaskType.LOGISTIC_REGRESSION,
                                                   MFOptimizationConfig(1, 2))}
    with pytest.raises(ValueError, match="does not accept a reg_weight"):
        _port_cd(glmix, coords).run_grid({"mf": [0.1, 1.0]}, 1, data.num_rows)
    with pytest.raises(ValueError, match="reg_weights keys"):
        _port_cd(glmix).run_grid({"fixed": [0.1]}, 1, data.num_rows)


def test_run_grid_refuses_a_divergence_guard(glmix):
    """The guard gates run()'s updates only; the driver's grid blocker sends
    a guarded run through the per-combo path."""
    labels = torch.from_numpy(glmix[1].response)
    cd = CoordinateDescent(_port_coords(glmix),
                           lambda s: torch.sum(tlosses.logistic.loss(s, labels)),
                           divergence_guard=DivergenceGuard())
    with pytest.raises(ValueError, match="no divergence guard"):
        cd.run_grid(LAMBDAS, 1, glmix[1].num_rows)


@pytest.mark.parametrize("stop", [1, 2, 3])
def test_grid_checkpoint_stopped_at_every_boundary_resumes_bitwise(glmix, tmp_path, stop):
    """Three combos of two iterations: a combo polls for preemption at each
    iteration boundary but its last, so at three drain points in all."""
    n = glmix[1].num_rows
    clean = _port_cd(glmix).run_grid(LAMBDAS, ITERS, n)
    cks = lambda: [tckpt.CoordinateDescentCheckpointer(str(tmp_path / f"combo-{i}"))
                   for i in range(3)]
    preemption.install_plan({"cycle": stop})
    with pytest.raises(preemption.Preempted):
        _port_cd(glmix).run_grid(LAMBDAS, ITERS, n, checkpointers=cks())
    preemption.reset()
    resumed = _port_cd(glmix).run_grid(LAMBDAS, ITERS, n, checkpointers=cks())
    for a, b in zip(clean, resumed):
        assert a.objective_history == b.objective_history
        for name in LAMBDAS:
            assert torch.equal(a.coefficients[name], b.coefficients[name])
        assert torch.equal(a.total_scores, b.total_scores)


def test_grid_checkpoint_leaves_and_structure_equal_jax(glmix, tmp_path):
    data, _ = glmix
    n = data.num_rows
    fp = tckpt.fingerprint({"combo": 0, "grid": True})
    jdirs = [str(tmp_path / f"jax-{i}") for i in range(3)]
    tdirs = [str(tmp_path / f"port-{i}") for i in range(3)]
    _jax_cd(glmix).run_grid({k: jnp.asarray(v) for k, v in LAMBDAS.items()}, ITERS, n,
                            checkpointers=[jckpt.CoordinateDescentCheckpointer(d, fp, keep=10)
                                           for d in jdirs])
    port = _port_cd(glmix).run_grid(LAMBDAS, ITERS, n, checkpointers=[
        tckpt.CoordinateDescentCheckpointer(d, fp, keep=10) for d in tdirs])
    for jdir, tdir in zip(jdirs, tdirs):
        assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == ["step-2", "step-4"]
        for step in ("step-2", "step-4"):
            metas = []
            for d in (jdir, tdir):
                with open(os.path.join(d, step, "meta.json")) as f:
                    metas.append(json.load(f))
                with np.load(os.path.join(d, step, "arrays.npz")) as npz:
                    metas[-1]["arrays"] = {k: (npz[k].dtype, npz[k].shape) for k in npz.files}
            jm, tm = metas
            assert tm["structure"] == jm["structure"] and tm["arrays"] == jm["arrays"]
            assert tm["arrays"]["total.0"][1] == (1, n)
            assert (tm["step"], tm["fingerprint"]) == (jm["step"], fp)
    # the JAX checkpointer restores the port's last grid step of combo 2
    jc = _jax_cd(glmix)
    params = {k: c.initial_coefficients()[None] for k, c in jc.coordinates.items()}
    scores = {k: jnp.zeros((1, n)) for k in params}
    got = jckpt.CoordinateDescentCheckpointer(tdirs[2], fp).restore(params, scores,
                                                                    jnp.zeros((1, n)))
    assert got.step == 4 and got.objective_history == port[2].objective_history
    for name in params:
        assert np.array_equal(np.asarray(got.params[name])[0], port[2].coefficients[name].numpy())
