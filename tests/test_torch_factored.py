"""The port's factored random effect against the JAX package (CPU), after
tests/test_factored_random_effect.py: the initial state byte-equal, the
closed-form latent objective, gradient and Hessian-vector product against
an explicit Kronecker-feature GLM, ``update`` with LBFGS and TRON latent
solves at the ``solver`` tolerance of tests/tolerances.py (JAX's TRON step
differentiates by ``jax.jvp``, the port's is closed-form), score,
regularization term, the factored and matrix-factorization models, and a
factored coordinate in coordinate descent beside a fixed effect.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from game_test_utils import make_glmix_data
from photon_ml_tpu.algorithm.coordinate_descent import CoordinateDescent as JCD
from photon_ml_tpu.algorithm.factored_random_effect import (
    FactoredRandomEffectCoordinate as JFactored,
)
from photon_ml_tpu.algorithm.factored_random_effect import FactoredState as JState
from photon_ml_tpu.algorithm.factored_random_effect import MFOptimizationConfig as JMF
from photon_ml_tpu.algorithm.fixed_effect import FixedEffectCoordinate as JFixed
from photon_ml_tpu.data.game import RandomEffectDataConfig as JReConfig
from photon_ml_tpu.data.game import build_fixed_effect_batch as j_fe_batch
from photon_ml_tpu.data.game import build_random_effect_dataset as j_build
from photon_ml_tpu.models.game import FactoredRandomEffectModel as JFactoredModel
from photon_ml_tpu.models.game import MatrixFactorizationModel as JMFModel
from photon_ml_tpu.ops import losses as jlosses
from photon_ml_tpu.ops.regularization import RegularizationContext as JReg
from photon_ml_tpu.optim.common import OptimizerConfig as JConfig
from photon_ml_tpu.optim.problem import GLMOptimizationProblem as JProblem
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import interop
from photon_ml_tpu_torch.algorithm.coordinate_descent import CoordinateDescent
from photon_ml_tpu_torch.algorithm.factored_random_effect import (
    LATENT_MATRIX_SEED,
    FactoredRandomEffectCoordinate,
    FactoredState,
    MFOptimizationConfig,
)
from photon_ml_tpu_torch.algorithm.fixed_effect import FixedEffectCoordinate
from photon_ml_tpu_torch.data import game as tgame
from photon_ml_tpu_torch.models.game import FactoredRandomEffectModel, MatrixFactorizationModel
from photon_ml_tpu_torch.ops import losses as tlosses
from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.types import OptimizerType, TaskType
from tolerances import assert_allclose

K = 3


@pytest.fixture(scope="module")
def glmix():
    data, _ = make_glmix_data(np.random.default_rng(3), num_users=10, rows_per_user_range=(5, 30),
                              d_random=6, noise=0.1)
    port = tgame.GameData(
        response=data.response, offset=data.offset, weight=data.weight,
        ids=dict(data.ids), id_vocabs=dict(data.id_vocabs),
        shards={k: tgame.HostFeatures(f.indptr, f.indices, f.values, f.dim)
                for k, f in data.shards.items()},
    )
    cfg = dict(random_effect_id="userId", feature_shard_id="per_user", projector="IDENTITY")
    return (data, port, j_build(data, JReConfig(**cfg)),
            tgame.build_random_effect_dataset(port, tgame.RandomEffectDataConfig(**cfg),
                                              device="cpu"))


def _pair(glmix, re_opt="LBFGS", lat_opt="LBFGS", inner=2, re_reg=None, lat_reg=None, iters=10):
    _, _, jds, tds = glmix
    re_reg = re_reg or JReg.l2(0.5)
    lat_reg = lat_reg or JReg.l2(1.0)
    re_cfg, lat_cfg = JConfig(max_iterations=iters, tolerance=1e-6), JConfig(max_iterations=iters,
                                                                            tolerance=1e-6)
    j = JFactored(dataset=jds, task=JTask.LOGISTIC_REGRESSION, mf_config=JMF(inner, K),
                  re_optimizer=JOpt(re_opt), re_optimizer_config=re_cfg, re_regularization=re_reg,
                  latent_optimizer=JOpt(lat_opt), latent_optimizer_config=lat_cfg,
                  latent_regularization=lat_reg)
    conv = lambda x: interop.from_jax_numpy(x, "cpu")
    t = FactoredRandomEffectCoordinate(
        dataset=tds, task=TaskType.LOGISTIC_REGRESSION, mf_config=MFOptimizationConfig(inner, K),
        re_optimizer=OptimizerType(re_opt), re_optimizer_config=conv(re_cfg),
        re_regularization=conv(re_reg), latent_optimizer=OptimizerType(lat_opt),
        latent_optimizer_config=conv(lat_cfg), latent_regularization=conv(lat_reg))
    return j, t


def test_mf_config_parses_like_jax():
    for s in ("3,7", "1,4", " 2 ,5"):
        got, want = MFOptimizationConfig.parse(s), JMF.parse(s)
        assert (got.num_inner_iterations, got.latent_space_dimension) == \
            (want.num_inner_iterations, want.latent_space_dimension)
    with pytest.raises(ValueError):
        MFOptimizationConfig.parse("3")


def test_initial_state_is_byte_equal(glmix):
    j, t = _pair(glmix)
    assert LATENT_MATRIX_SEED == j.seed
    js, ts = j.initial_coefficients(), t.initial_coefficients()
    for got, want in ((ts.v, js.v), (ts.matrix, js.matrix)):
        g, w = got.numpy(), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()
    assert tuple(ts.matrix.shape) == (K, glmix[3].local_dim)
    assert not torch.any(ts.v)


def test_requires_an_identity_dataset(glmix):
    _, port, _, _ = glmix
    ds = tgame.build_random_effect_dataset(port, tgame.RandomEffectDataConfig(
        "userId", "per_user", projector="RANDOM", random_projection_dim=2), device="cpu")
    with pytest.raises(ValueError, match="IDENTITY-projection"):
        FactoredRandomEffectCoordinate(ds, TaskType.LOGISTIC_REGRESSION)


def test_latent_objective_matches_explicit_kronecker(glmix):
    """The closed-form value, gradient and Hessian-vector product of the
    latent fit equal a GLM whose features are materialized kron(x, v_e)
    against the row-major flattened matrix."""
    _, _, _, tds = glmix
    _, t = _pair(glmix)
    gen = np.random.default_rng(8)
    e, m_cap, d = tds.x.shape
    v = torch.from_numpy(gen.normal(size=(e, K))).double()
    mat = torch.from_numpy(gen.normal(size=(K, d))).double()
    tangent = torch.from_numpy(gen.normal(size=(K * d,))).double()
    x = tds.x.reshape(-1, d).double()
    y, w = tds.labels.reshape(-1).double(), tds.weights.reshape(-1).double()
    off = torch.from_numpy(gen.normal(scale=0.1, size=(e * m_cap,)))
    v_rows = torch.repeat_interleave(v, m_cap, dim=0)
    loss = tlosses.logistic
    vg, hvp = t._latent_fns(loss, x, y, off, w, v_rows)
    # kron feature of row n: (v_n (x) x_n) against flattened (k, d) M
    kron = (v_rows[:, :, None] * x[:, None, :]).reshape(-1, K * d)
    z = kron @ mat.reshape(-1) + off
    l2 = t.latent_regularization.l2_weight
    f_want = torch.sum(w * loss.loss(z, y)) + 0.5 * l2 * torch.sum(mat ** 2)
    g_want = kron.T @ (w * loss.d1(z, y)) + l2 * mat.reshape(-1)
    h_want = kron.T @ (w * loss.d2(z, y) * (kron @ tangent)) + l2 * tangent
    f, g = vg(mat.reshape(-1))
    np.testing.assert_allclose(float(f), float(f_want), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), g_want.numpy(), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(hvp(mat.reshape(-1), tangent).numpy(), h_want.numpy(),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("re_opt,lat_opt", [("LBFGS", "LBFGS"), ("LBFGS", "TRON"),
                                            ("TRON", "TRON")])
def test_update_matches_jax(glmix, re_opt, lat_opt):
    data = glmix[0]
    j, t = _pair(glmix, re_opt, lat_opt)
    resid = np.random.default_rng(4).normal(scale=0.3, size=data.num_rows).astype(np.float32)
    js, jres = j.update(jnp.asarray(resid), j.initial_coefficients())
    ts, tres = t.update(torch.from_numpy(resid), t.initial_coefficients())
    assert isinstance(ts, FactoredState)
    assert_allclose(ts.matrix.numpy(), np.asarray(js.matrix), kind="solver")
    assert_allclose(ts.v.numpy(), np.asarray(js.v), kind="solver")
    assert_allclose(tres.value.numpy(), np.asarray(jres.value), kind="solver")
    assert tuple(tres.value.shape) == (glmix[3].num_entities,)
    assert_allclose(t.score(ts).numpy(), np.asarray(j.score(js)), kind="solver")
    # the latent matrix moved, and the data loss fell
    assert not np.allclose(ts.matrix.numpy(), t.initial_coefficients().matrix.numpy())
    y = torch.from_numpy(data.response)
    loss = lambda s: float(torch.sum(tlosses.logistic.loss(s, y)))
    assert loss(t.score(ts)) < loss(t.score(t.initial_coefficients()))


def test_l1_latent_solve_matches_jax(glmix):
    data = glmix[0]
    j, t = _pair(glmix, re_reg=JReg.l1(0.2), lat_reg=JReg.l1(0.5), inner=1)
    resid = np.zeros(data.num_rows, np.float32)
    js, _ = j.update(jnp.asarray(resid), j.initial_coefficients())
    ts, _ = t.update(torch.from_numpy(resid), t.initial_coefficients())
    assert_allclose(ts.matrix.numpy(), np.asarray(js.matrix), kind="solver")
    assert_allclose(ts.v.numpy(), np.asarray(js.v), kind="solver")


def test_score_regularization_and_coefficients_match_jax(glmix):
    _, _, jds, tds = glmix
    j, t = _pair(glmix, re_reg=JReg.elastic_net(2.0, 0.3), lat_reg=JReg.l2(4.0))
    gen = np.random.default_rng(9)
    v = gen.normal(size=(tds.num_entities, K)).astype(np.float32)
    mat = gen.normal(size=(K, tds.local_dim)).astype(np.float32)
    js, ts = JState(jnp.asarray(v), jnp.asarray(mat)), FactoredState(torch.from_numpy(v),
                                                                     torch.from_numpy(mat))
    assert_allclose(t.score(ts).numpy(), np.asarray(j.score(js)), kind="elementwise")
    assert_allclose(float(t.regularization_term(ts)), float(j.regularization_term(js)),
                    kind="elementwise", dtype=np.float32)
    assert_allclose(t.random_effect_coefficients(ts).numpy(),
                    np.asarray(j.random_effect_coefficients(js)), kind="elementwise")
    # the score of a row is x . (V M)[its entity]
    w = v @ mat
    rows = tds.entity_pos.numpy() >= 0
    x = np.zeros((tds.num_rows, tds.local_dim), np.float32)
    idx, val = tds.feat_idx.numpy(), tds.feat_val.numpy()
    for r in np.nonzero(rows)[0]:
        ok = idx[r] >= 0
        x[r, idx[r][ok]] = val[r][ok]
    want = np.where(rows, np.sum(x * w[np.maximum(tds.entity_pos.numpy(), 0)], axis=1), 0)
    assert_allclose(t.score(ts).numpy(), want, kind="elementwise")


def test_matrix_factorization_model_matches_jax():
    gen = np.random.default_rng(11)
    rows_f = gen.normal(size=(5, 3)).astype(np.float32)
    cols_f = gen.normal(size=(7, 3)).astype(np.float32)
    r, c = np.array([0, 2, 4, -1, 3]), np.array([1, 6, -1, 3, 0])
    j = JMFModel("userId", "movieId", jnp.asarray(rows_f), jnp.asarray(cols_f))
    t = MatrixFactorizationModel("userId", "movieId", torch.from_numpy(rows_f),
                                 torch.from_numpy(cols_f))
    got = t.score(torch.from_numpy(r), torch.from_numpy(c)).numpy()
    assert_allclose(got, np.asarray(j.score(jnp.asarray(r), jnp.asarray(c))), kind="elementwise")
    assert got[2] == 0.0 and got[3] == 0.0
    assert t.num_latent_factors == j.num_latent_factors == 3
    assert t.to_summary_string() == j.to_summary_string()


def test_factored_model_converts_to_a_random_effect_model():
    gen = np.random.default_rng(12)
    lat = gen.normal(size=(4, 2)).astype(np.float32)
    mat = gen.normal(size=(2, 6)).astype(np.float32)
    l2g = np.tile(np.arange(6, dtype=np.int32), (4, 1))
    j = JFactoredModel(jnp.asarray(lat), jnp.asarray(mat), "userId", "per_user",
                       JTask.LOGISTIC_REGRESSION).to_random_effect_model(jnp.asarray(l2g))
    t = FactoredRandomEffectModel(torch.from_numpy(lat), torch.from_numpy(mat), "userId",
                                  "per_user", TaskType.LOGISTIC_REGRESSION
                                  ).to_random_effect_model(torch.from_numpy(l2g))
    assert tuple(t.coefficients.shape) == (4, 6)
    assert_allclose(t.coefficients.numpy(), np.asarray(j.coefficients), kind="elementwise")
    assert (t.random_effect_id, t.feature_shard_id) == (j.random_effect_id, j.feature_shard_id)


def test_in_coordinate_descent_with_a_fixed_effect_matches_jax(glmix):
    data, port, _, _ = glmix
    j_fac, t_fac = _pair(glmix, inner=1, iters=8)
    fe_cfg = JConfig(max_iterations=20, tolerance=1e-6)
    j_coords = {"fixed": JFixed(j_fe_batch(data, "global"),
                                JProblem(JTask.LOGISTIC_REGRESSION, optimizer_config=fe_cfg)),
                "factored-re": j_fac}
    t_coords = {"fixed": FixedEffectCoordinate(
        tgame.build_fixed_effect_batch(port, "global", device="cpu"),
        GLMOptimizationProblem(TaskType.LOGISTIC_REGRESSION,
                               optimizer_config=interop.from_jax_numpy(fe_cfg, "cpu"))),
        "factored-re": t_fac}
    jy, ty = jnp.asarray(data.response), torch.from_numpy(data.response)
    want = JCD(j_coords, lambda s: jnp.sum(jlosses.logistic.loss(s, jy))).run(2, data.num_rows)
    got = CoordinateDescent(t_coords, lambda s: torch.sum(tlosses.logistic.loss(s, ty))).run(
        2, data.num_rows)
    assert got.objective_history[-1] < got.objective_history[0]
    assert_allclose(got.objective_history, want.objective_history, kind="solver",
                    dtype=np.float32)
    state = got.coefficients["factored-re"]
    assert isinstance(state, FactoredState)
    assert_allclose(state.matrix.numpy(), np.asarray(want.coefficients["factored-re"].matrix),
                    kind="solver")
    assert_allclose(got.total_scores.numpy(), np.asarray(want.total_scores), kind="solver")


def test_chip_smoke_full_game_generator_draws_make_full_game_data():
    """chip_smoke.py writes bench.py:2476's full GAME data without importing
    the test utilities (which import jax): its draws must be theirs."""
    import chip_smoke
    from game_test_utils import make_full_game_data

    rng = np.random.default_rng(23)
    d = chip_smoke.FULL_D
    data, truth = make_full_game_data(rng, num_users=60, num_items=25, num_artists=7,
                                      rows_per_user_range=(8, 16), d_fixed=d["fixed"],
                                      d_user=d["user"], d_item=d["item"], d_artist=d["artist"])
    flip = rng.random(data.num_rows) < 0.15
    data.response[flip] = 1.0 - data.response[flip]
    y, x, user, item, artist, rows_per_user = chip_smoke.full_game_arrays(60, 25, 7, 23)
    assert y.tobytes() == data.response.tobytes()
    assert np.array_equal(user, truth["user_of_row"]) and np.array_equal(item, truth["item_of_row"])
    assert np.array_equal(artist, data.ids["artistId"])
    for key, shard in (("fixed", "global"), ("user", "per_user"), ("item", "per_item"),
                       ("artist", "per_artist")):
        f = data.shards[shard]
        assert f.values.tobytes() == x[key].reshape(-1).tobytes() and f.dim == d[key]
    assert int(rows_per_user.sum()) == data.num_rows
