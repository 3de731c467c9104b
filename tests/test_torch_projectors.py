"""The port's RANDOM projection against the JAX package (CPU): the Gaussian
matrix bit for bit, the host-side projection of CSR rows, the RANDOM
random-effect dataset byte-equal, the random-effect coordinate's update,
score and ``global_coefficients`` back-projection at the ``solver``
tolerance of tests/tolerances.py (LBFGS and TRON; always the dense stack,
even under a sparse spec), interop of the projection matrix, and the GAME
drivers of both packages with ``RANDOM=k`` on the fixture of
tests/test_game_drivers.py, each loading the other's saved model.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from game_test_utils import make_glmix_data
from photon_ml_tpu import projectors as jproj
from photon_ml_tpu.algorithm.random_effect import RandomEffectCoordinate as JRandom
from photon_ml_tpu.algorithm.random_effect import global_coefficients as j_global
from photon_ml_tpu.cli import game_training_driver as jdriver
from photon_ml_tpu.data.game import RandomEffectDataConfig as JReConfig
from photon_ml_tpu.data.game import build_random_effect_dataset as j_build
from photon_ml_tpu.io import model_io as jmodel_io
from photon_ml_tpu.ops.regularization import RegularizationContext as JReg
from photon_ml_tpu.optim.common import OptimizerConfig as JConfig
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import interop
from photon_ml_tpu_torch import projectors as tproj
from photon_ml_tpu_torch.algorithm.random_effect import RandomEffectCoordinate, global_coefficients
from photon_ml_tpu_torch.cli import game_training_driver as tdriver
from photon_ml_tpu_torch.data import game as tgame
from photon_ml_tpu_torch.io import model_io as tmodel_io
from photon_ml_tpu_torch.types import OptimizerType, ProjectorType, TaskType
from test_game_drivers import COMMON_FLAGS, game_avro_dirs  # noqa: F401
from test_torch_game import TOL, _port_data
from tolerances import assert_allclose


@pytest.mark.parametrize("k,d", [(1, 1), (2, 5), (4, 9), (16, 300)])
@pytest.mark.parametrize("keep_intercept", [True, False])
@pytest.mark.parametrize("seed", [jproj.RANDOM_SEED, 7])
def test_matrix_is_bitwise_the_jax_matrix(k, d, keep_intercept, seed):
    got = tproj.gaussian_random_projection_matrix(k, d, keep_intercept, seed)
    want = jproj.gaussian_random_projection_matrix(k, d, keep_intercept, seed)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    tp = tproj.build_projector(ProjectorType.RANDOM, d, k, keep_intercept, seed)
    jp = jproj.build_projector(jproj.ProjectorType.RANDOM, d, k, keep_intercept, seed)
    assert tp.matrix.numpy().tobytes() == np.asarray(jp.matrix).tobytes()
    assert (tp.projected_dim, tp.original_dim) == (jp.projected_dim, jp.original_dim)


def test_projection_of_rows_and_coefficients_matches_jax():
    rng = np.random.default_rng(4)
    n, d = 50, 30
    splits = np.concatenate([[0], np.cumsum(rng.integers(0, 6, size=n))])
    idx = rng.integers(0, d, size=splits[-1]).astype(np.int64)
    val = rng.normal(size=splits[-1]).astype(np.float32)
    tp = tproj.build_projector(ProjectorType.RANDOM, d, 5)
    jp = jproj.build_projector(jproj.ProjectorType.RANDOM, d, 5)
    got = tp.project_sparse_features(idx, val, splits)
    assert got.tobytes() == jp.project_sparse_features(idx, val, splits).tobytes()
    dense = rng.normal(size=(n, d)).astype(np.float32)
    coef = rng.normal(size=(n, 6)).astype(np.float32)
    assert_allclose(tp.project_features(torch.from_numpy(dense)).numpy(),
                    np.asarray(jp.project_features(jnp.asarray(dense))), kind="elementwise")
    assert_allclose(tp.project_coefficients(torch.from_numpy(coef)).numpy(),
                    np.asarray(jp.project_coefficients(jnp.asarray(coef))), kind="elementwise")
    assert tproj.build_projector(ProjectorType.INDEX_MAP, d) is None
    with pytest.raises(ValueError, match="projected_dim"):
        tproj.build_projector(ProjectorType.RANDOM, d)


@pytest.fixture(scope="module")
def glmix():
    rng = np.random.default_rng(43)
    data, _ = make_glmix_data(rng, num_users=9, rows_per_user_range=(6, 20), d_fixed=6,
                              d_random=5)
    return data, _port_data(data)


CONFIGS = {
    "k=2": dict(random_projection_dim=2),
    "k=4 no intercept row": dict(random_projection_dim=4, random_projection_intercept=False),
    "k=3 capped sharded": dict(random_projection_dim=3, active_upper_bound=8,
                               passive_lower_bound=2, num_shards=2),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_random_dataset_is_byte_equal(glmix, name):
    jdata, tdata = glmix
    kw = dict(random_effect_id="userId", feature_shard_id="per_user", projector="RANDOM",
              **CONFIGS[name])
    want = j_build(jdata, JReConfig(**kw))
    got = tgame.build_random_effect_dataset(tdata, tgame.RandomEffectDataConfig(**kw),
                                            device="cpu")
    assert (got.num_entities, got.global_dim) == (want.num_entities, want.global_dim)
    for field in tgame.RandomEffectDataset.TENSOR_FIELDS + ("projection_matrix",):
        g, e = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert g.dtype == e.dtype and g.shape == e.shape, field
        assert g.tobytes() == e.tobytes(), field
    carried = interop.from_jax_numpy(want, "cpu")
    assert torch.equal(carried.projection_matrix, got.projection_matrix)
    assert interop.to_numpy(got)["projection_matrix"].tobytes() == \
        np.asarray(want.projection_matrix).tobytes()


@pytest.mark.parametrize("spec", ["off", "pallas"])
@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_random_effect_update_and_back_projection_match_jax(glmix, optimizer, spec):
    jdata, tdata = glmix
    kw = dict(random_effect_id="userId", feature_shard_id="per_user", projector="RANDOM",
              random_projection_dim=3)
    jds = j_build(jdata, JReConfig(**kw))
    tds = tgame.build_random_effect_dataset(tdata, tgame.RandomEffectDataConfig(**kw),
                                            device="cpu")
    jcfg, reg = JConfig(max_iterations=40, tolerance=TOL), JReg.l2(0.3)
    jc = JRandom(jds, JTask.LOGISTIC_REGRESSION, JOpt(optimizer), jcfg, reg, sparse_kernel="off")
    tc = RandomEffectCoordinate(tds, TaskType.LOGISTIC_REGRESSION, OptimizerType(optimizer),
                                interop.from_jax_numpy(jcfg, "cpu"),
                                interop.from_jax_numpy(reg, "cpu"), sparse_kernel=spec)
    assert tc.slab is None  # a RANDOM stack solves dense under any spec
    resid = np.random.default_rng(3).normal(scale=0.3, size=jdata.num_rows).astype(np.float32)
    w_j, res_j = jc.update(jnp.asarray(resid), jc.initial_coefficients())
    w_t, res_t = tc.update(torch.from_numpy(resid), tc.initial_coefficients())
    assert tuple(w_t.shape) == (tds.num_entities, 4)
    assert_allclose(w_t.numpy(), np.asarray(w_j), kind="solver")
    assert_allclose(res_t.value.numpy(), np.asarray(res_j.value), kind="solver")
    assert_allclose(tc.score(w_t).numpy(), np.asarray(jc.score(w_j)), kind="solver")
    g_t = global_coefficients(tds, w_t)
    assert tuple(g_t.shape) == (tds.num_entities, tds.global_dim)
    assert_allclose(g_t.numpy(), np.asarray(j_global(jds, w_j)), kind="solver")


@pytest.mark.parametrize("re_optimizer", ["LBFGS", "TRON"])
def test_game_drivers_with_random_projection_match(game_avro_dirs, tmp_path,  # noqa: F811
                                                   re_optimizer):
    train_dir, val_dir, _ = game_avro_dirs
    flags = [f.replace(",INDEX_MAP", ",RANDOM=2") for f in COMMON_FLAGS]
    i = flags.index("--random-effect-optimization-configurations")
    flags[i + 1] = f"per-user:40,1e-4,0.1,1,{re_optimizer},L2"
    argv = ["--train-input-dirs", train_dir, "--validate-input-dirs", val_dir,
            "--num-iterations", "2", "--evaluator-type", "AUC",
            "--compute-variance", "true"] + flags
    tout, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    td = tdriver.main(argv + ["--output-dir", tout, "--device", "cpu"])
    jd = jdriver.main(argv + ["--output-dir", jout])
    assert td.re_datasets["per-user"].local_dim == 3
    (_, tres, tmetrics), (_, jres, jmetrics) = td.results[0], jd.results[0]
    assert_allclose(tres.objective_history, jres.objective_history, kind="solver",
                    dtype=np.float32)
    assert_allclose(tmetrics["AUC"], jmetrics["AUC"], kind="solver", dtype=np.float32)
    imap = jd.shard_index_maps["per_user"]
    t_re, _, re_id, shard = tmodel_io.load_random_effect(os.path.join(jout, "best"), "per-user",
                                                         imap)
    j_re = jmodel_io.load_random_effect(os.path.join(tout, "best"), "per-user", imap)[0]
    assert (re_id, shard) == ("userId", "per_user") and sorted(t_re) == sorted(j_re)
    for eid in j_re:  # back-projected models, saved in the global feature space
        assert_allclose(j_re[eid], t_re[eid], kind="solver")
    variances = {}
    tmodel_io.load_random_effect(os.path.join(tout, "best"), "per-user", imap, variances)
    assert variances == {}  # no diagonal variance survives a dense back-projection
