"""The GAME training and scoring drivers of both packages on a fixed-effect
shard wider than ``DENSE_DIM_THRESHOLD`` (CPU): generated Avro whose fixed
section draws 20 of 9000 feature names per row, so the training scan finds
more than 4096 features and both drivers train the fixed effect on
padded-COO ``SparseFeatures``. Objective histories, validation AUC,
coefficients and scores at the ``solver`` tolerance of tests/tolerances.py.
"""

import os

import numpy as np
import pytest

from photon_ml_tpu.cli import game_scoring_driver as jscoring
from photon_ml_tpu.cli import game_training_driver as jdriver
from photon_ml_tpu.io import avro as javro
from photon_ml_tpu_torch.cli import game_scoring_driver as tscoring
from photon_ml_tpu_torch.cli import game_training_driver as tdriver
from photon_ml_tpu_torch.io import model_io as tmodel_io
from photon_ml_tpu_torch.ops.features import SparseFeatures
from test_game_drivers import COMMON_FLAGS, GAME_EXAMPLE_SCHEMA
from tolerances import assert_allclose

NAMES, PER_ROW, USERS = 9000, 20, 15


def _write(path, rng, users, w_fixed, w_user):
    def records():
        for r, u in enumerate(users):
            cols = rng.choice(NAMES, size=PER_ROW, replace=False)
            xf = rng.normal(size=PER_ROW)
            xu = rng.normal(size=3)
            z = xf @ w_fixed[cols] + xu @ w_user[u]
            yield {
                "uid": str(r), "label": float(rng.random() < 1 / (1 + np.exp(-z))),
                "fixedFeatures": [{"name": f"f{c}", "term": "", "value": float(v)}
                                  for c, v in zip(cols, xf)],
                "userFeatures": [{"name": f"u{j}", "term": "", "value": float(v)}
                                 for j, v in enumerate(xu)],
                "metadataMap": {"userId": f"user{u}"}, "weight": None, "offset": None,
            }

    javro.write_container(path, records(), GAME_EXAMPLE_SCHEMA)


@pytest.fixture(scope="module")
def wide_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("wide-game")
    rng = np.random.default_rng(606)
    w_fixed = rng.normal(size=NAMES) * 0.5
    w_user = rng.normal(size=(USERS, 3))
    for name, n in (("train", 480), ("validate", 160)):
        (base / name).mkdir()
        _write(str(base / name / "part-0.avro"), rng, rng.integers(0, USERS, size=n),
               w_fixed, w_user)
    argv = ["--train-input-dirs", str(base / "train"), "--validate-input-dirs",
            str(base / "validate"), "--evaluator-type", "AUC", "--num-iterations", "2"]
    argv += COMMON_FLAGS
    jd = jdriver.main(argv + ["--output-dir", str(base / "jax")])
    td = tdriver.main(argv + ["--output-dir", str(base / "port"), "--device", "cpu"])
    return base, jd, td


def test_training_drivers_agree_on_a_wide_fixed_shard(wide_runs):
    base, jd, td = wide_runs
    width = len(td.shard_index_maps["global"])
    assert width > tdriver.DENSE_DIM_THRESHOLD and width == len(jd.shard_index_maps["global"])
    assert isinstance(td.fe_batches["fixed"].features, SparseFeatures)
    assert type(jd.fe_batches["fixed"].features).__name__ == "SparseFeatures"
    (_, jres, jmetrics), (_, tres, tmetrics) = jd.results[0], td.results[0]
    assert len(tres.objective_history) == len(jres.objective_history) == 4
    assert_allclose(tres.objective_history, jres.objective_history, kind="solver",
                    dtype=np.float32)
    assert_allclose(tmetrics["AUC"], jmetrics["AUC"], kind="solver", dtype=np.float32)
    assert_allclose(tres.coefficients["fixed"].numpy(), np.asarray(jres.coefficients["fixed"]),
                    kind="solver")
    fe = tmodel_io.load_fixed_effect(str(base / "port" / "best"), "fixed",
                                     td.shard_index_maps["global"])[0]
    assert fe.shape == (width,)


def test_scoring_drivers_score_the_wide_model_alike(wide_runs):
    base, _, _ = wide_runs
    # the training rows: their scan gives the scoring run a wide shard too
    flags = ["--input-dirs", str(base / "train"), "--evaluator-type", "AUC",
             "--feature-shard-id-to-feature-section-keys-map",
             "global:fixedFeatures|per_user:userFeatures"]
    js = jscoring.main(flags + ["--game-model-input-dir", str(base / "jax" / "best"),
                                "--output-dir", str(base / "jax-scores")])
    scores = {}
    for mode in ("false", "true"):
        ts = tscoring.main(flags + ["--game-model-input-dir", str(base / "port" / "best"),
                                    "--output-dir", str(base / f"port-scores-{mode}"),
                                    "--device", "cpu", "--host-scoring", mode])
        assert len(ts.shard_index_maps["global"]) > tdriver.DENSE_DIM_THRESHOLD
        scores[mode] = ts.scores
        assert_allclose(ts.metrics["AUC"], js.metrics["AUC"], kind="solver", dtype=np.float32)
    assert_allclose(scores["false"], scores["true"], kind="elementwise", dtype=np.float32)
    assert_allclose(scores["false"], np.asarray(js.scores), kind="solver", dtype=np.float32)
    assert os.path.isdir(base / "port-scores-false" / "scores")
