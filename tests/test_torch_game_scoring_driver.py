"""The port's GAME scoring driver against the JAX scoring driver (CPU), on
the Avro fixture of tests/test_game_drivers.py and the README quickstart's
scoring flags: scores at the ``elementwise`` tolerance of
tests/tolerances.py, the same metrics and the same ScoringResultAvro
records, for a model trained by either package; the port's device scoring
against its host (numpy) oracle; cold-start rows; unlabeled data; the
``--offheap-indexmap-dir`` round trip (feature_indexing, training,
scoring); and the refusal of a factored model.
"""

import os
import shutil

import numpy as np
import pytest

from photon_ml_tpu.cli import game_params as jparams
from photon_ml_tpu.cli import game_scoring_driver as jscoring
from photon_ml_tpu.cli import game_training_driver as jtraining
from photon_ml_tpu.io import avro as javro
from photon_ml_tpu_torch.cli import feature_indexing as tfeature_indexing
from photon_ml_tpu_torch.cli import game_params as tparams
from photon_ml_tpu_torch.cli import game_scoring_driver as tscoring
from photon_ml_tpu_torch.cli import game_training_driver as ttraining
from photon_ml_tpu_torch.io import avro as tavro
from test_game_drivers import COMMON_FLAGS, GAME_EXAMPLE_SCHEMA, game_avro_dirs  # noqa: F401
from tolerances import assert_allclose

SECTIONS = ["--feature-shard-id-to-feature-section-keys-map",
            "global:fixedFeatures|per_user:userFeatures"]
EVALUATORS = "AUC,LOGISTIC_LOSS,PRECISION@3:userId"


@pytest.fixture(scope="module")
def models(game_avro_dirs):  # noqa: F811
    """The quickstart's model trained by each package."""
    train_dir, val_dir, base = game_avro_dirs
    argv = ["--train-input-dirs", train_dir, "--validate-input-dirs", val_dir,
            "--num-iterations", "2", "--evaluator-type", "AUC"] + COMMON_FLAGS
    jd = jtraining.main(argv + ["--output-dir", os.path.join(base, "score-jax-model")])
    td = ttraining.main(argv + ["--output-dir", os.path.join(base, "score-port-model"),
                                "--device", "cpu"])
    return {"jax": (jd, os.path.join(base, "score-jax-model", "best")),
            "port": (td, os.path.join(base, "score-port-model", "best"))}


def _score(mod, model_dir, input_dir, out, *extra):
    argv = ["--input-dirs", input_dir, "--game-model-input-dir", model_dir, "--output-dir", out,
            "--delete-output-dir-if-exists", "true"] + SECTIONS + list(extra)
    if mod is tscoring:
        argv += ["--device", "cpu"]
    return mod.main(argv)


def _records(out):
    recs = []
    for name in sorted(os.listdir(os.path.join(out, "scores"))):
        recs.extend(tavro.read_container(os.path.join(out, "scores", name)))
    return recs


@pytest.mark.parametrize("trained_by", ["jax", "port"])
def test_both_scoring_drivers_score_one_model_alike(game_avro_dirs, models, tmp_path,  # noqa: F811
                                                    trained_by):
    _, val_dir, _ = game_avro_dirs
    training, model_dir = models[trained_by]
    extra = ("--evaluator-type", EVALUATORS, "--game-model-id", "quickstart")
    got = _score(tscoring, model_dir, val_dir, str(tmp_path / "port"), *extra)
    want = _score(jscoring, model_dir, val_dir, str(tmp_path / "jax"), *extra)
    assert got.scores.shape == want.scores.shape == (got.data.num_rows,)
    assert_allclose(got.scores, want.scores, kind="elementwise")
    assert sorted(got.metrics) == sorted(want.metrics) == ["AUC", "LOGISTIC_LOSS", "PRECISION_AT_K@3"]
    for key in want.metrics:
        assert_allclose(got.metrics[key], want.metrics[key], kind="elementwise", dtype=np.float32)
    # the scoring AUC is the training driver's validation AUC
    assert_allclose(got.metrics["AUC"], training.results[0][2]["AUC"], kind="elementwise",
                    dtype=np.float32)
    t_recs, j_recs = _records(str(tmp_path / "port")), _records(str(tmp_path / "jax"))
    assert len(t_recs) == len(j_recs) == len(got.scores)
    for t, j in zip(t_recs, j_recs):
        assert sorted(t) == sorted(j)
        assert {k: v for k, v in t.items() if k != "predictionScore"} == \
            {k: v for k, v in j.items() if k != "predictionScore"}
    assert_allclose([r["predictionScore"] for r in t_recs], [r["predictionScore"] for r in j_recs],
                    kind="elementwise", dtype=np.float32)


@pytest.mark.parametrize("files", [1, 3])
def test_device_scoring_equals_the_host_oracle(game_avro_dirs, models, tmp_path, files):  # noqa: F811
    train_dir, _, _ = game_avro_dirs
    _, model_dir = models["port"]
    extra = ("--num-output-files-for-scores", str(files), "--evaluator-type", "AUC")
    dev = _score(tscoring, model_dir, train_dir, str(tmp_path / "dev"), *extra)
    host = _score(tscoring, model_dir, train_dir, str(tmp_path / "host"), "--host-scoring", "true",
                  *extra)
    assert not dev.host_scoring and host.host_scoring
    assert_allclose(dev.scores, host.scores, kind="elementwise")
    assert dev.metrics["AUC"] == pytest.approx(host.metrics["AUC"], abs=1e-6)
    parts = sorted(os.listdir(str(tmp_path / "dev" / "scores")))
    assert parts == [f"part-{i:05d}.avro" for i in range(files)]
    assert [r["uid"] for r in _records(str(tmp_path / "dev"))] == \
        [str(i) for i in range(dev.data.num_rows)]


def test_cold_start_rows_score_the_fixed_effect_alone(game_avro_dirs, models, tmp_path):  # noqa: F811
    train_dir, _, _ = game_avro_dirs
    _, model_dir = models["port"]
    recs = list(javro.read_container(os.path.join(train_dir, "part-0.avro")))[:40]
    for i, r in enumerate(recs):
        if i % 2 == 0:
            r["metadataMap"] = {"userId": f"cold-user-{i}"}
    cold = tmp_path / "cold"
    cold.mkdir()
    tavro.write_container(str(cold / "part-0.avro"), recs, GAME_EXAMPLE_SCHEMA)
    dev = _score(tscoring, model_dir, str(cold), str(tmp_path / "dev"))
    host = _score(tscoring, model_dir, str(cold), str(tmp_path / "host"), "--host-scoring", "true")
    want = _score(jscoring, model_dir, str(cold), str(tmp_path / "jax"))
    assert_allclose(dev.scores, host.scores, kind="elementwise")
    assert_allclose(dev.scores, want.scores, kind="elementwise")
    # a cold row's random-effect contribution is exactly 0: its score is
    # the fixed effect's alone, scored with the random effect removed
    fe_only = tmp_path / "fe-only"
    shutil.copytree(model_dir, fe_only)
    shutil.rmtree(fe_only / "random-effect")
    fe = _score(tscoring, str(fe_only), str(cold), str(tmp_path / "fe"))
    cold_rows = np.arange(0, 40, 2)
    assert np.array_equal(dev.scores[cold_rows], fe.scores[cold_rows])
    assert not np.allclose(dev.scores[1::2], fe.scores[1::2])


def test_unlabeled_data_scores_without_labels(game_avro_dirs, models, tmp_path):  # noqa: F811
    _, val_dir, _ = game_avro_dirs
    _, model_dir = models["jax"]
    schema = {**GAME_EXAMPLE_SCHEMA, "name": "UnlabeledExampleAvro",
              "fields": [{**f, "type": ["null", "double"], "default": None}
                         if f["name"] == "label" else f for f in GAME_EXAMPLE_SCHEMA["fields"]]}
    recs = list(tavro.read_directory(val_dir))
    for r in recs:
        r["label"] = None
    (tmp_path / "unlabeled").mkdir()
    tavro.write_container(str(tmp_path / "unlabeled" / "p.avro"), recs, schema)
    got = _score(tscoring, model_dir, str(tmp_path / "unlabeled"), str(tmp_path / "port"))
    want = _score(jscoring, model_dir, str(tmp_path / "unlabeled"), str(tmp_path / "jax"))
    assert len(got.scores) == len(recs) and np.all(np.isfinite(got.scores))
    assert_allclose(got.scores, want.scores, kind="elementwise")
    assert all(r["label"] is None for r in _records(str(tmp_path / "port")))
    assert got.metrics == {}


def test_offheap_index_maps_round_trip(game_avro_dirs, tmp_path):  # noqa: F811
    train_dir, val_dir, _ = game_avro_dirs
    idx = str(tmp_path / "idx")
    tfeature_indexing.main(["--data-input-dirs", train_dir, "--output-dir", idx,
                            "--partition-num", "3", "--format", "OFFHEAP"] + SECTIONS)
    argv = ["--train-input-dirs", train_dir, "--validate-input-dirs", val_dir,
            "--num-iterations", "2", "--evaluator-type", "AUC", "--offheap-indexmap-dir", idx,
            "--output-dir", str(tmp_path / "model")] + COMMON_FLAGS
    td = ttraining.main(argv + ["--device", "cpu"])
    jd = jtraining.main(argv[:-len(COMMON_FLAGS)] + ["--output-dir", str(tmp_path / "jmodel")]
                        + COMMON_FLAGS)
    assert_allclose(td.results[0][1].objective_history, jd.results[0][1].objective_history,
                    kind="solver", dtype=np.float32)
    model_dir = str(tmp_path / "model" / "best")
    extra = ("--offheap-indexmap-dir", idx, "--evaluator-type", "AUC")
    got = _score(tscoring, model_dir, val_dir, str(tmp_path / "port"), *extra)
    want = _score(jscoring, model_dir, val_dir, str(tmp_path / "jax"), *extra)
    assert type(got.shard_index_maps["global"]).__name__ == "OffHeapIndexMap"
    assert_allclose(got.scores, want.scores, kind="elementwise")
    assert_allclose(got.metrics["AUC"], td.results[0][2]["AUC"], kind="elementwise",
                    dtype=np.float32)


def test_a_factored_model_is_refused(models, game_avro_dirs, tmp_path):  # noqa: F811
    _, val_dir, _ = game_avro_dirs
    _, model_dir = models["port"]
    shutil.copytree(model_dir, tmp_path / "m")
    with open(tmp_path / "m" / "random-effect" / "per-user" / "id-info", "a") as f:
        f.write("factored\n")
    with pytest.raises(ValueError, match="factored random effects are not yet ported"):
        _score(tscoring, str(tmp_path / "m"), val_dir, str(tmp_path / "o"))


def test_scoring_flags_parse_like_the_jax_parser():
    argv = ["--input-dirs", "a,b", "--game-model-input-dir", "m", "--output-dir", "o",
            "--evaluator-type", EVALUATORS, "--random-effect-id-set", "userId,itemId",
            "--date-range", "20260101-20260102", "--on-corrupt", "skip", "--io-retries", "2",
            "--num-output-files-for-scores", "4", "--host-scoring", "true"] + SECTIONS
    got, want = tparams.parse_scoring_params(argv), jparams.parse_scoring_params(argv)
    for field in ("input_dirs", "game_model_input_dir", "random_effect_id_types",
                  "feature_shard_sections", "num_output_files_for_scores", "date_range",
                  "host_scoring", "on_corrupt", "io_retries", "corrupt_skip_budget"):
        assert getattr(got, field) == getattr(want, field), field
    assert [(e.value, k, i) for e, k, i in got.evaluators] == \
        [(e.value, k, i) for e, k, i in want.evaluators]
    assert got.device == "cuda"
    for bad in (["--date-range-days-ago", "9-1"], ["--io-retries", "0"]):
        with pytest.raises(ValueError):
            tparams.parse_scoring_params(argv + bad)
