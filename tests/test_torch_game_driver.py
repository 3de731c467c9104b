"""The port's GAME training driver against the JAX driver end to end (CPU),
on the Avro fixture of tests/test_game_drivers.py: the README quickstart's
flags (without ``--checkpoint-dir``) through both ``main([...])``.

Objective histories and validation metrics at the ``solver`` tolerance of
tests/tolerances.py, the same on-disk model layout, and each package loads
the other's saved model. The pure-Python Avro codec writes the same bytes
in both packages, every flag whose path is not yet ported raises (the grid,
factored and sampling flags run: tests/test_torch_game_grid*.py; so do
``--export-serve-store`` and ``--store-dtype``), and interop carries the
GAME objects across.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.cli import game_training_driver as jdriver
from photon_ml_tpu.data.game import RandomEffectDataConfig as JReConfig
from photon_ml_tpu.data.game import build_random_effect_dataset as j_build
from photon_ml_tpu.io import avro as javro
from photon_ml_tpu.io import model_io as jmodel_io
from photon_ml_tpu.io import schemas as jschemas
from photon_ml_tpu.models.game import FixedEffectModel as JFixedModel
from photon_ml_tpu.models.game import GameModel as JGameModel
from photon_ml_tpu.models.game import RandomEffectModel as JRandomModel
from photon_ml_tpu.ops import fused_sparse as jfs
from photon_ml_tpu.optim.common import OptimizerConfig as JConfig
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import interop
from photon_ml_tpu_torch.cli import game_params as tparams
from photon_ml_tpu_torch.cli import game_training_driver as tdriver
from photon_ml_tpu_torch.data import game as tgame
from photon_ml_tpu_torch.io import avro as tavro
from photon_ml_tpu_torch.io import model_io as tmodel_io
from photon_ml_tpu_torch.io import schemas as tschemas
from photon_ml_tpu_torch.ops import fused_sparse as tfs
from test_game_drivers import COMMON_FLAGS, GAME_EXAMPLE_SCHEMA, game_avro_dirs  # noqa: F401
from tolerances import assert_allclose

QUICKSTART = COMMON_FLAGS + ["--evaluator-type", "AUC", "--num-iterations", "2"]


def _argv(train_dir, val_dir, out, re_optimizer):
    flags = list(QUICKSTART)
    i = flags.index("--random-effect-optimization-configurations")
    flags[i + 1] = f"per-user:40,1e-4,0.1,1,{re_optimizer},L2"
    return ["--train-input-dirs", train_dir, "--validate-input-dirs", val_dir,
            "--output-dir", out] + flags


@pytest.fixture(scope="module")
def jax_runs(game_avro_dirs):  # noqa: F811
    train_dir, val_dir, base = game_avro_dirs
    runs = {}
    for opt in ("LBFGS", "TRON"):
        out = os.path.join(base, f"jax-{opt}")
        runs[opt] = (jdriver.main(_argv(train_dir, val_dir, out, opt)), out)
    return runs


@pytest.mark.parametrize("spec", ["off", "pallas"])
@pytest.mark.parametrize("re_optimizer", ["LBFGS", "TRON"])
def test_port_driver_matches_jax_driver(game_avro_dirs, jax_runs, monkeypatch, tmp_path,  # noqa: F811
                                        re_optimizer, spec):
    train_dir, val_dir, _ = game_avro_dirs
    jd, jout = jax_runs[re_optimizer]
    monkeypatch.setenv("PHOTON_SPARSE_KERNEL", spec)
    out = str(tmp_path / "port")
    td = tdriver.main(_argv(train_dir, val_dir, out, re_optimizer) + ["--device", "cpu"])
    assert (td.combo_coords[0]["per-user"].slab is not None) == (spec == "pallas")

    (_, jres, jmetrics), (_, tres, tmetrics) = jd.results[0], td.results[0]
    assert len(tres.objective_history) == len(jres.objective_history) == 4
    assert_allclose(tres.objective_history, jres.objective_history, kind="solver", dtype=np.float32)
    assert sorted(tmetrics) == sorted(jmetrics) == ["AUC"]
    assert_allclose(tmetrics["AUC"], jmetrics["AUC"], kind="solver", dtype=np.float32)
    assert tmetrics["AUC"] > 0.6

    # the same layout on disk
    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, files in os.walk(root) for f in files)

    assert tree(os.path.join(out, "best")) == tree(os.path.join(jout, "best"))
    assert tmodel_io.list_game_model(os.path.join(out, "best")) == {
        "fixed-effect": ["fixed"], "random-effect": ["per-user"]}

    # each package loads the other's model
    for load_dir, maps in ((os.path.join(out, "best"), jd.shard_index_maps),
                           (os.path.join(jout, "best"), td.shard_index_maps)):
        for io_mod in (jmodel_io, tmodel_io):
            fe, _, task, shard = io_mod.load_fixed_effect(load_dir, "fixed", maps["global"])
            assert (task.value, shard) == ("LOGISTIC_REGRESSION", "global")
            assert_allclose(fe, np.asarray(jres.coefficients["fixed"]), kind="solver")
            re, _, re_id, shard = io_mod.load_random_effect(load_dir, "per-user", maps["per_user"])
            assert (re_id, shard) == ("userId", "per_user") and len(re) == 12
    t_re = tmodel_io.load_random_effect(os.path.join(out, "best"), "per-user",
                                        jd.shard_index_maps["per_user"])[0]
    j_re = jmodel_io.load_random_effect(os.path.join(jout, "best"), "per-user",
                                        jd.shard_index_maps["per_user"])[0]
    assert sorted(t_re) == sorted(j_re)
    for eid in j_re:
        assert_allclose(t_re[eid], j_re[eid], kind="solver")


def test_port_driver_saves_variances_and_all_models(game_avro_dirs, tmp_path):  # noqa: F811
    train_dir, val_dir, _ = game_avro_dirs
    out = str(tmp_path / "port")
    td = tdriver.main(_argv(train_dir, val_dir, out, "LBFGS") + [
        "--device", "cpu", "--compute-variance", "true", "--model-output-mode", "ALL",
        "--num-output-files-for-random-effect-model", "2"])
    imap = td.shard_index_maps["per_user"]
    variances = {}
    means = tmodel_io.load_random_effect(os.path.join(out, "all", "0"), "per-user", imap,
                                         variances_out=variances)[0]
    assert sorted(variances) == sorted(means) and len(means) == 12
    assert all(np.all(v[np.nonzero(m)] > 0) for m, v in
               ((means[k], variances[k]) for k in means))
    parts = sorted(os.listdir(os.path.join(out, "best", "random-effect", "per-user",
                                           "coefficients")))
    assert parts == ["part-00000.avro", "part-00001.avro"]
    fe_var = tmodel_io.load_fixed_effect(os.path.join(out, "best"), "fixed",
                                         td.shard_index_maps["global"])[1]
    assert fe_var is not None and np.all(fe_var > 0)


FENCED = [
    ["--distributed", "true"],
    ["--fused-cycle", "true"],
    ["--persistent-cache", "cache"],
]


@pytest.mark.parametrize("extra", FENCED, ids=[f[0] for f in FENCED])
def test_every_unported_flag_raises_naming_it(tmp_path, extra):
    argv = _argv("train", "validate", str(tmp_path / "o"), "LBFGS") + extra
    with pytest.raises(ValueError, match=f"{extra[0]} is not yet ported"):
        tparams.parse_training_params(argv)


# the serving store's flags, fenced until the serving slice was ported
STORE_FLAGS = [["--store-dtype", "bf16"], ["--export-serve-store", "store"]]


@pytest.mark.parametrize("extra", STORE_FLAGS, ids=[f[0] for f in STORE_FLAGS])
def test_store_flags_parse_like_the_jax_parser(tmp_path, extra):
    from photon_ml_tpu.cli.game_params import parse_training_params as jparse

    argv = _argv("train", "validate", str(tmp_path / "o"), "LBFGS") + extra
    got, want = tparams.parse_training_params(argv), jparse(argv)
    assert got.unported_flags == []
    assert (got.export_serve_store, got.store_dtype) == \
        (want.export_serve_store, want.store_dtype)


def test_a_bad_store_dtype_is_refused_as_in_jax(tmp_path):
    from photon_ml_tpu.cli.game_params import parse_training_params as jparse

    argv = _argv("train", "validate", str(tmp_path / "o"), "LBFGS") + ["--store-dtype", "fp8"]
    for parse in (tparams.parse_training_params, jparse):
        with pytest.raises(SystemExit):  # argparse's choices
            parse(argv)
    good = _argv("train", "validate", str(tmp_path / "o"), "LBFGS")
    for params in (tparams.parse_training_params(good), jparse(good)):
        params.store_dtype = "fp8"
        with pytest.raises(ValueError, match="--store-dtype"):
            params.validate()


def test_export_serve_store_runs_and_both_packages_open_the_store(game_avro_dirs,  # noqa: F811
                                                                  tmp_path):
    from photon_ml_tpu.serve import ModelStore as JStore
    from photon_ml_tpu_torch.serve import ModelStore as TStore

    train_dir, val_dir, _ = game_avro_dirs
    store = str(tmp_path / "store")
    driver = tdriver.main(_argv(train_dir, val_dir, str(tmp_path / "o"), "LBFGS")
                          + ["--device", "cpu", "--export-serve-store", store,
                             "--store-dtype", "int8"])
    assert driver.timer.totals["export-serve-store"] >= 0
    port, jax_ = TStore(store), JStore(store)
    assert port.store_dtype == jax_.store_dtype == "int8"
    assert [r.name for r in port.random] == [r.name for r in jax_.random] == ["per-user"]
    assert np.array_equal(port.random[0].dequantized(), jax_.random[0].dequantized())
    port.close()
    jax_.close()


def test_quickstart_flags_parse_like_the_jax_parser(tmp_path):
    from photon_ml_tpu.cli.game_params import parse_training_params as jparse

    argv = _argv("train", "validate", str(tmp_path / "o"), "TRON")
    got, want = tparams.parse_training_params(argv), jparse(argv)
    assert got.updating_sequence == want.updating_sequence
    assert got.feature_shard_sections == want.feature_shard_sections
    assert len(got.config_grid()) == len(want.config_grid()) == 1
    assert got.config_grid()[0]["per-user"].optimizer.value == "TRON"
    assert got.random_effect_data_configs["per-user"].projector == "INDEX_MAP"
    assert [(e.value, k, i) for e, k, i in got.evaluators] == \
        [(e.value, k, i) for e, k, i in want.evaluators]


def test_avro_codec_writes_the_same_bytes_and_reads_the_other(tmp_path):
    rng = np.random.default_rng(3)
    records = [{
        "uid": None if i % 3 else str(i), "label": float(rng.integers(0, 2)),
        "fixedFeatures": [{"name": f"f{j}", "term": "t" * (j % 2), "value": float(rng.normal())}
                          for j in range(rng.integers(0, 5))],
        "userFeatures": [{"name": "u", "term": "", "value": -1.5e300 if i == 7 else 2.0 ** -i}],
        "metadataMap": {"userId": f"u{i % 4}", "k": "é"} if i % 2 else None,
        "weight": None if i % 5 else 0.5, "offset": float(-i),
    } for i in range(5000)]
    jpath, tpath = str(tmp_path / "j.avro"), str(tmp_path / "t.avro")
    javro.write_container(jpath, records, GAME_EXAMPLE_SCHEMA)
    tavro.write_container(tpath, records, GAME_EXAMPLE_SCHEMA)
    with open(jpath, "rb") as fj, open(tpath, "rb") as ft:
        assert fj.read() == ft.read()
    assert list(tavro.read_container(jpath)) == list(javro.read_container(tpath)) == records
    assert tschemas.TRAINING_EXAMPLE == jschemas.TRAINING_EXAMPLE
    assert tschemas.BAYESIAN_LINEAR_MODEL == jschemas.BAYESIAN_LINEAR_MODEL
    for n in (0, 1, -1, 63, -64, 2 ** 40, -(2 ** 62)):
        tb, jb = __import__("io").BytesIO(), __import__("io").BytesIO()
        tavro.write_long(tb, n)
        javro.write_long(jb, n)
        assert tb.getvalue() == jb.getvalue()
        tb.seek(0)
        assert tavro.read_long(tb) == n


def test_avro_id_and_key_scans_match_jax(game_avro_dirs):  # noqa: F811
    from photon_ml_tpu.io import avro_data as javro_data
    from photon_ml_tpu_torch.io import avro_data as tavro_data

    train_dir, _, _ = game_avro_dirs
    assert tavro_data.collect_entity_ids([train_dir], ["userId"]) == \
        javro_data.collect_entity_ids([train_dir], ["userId"])
    sections = ["fixedFeatures", "userFeatures"]
    assert tavro_data.collect_feature_keys([train_dir], sections) == \
        javro_data.collect_feature_keys([train_dir], sections)


def test_interop_carries_game_objects_both_ways(game_avro_dirs, jax_runs):  # noqa: F811
    jd, _ = jax_runs["LBFGS"]
    jds = j_build(jd.train_data, JReConfig("userId", "per_user"))
    tds = interop.from_jax_numpy(jds, "cpu")
    assert isinstance(tds, tgame.RandomEffectDataset) and tds.num_entities == jds.num_entities
    back = interop.to_numpy(tds)
    for f in tgame.RandomEffectDataset.TENSOR_FIELDS:
        assert np.array_equal(back[f], np.asarray(getattr(jds, f)))
    rebuilt = type(jds)(**{f: jnp.asarray(back[f]) for f in tgame.RandomEffectDataset.TENSOR_FIELDS},
                        num_entities=back["num_entities"], global_dim=back["global_dim"])
    assert rebuilt.num_entities == jds.num_entities

    jslab = jfs.build_sparse_slab(np.asarray(jds.x), bucketer="off", kernel="pallas").astype(
        jnp.bfloat16)
    tslab = interop.from_jax_numpy(jslab, "cpu")
    assert isinstance(tslab, tfs.SparseSlab) and tslab.kernel == "pallas"
    assert tslab.val.dtype == torch.bfloat16
    assert np.array_equal(interop.to_numpy(tslab)["val"], np.asarray(jslab.val, np.float32))

    coeffs = jd.results[0][1].coefficients
    jmodel = JGameModel({
        "fixed": JFixedModel(coeffs["fixed"], "global", JTask.LOGISTIC_REGRESSION),
        "per-user": JRandomModel(coeffs["per-user"], jds.local_to_global, "userId", "per_user",
                                 JTask.LOGISTIC_REGRESSION, np.arange(jds.num_entities),
                                 list(jd.train_data.id_vocabs["userId"])),
    }, JTask.LOGISTIC_REGRESSION)
    tmodel = interop.from_jax_numpy(jmodel, "cpu")
    assert np.array_equal(tmodel["per-user"].coefficients.numpy(), np.asarray(coeffs["per-user"]))
    rows = interop.to_numpy(tmodel)
    assert rows["task"] == "LOGISTIC_REGRESSION"
    assert np.array_equal(rows["models"]["fixed"]["coefficients"], np.asarray(coeffs["fixed"]))
    jre = JRandomModel(**{**rows["models"]["per-user"],
                          "task": JTask(rows["models"]["per-user"]["task"])})
    ep = jnp.asarray(np.asarray(jds.entity_pos))
    assert np.array_equal(
        np.asarray(jre.score_rows(ep, jds.feat_idx, jds.feat_val)),
        tmodel["per-user"].score_rows(*(torch.from_numpy(np.array(a))
                                        for a in (ep, jds.feat_idx, jds.feat_val))).numpy())

    tron_cfg = interop.from_jax_numpy(JConfig.tron_default(), "cpu")
    assert (tron_cfg.max_iterations, tron_cfg.max_cg_iterations) == (15, 20)
    assert JConfig(**interop.to_numpy(tron_cfg)) == JConfig.tron_default()


BUCKETED = ["--bucketed-random-effects", "true", "--compute-variance", "true"]


@pytest.mark.parametrize("ladder", ["off", "on"])
def test_bucketed_driver_matches_jax_driver(game_avro_dirs, tmp_path, ladder):  # noqa: F811
    """``--bucketed-random-effects true`` (with ``--compute-variance``),
    with and without the shape ladder: objectives, metrics and saved models
    (means and variances) at ``solver``, and ``retrain.json`` as the JAX
    driver writes it (``"ladder": "8:2"`` under ``on``)."""
    import json

    train_dir, val_dir, _ = game_avro_dirs
    flags = BUCKETED + ["--shape-canonicalization", ladder]
    outs = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    jd = jdriver.main(_argv(train_dir, val_dir, outs["jax"], "LBFGS") + flags)
    td = tdriver.main(_argv(train_dir, val_dir, outs["port"], "LBFGS") + flags + ["--device", "cpu"])
    coord = td.combo_coords[0]["per-user"]
    assert type(coord).__name__ == type(jd.combo_coords[0]["per-user"]).__name__ == \
        "BucketedRandomEffectCoordinate"
    assert coord._bucket_shapes() == jd.combo_coords[0]["per-user"]._bucket_shapes()
    assert not td.re_datasets  # no globally padded stack was built
    (_, jres, jmetrics), (_, tres, tmetrics) = jd.results[0], td.results[0]
    assert_allclose(tres.objective_history, jres.objective_history, kind="solver", dtype=np.float32)
    assert_allclose(tmetrics["AUC"], jmetrics["AUC"], kind="solver", dtype=np.float32)
    imap = jd.shard_index_maps["per_user"]
    models = {}
    for k, out in outs.items():
        variances = {}
        means = tmodel_io.load_random_effect(os.path.join(out, "best"), "per-user", imap,
                                             variances_out=variances)[0]
        models[k] = (means, variances)
    (tm, tv), (jm, jv) = models["port"], models["jax"]
    assert sorted(tm) == sorted(jm) == sorted(tv) == sorted(jv) and len(jm) == 12
    for eid in jm:
        assert_allclose(tm[eid], jm[eid], kind="solver")
        assert_allclose(tv[eid], jv[eid], kind="solver")
    loaded = {k: json.load(open(os.path.join(v, "retrain.json"))) for k, v in outs.items()}
    for k in loaded:
        del loaded[k]["output_dir"], loaded[k]["model_dir"]
    assert loaded["port"] == loaded["jax"]
    assert loaded["port"]["coordinates"]["per-user"]["kind"] == "bucketed"
    assert loaded["port"]["ingest_inputs"]["ladder"] == (None if ladder == "off" else "8:2")


def test_bucketed_vmapped_grid_falls_back_with_the_jax_reason(tmp_path):
    argv = _argv("train", "validate", str(tmp_path / "o"), "LBFGS") + BUCKETED + [
        "--vmapped-grid", "true"]
    i = argv.index("--random-effect-optimization-configurations")
    argv[i + 1] = "per-user:40,1e-4,0.1,1,LBFGS,L2;per-user:40,1e-4,1,1,LBFGS,L2"
    port = tdriver.GameTrainingDriver(tparams.parse_training_params(argv + ["--device", "cpu"]))
    jax_driver = jdriver.GameTrainingDriver(jdriver.parse_training_params(argv))
    reason = port._vmapped_grid_blocker(port.params.config_grid())
    assert reason == jax_driver._vmapped_grid_blocker(jax_driver.params.config_grid()) == \
        "--bucketed-random-effects (static per-bucket lambdas)"
    with pytest.raises(ValueError, match="--shape-canonicalization"):
        tparams.parse_training_params(argv + ["--shape-canonicalization", "sideways"])
