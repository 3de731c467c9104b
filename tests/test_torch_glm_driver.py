"""The port's GLM driver against the JAX driver end to end (CPU): the same
tiny LIBSVM train/validate pair through both ``main([...])``, LBFGS over a
3-lambda grid with STANDARDIZATION. Per-lambda text models and validation
metrics at the ``solver`` tolerance, the same best lambda, and each
package's text models read by the other's reader (one on-disk layout).
Then Avro input (the driver's default format) with selected features,
summaries and off-heap index maps: the same index maps, models and summary
records in both drivers. The diagnostics and box constraints are
tests/test_torch_glm_diagnostics.py.
"""

import os

import numpy as np
import pytest

from photon_ml_tpu.cli import glm_driver as jdriver
from photon_ml_tpu.utils.io_utils import read_models_from_text as jread
from photon_ml_tpu_torch.cli import glm_driver as tdriver
from photon_ml_tpu_torch.model_selection import selection_metric_for
from photon_ml_tpu_torch.ops.features import SparseFeatures
from photon_ml_tpu_torch.utils.io_utils import read_models_from_text as tread
from tolerances import assert_allclose

D = 20


def _write_libsvm(path, n, seed, task):
    rng = np.random.default_rng(seed)
    x = rng.normal(loc=0.5, scale=2.0, size=(n, D)).astype(np.float32)
    w = rng.normal(size=D).astype(np.float32) * 0.5
    z = x @ w
    if task == "LOGISTIC_REGRESSION":
        labels = 2 * (rng.random(n) < 1 / (1 + np.exp(-z))).astype(int) - 1
    else:
        labels = z + rng.normal(size=n).astype(np.float32)
    with open(path, "w") as f:
        for i in range(n):
            cols = np.nonzero(rng.random(D) < 0.7)[0]  # sparse rows
            feats = " ".join(f"{j + 1}:{x[i, j]:.5f}" for j in cols)
            f.write(f"{labels[i]} {feats}\n")


@pytest.fixture(params=["LOGISTIC_REGRESSION", "LINEAR_REGRESSION"])
def task_dirs(request, tmp_path):
    task = request.param
    for name, n, seed in (("train", 300, 1), ("validate", 120, 2)):
        (tmp_path / name).mkdir()
        _write_libsvm(tmp_path / name / "part-0.txt", n, seed, task)
    return task, tmp_path


def _argv(tmp_path, task, out, *extra):
    return [
        "--training-data-directory", str(tmp_path / "train"),
        "--validating-data-directory", str(tmp_path / "validate"),
        "--output-directory", str(tmp_path / out),
        "--task", task, "--input-file-format", "LIBSVM",
        "--feature-dimension", str(D),
        "--regularization-weights", "0.1,1,10", "--regularization-type", "L2",
        "--normalization-type", "STANDARDIZATION", "--compute-variance", "true",
        "--convergence-tolerance", "1e-7",
        *extra,
    ]


def test_driver_matches_jax_driver(task_dirs):
    _check_drivers_agree(*task_dirs)


def test_tron_driver_matches_jax_driver(task_dirs):
    _check_drivers_agree(*task_dirs, "--optimizer", "TRON")


def _check_drivers_agree(task, tmp, *extra):
    jd = jdriver.main(_argv(tmp, task, "jax", *extra))
    td = tdriver.main(_argv(tmp, task, "torch", "--device", "cpu", *extra))

    assert td.stage == tdriver.DriverStage.VALIDATED
    assert td.best_reg_weight == jd.best_reg_weight
    assert sorted(td.validation_metrics) == sorted(jd.validation_metrics)
    for lam, jm in jd.validation_metrics.items():
        tm = td.validation_metrics[lam]
        assert sorted(tm) == sorted(jm)
        keys = sorted(jm)
        assert_allclose([tm[k] for k in keys], [jm[k] for k in keys], kind="solver",
                        dtype=np.float32, err_msg=f"lambda={lam}")

    for sub in ("output", "best"):
        jm, tm = jread(str(tmp / "jax" / sub)), jread(str(tmp / "torch" / sub))
        assert tread(str(tmp / "jax" / sub)) == jm  # the port reads the JAX layout too
        assert sorted(tm) == sorted(jm)
        for lam in jm:
            assert sorted(tm[lam]) == sorted(jm[lam])
            keys = sorted(jm[lam])
            assert_allclose([tm[lam][k] for k in keys], [jm[lam][k] for k in keys],
                            kind="solver", dtype=np.float32, err_msg=f"{sub} lambda={lam}")
    assert sorted(os.listdir(tmp / "torch" / "output")) == sorted(os.listdir(tmp / "jax" / "output"))
    with open(tmp / "torch" / "photon-ml-tpu.log") as f:
        log = f.read()
    assert "lambda=10: value=" in log and "best model: lambda=" in log


OUT_OF_SLICE = [
    (["--persistent-cache", "cache"], "--persistent-cache"),
]


@pytest.mark.parametrize("extra,flag", OUT_OF_SLICE, ids=[f for _, f in OUT_OF_SLICE])
def test_out_of_slice_flag_raises(tmp_path, extra, flag):
    argv = _argv(tmp_path, "LOGISTIC_REGRESSION", "out", "--device", "cpu", *extra)
    with pytest.raises(ValueError, match="not yet ported") as err:
        tdriver.main(argv)
    assert flag in str(err.value)


def test_avro_input_and_sparse_width_raise(tmp_path):
    argv = _argv(tmp_path, "LOGISTIC_REGRESSION", "out", "--device", "cpu")
    (tmp_path / "train").mkdir()
    (tmp_path / "validate").mkdir()
    _write_libsvm(tmp_path / "train" / "a.txt", 16, 0, "LOGISTIC_REGRESSION")
    _write_libsvm(tmp_path / "validate" / "a.txt", 16, 0, "LOGISTIC_REGRESSION")
    wide = [a if a != str(D) else "5000" for a in argv]
    driver = tdriver.main(wide)  # the sparse layout is ported: no refusal
    assert isinstance(driver.train_batch.features, SparseFeatures)
    assert driver.train_batch.dim == 5001


def _write_wide_libsvm(path, n, seed, dim, nnz):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=dim).astype(np.float32)
    with open(path, "w") as f:
        for _ in range(n):
            cols = np.sort(rng.choice(dim, size=nnz, replace=False))
            vals = rng.normal(size=nnz).astype(np.float32)
            label = 1 if rng.random() < 1 / (1 + np.exp(-(vals * w[cols]).sum())) else -1
            f.write(f"{label} " + " ".join(f"{c + 1}:{v:.5f}" for c, v in zip(cols, vals)) + "\n")


@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_sparse_width_driver_matches_jax_driver(tmp_path, optimizer):
    """D=5000 > DENSE_DIM_THRESHOLD: both drivers take the padded-COO layout."""
    for name, n, seed in (("train", 400, 11), ("validate", 160, 12)):
        (tmp_path / name).mkdir()
        _write_wide_libsvm(tmp_path / name / "part-0.txt", n, seed, 5000, 12)
    argv = [a if a != str(D) else "5000"
            for a in _argv(tmp_path, "LOGISTIC_REGRESSION", "{out}", "--optimizer", optimizer)]
    jd = jdriver.main([a.replace("{out}", "jax") for a in argv])
    td = tdriver.main([a.replace("{out}", "torch") for a in argv] + ["--device", "cpu"])
    assert type(td.train_batch.features).__name__ == type(jd.train_batch.features).__name__
    assert isinstance(td.train_batch.features, SparseFeatures)
    assert td.best_reg_weight == jd.best_reg_weight
    for lam, jm in jd.validation_metrics.items():
        keys = sorted(jm)
        assert_allclose([td.validation_metrics[lam][k] for k in keys], [jm[k] for k in keys],
                        kind="solver", dtype=np.float32, err_msg=f"lambda={lam}")
    for (lam, tm), (jlam, jm) in zip(td.models, jd.models):
        assert lam == jlam
        assert_allclose(tm.coefficients.means.numpy(), np.asarray(jm.coefficients.means),
                        kind="solver", err_msg=f"lambda={lam}")


@pytest.mark.parametrize("extra,message", [
    (["--optimizer", "TRON", "--regularization-type", "L1"], "TRON optimizer does not support L1"),
    (["--optimizer", "TRON", "--regularization-type", "ELASTIC_NET"],
     "TRON optimizer does not support ELASTIC_NET"),
])
def test_tron_refuses_l1_as_the_jax_driver_does(tmp_path, extra, message):
    argv = _argv(tmp_path, "LOGISTIC_REGRESSION", "out", *extra)
    with pytest.raises(ValueError, match=message):
        jdriver.main(argv)
    with pytest.raises(ValueError, match=message):
        tdriver.main(argv + ["--device", "cpu"])


def test_tron_refuses_the_smoothed_hinge(tmp_path):
    argv = _argv(tmp_path, "SMOOTHED_HINGE_LOSS_LINEAR_SVM", "out", "--device", "cpu",
                 "--optimizer", "TRON")
    with pytest.raises(ValueError, match="first-order only"):
        tdriver.main(argv)


# --- Avro input, selected features, summaries, off-heap maps ---


def _io(tmp, out):
    return ["--training-data-directory", str(tmp / "train"),
            "--validating-data-directory", str(tmp / "validate"),
            "--output-directory", str(tmp / out)]


def _run_both(tmp, tag, flags):
    jd = jdriver.main(_io(tmp, f"jax-{tag}") + flags)
    td = tdriver.main(_io(tmp, f"torch-{tag}") + flags + ["--device", "cpu"])
    return jd, td, tmp / f"jax-{tag}", tmp / f"torch-{tag}"


def _assert_same_models(jd, td, jdir, tdir):
    """The same output/ and best/ files. Each lambda's objective agrees at
    ``solver``, and so do its coefficients where both solves stopped at the
    same iteration for the same reason: f32 stopping tests pin objectives,
    not coefficients, and a one-step function-value stop can fire in one
    package and not the other (ROADMAP Queue 3). A best lambda that differs
    must be a tie of the selection metric within ``solver`` in both."""
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for sub in ("output", "best"):
        assert sorted(os.listdir(tdir / sub)) == sorted(os.listdir(jdir / sub))
    same_stop = set()
    for lam, jr, tr in zip(jd.trained.weights, jd.trained.results, td.trained.results):
        assert_allclose(float(tr.value), float(jr.value), kind="solver", dtype=np.float32,
                        err_msg=f"lambda={lam} objective")
        if (int(tr.iterations), int(tr.reason)) == (int(jr.iterations), int(jr.reason)):
            same_stop.add(lam)
    assert same_stop, "no lambda stopped alike: no coefficients were compared"
    jm, tm = jread(str(jdir / "output")), jread(str(tdir / "output"))
    assert sorted(tm) == sorted(jm)
    for lam in jm:
        keys = sorted(jm[lam])
        assert sorted(tm[lam]) == keys
        if lam in same_stop:
            assert_allclose([tm[lam][k] for k in keys], [jm[lam][k] for k in keys],
                            kind="solver", dtype=np.float32, err_msg=f"output lambda={lam}")
    if td.best_reg_weight != jd.best_reg_weight:
        metric = selection_metric_for(td.params.task_type)
        for d in (jd, td):
            picks = [d.validation_metrics[lam][metric]
                     for lam in (jd.best_reg_weight, td.best_reg_weight)]
            assert_allclose(picks[0], picks[1], kind="solver", dtype=np.float32,
                            err_msg="best lambdas that are not a tie")
    assert jread(str(tdir / "best")) == {td.best_reg_weight: tm[td.best_reg_weight]}


def _write_glm_avro(path, n, seed, names):
    """TrainingExampleAvro rows over the named features, with weights and
    offsets."""
    from photon_ml_tpu.io import avro as javro
    from photon_ml_tpu.io import schemas

    rng = np.random.default_rng(seed)
    w = np.random.default_rng(99).normal(size=len(names)) * 0.7
    recs = []
    for i in range(n):
        cols = np.nonzero(rng.random(len(names)) < 0.6)[0]
        vals = rng.normal(size=len(cols))
        z = float(vals @ w[cols])
        recs.append({"uid": str(i), "label": float(rng.random() < 1 / (1 + np.exp(-z))),
                     "features": [{"name": names[c][0], "term": names[c][1], "value": float(v)}
                                  for c, v in zip(cols, vals)],
                     "metadataMap": None, "weight": float(rng.uniform(0.5, 2.0)),
                     "offset": float(rng.normal() * 0.1)})
    os.makedirs(os.path.dirname(path), exist_ok=True)
    javro.write_container(str(path), recs, schemas.TRAINING_EXAMPLE)


AVRO_NAMES = [(f"f{j}", "" if j % 3 else f"t{j % 2}") for j in range(16)]


@pytest.fixture(scope="module")
def avro_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("avro")
    _write_glm_avro(root / "train" / "part-00000.avro", 500, 31, AVRO_NAMES)
    _write_glm_avro(root / "train" / "part-00001.avro", 300, 32, AVRO_NAMES)
    _write_glm_avro(root / "validate" / "part-00000.avro", 200, 33, AVRO_NAMES)
    return root


AVRO_FLAGS = ["--task", "LOGISTIC_REGRESSION", "--regularization-weights", "0.5,5",
              "--normalization-type", "STANDARDIZATION", "--convergence-tolerance", "1e-7"]


@pytest.mark.parametrize("listing", ["text", "avro"])
def test_avro_input_with_selected_features_and_summaries_matches_jax_driver(avro_dirs, listing):
    """The default --input-file-format AVRO, a --selected-features-file
    naming half the features (text lines 'name', 'name<TAB>term' and
    'name\\x01term', or FeatureAvro records) and --summarization-output-dir."""
    chosen = AVRO_NAMES[::2]
    path = avro_dirs / f"selected-{listing}"
    if listing == "text":
        lines = [n if not t else (f"{n}\t{t}" if i % 2 else f"{n}\x01{t}")
                 for i, (n, t) in enumerate(chosen)]
        path.write_text("\n".join(lines) + "\n")
    else:
        from photon_ml_tpu.io import avro as javro
        from photon_ml_tpu.io import schemas

        path = avro_dirs / "selected.avro"
        javro.write_container(str(path), [{"name": n, "term": t, "value": 0.0} for n, t in chosen],
                              schemas.FEATURE)
    flags = AVRO_FLAGS + ["--selected-features-file", str(path),
                          "--summarization-output-dir", "{out}/summary"]
    jd = jdriver.main(_io(avro_dirs, f"jax-{listing}")
                      + [f.replace("{out}", str(avro_dirs / f"jsum-{listing}")) for f in flags])
    td = tdriver.main(_io(avro_dirs, f"torch-{listing}")
                      + [f.replace("{out}", str(avro_dirs / f"tsum-{listing}")) for f in flags]
                      + ["--device", "cpu"])
    assert td.index_map.index_to_name == jd.index_map.index_to_name
    assert len(td.index_map) == len(chosen) + 1  # the chosen half and the intercept
    assert td.train_batch.num_rows == jd.train_batch.num_rows
    _assert_same_models(jd, td, avro_dirs / f"jax-{listing}", avro_dirs / f"torch-{listing}")
    from photon_ml_tpu.io.avro import read_container

    jrec = list(read_container(str(avro_dirs / f"jsum-{listing}" / "summary" / "part-00000.avro")))
    trec = list(read_container(str(avro_dirs / f"tsum-{listing}" / "summary" / "part-00000.avro")))
    assert [(r["featureName"], r["featureTerm"], sorted(r["metrics"])) for r in trec] == \
        [(r["featureName"], r["featureTerm"], sorted(r["metrics"])) for r in jrec]
    for t, j in zip(trec, jrec):
        keys = sorted(j["metrics"])
        assert_allclose([t["metrics"][k] for k in keys], [j["metrics"][k] for k in keys],
                        kind="elementwise", dtype=np.float32)
    # The f32 records differ only by the order of the column sums: on the
    # same batch in float64 both packages' statistics agree to 1e-12.
    j64, t64 = _summaries_in_f64(jd.train_batch, td.train_batch)
    for field in ("mean", "variance", "norm_l1", "norm_l2", "num_nonzeros", "max", "min"):
        np.testing.assert_allclose(t64[field], j64[field], rtol=1e-12, atol=1e-12, err_msg=field)


def _summaries_in_f64(jbatch, tbatch):
    import jax
    import jax.numpy as jnp
    import torch

    from photon_ml_tpu.ops.features import DenseFeatures as JDense
    from photon_ml_tpu.ops.objective import GLMBatch as JBatch
    from photon_ml_tpu.ops.stats import summarize as jsummarize
    from photon_ml_tpu_torch.ops.features import DenseFeatures
    from photon_ml_tpu_torch.ops.objective import GLMBatch
    from photon_ml_tpu_torch.ops.stats import summarize

    fields = ("mean", "variance", "norm_l1", "norm_l2", "num_nonzeros", "max", "min")
    x = np.asarray(jbatch.features.to_dense(), np.float64)
    wt = np.asarray(jbatch.weights, np.float64)
    np.testing.assert_array_equal(tbatch.features.to_dense().numpy(), x.astype(np.float32))
    with jax.enable_x64(True):
        js = jsummarize(JBatch(JDense(jnp.asarray(x)), jnp.zeros(len(wt)), jnp.zeros(len(wt)),
                               jnp.asarray(wt)))
        j64 = {f: np.asarray(getattr(js, f)) for f in fields}
    ts = summarize(GLMBatch(DenseFeatures(torch.from_numpy(x)), torch.zeros(len(wt), dtype=torch.float64),
                            torch.zeros(len(wt), dtype=torch.float64), torch.from_numpy(wt)))
    t64 = {f: getattr(ts, f).numpy() for f in fields}
    assert all(v.dtype == np.float64 for v in (*j64.values(), *t64.values()))
    return j64, t64


def test_summary_files_byte_equal_where_column_sums_are_exact(tmp_path):
    """Small integer features make every f32 column sum exact in any order,
    and then the two packages' summary files are byte-equal: their
    statistics and writers agree, and only summation order separates the
    drivers' records on real-valued data."""
    import jax.numpy as jnp
    import torch

    from photon_ml_tpu.io.index_map import IndexMap as JIndexMap
    from photon_ml_tpu.ops.features import DenseFeatures as JDense
    from photon_ml_tpu.ops.objective import GLMBatch as JBatch
    from photon_ml_tpu.ops.stats import summarize as jsummarize
    from photon_ml_tpu.utils.io_utils import write_basic_statistics as jwrite
    from photon_ml_tpu_torch.io.index_map import IndexMap
    from photon_ml_tpu_torch.ops.features import DenseFeatures
    from photon_ml_tpu_torch.ops.objective import GLMBatch
    from photon_ml_tpu_torch.ops.stats import summarize
    from photon_ml_tpu_torch.utils.io_utils import write_basic_statistics as twrite

    rng = np.random.default_rng(5)
    x = rng.integers(-8, 9, size=(512, 6)).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = 0.0
    wt = np.ones(512, np.float32)
    wt[-7:] = 0.0
    keys = [f"g{j}\x01t{j % 2}" for j in range(6)]
    zeros = np.zeros(512, np.float32)
    jwrite(jsummarize(JBatch(JDense(jnp.asarray(x)), jnp.asarray(zeros), jnp.asarray(zeros),
                             jnp.asarray(wt))),
           str(tmp_path / "jax"), JIndexMap.build(keys, add_intercept=False))
    twrite(summarize(GLMBatch(DenseFeatures(torch.from_numpy(x)), torch.from_numpy(zeros),
                              torch.from_numpy(zeros), torch.from_numpy(wt))),
           str(tmp_path / "torch"), IndexMap.build(keys, add_intercept=False))
    assert (tmp_path / "torch" / "part-00000.avro").read_bytes() == \
        (tmp_path / "jax" / "part-00000.avro").read_bytes()


def test_offheap_index_map_matches_jax_driver(avro_dirs):
    from photon_ml_tpu_torch.io.avro_data import collect_feature_keys
    from photon_ml_tpu_torch.io.offheap import OffHeapIndexMap, build_offheap_store

    store = avro_dirs / "store"
    build_offheap_store(str(store), collect_feature_keys(
        [str(p) for p in sorted((avro_dirs / "train").iterdir())]), num_partitions=4)
    jd, td, jdir, tdir = _run_both(avro_dirs, "offheap",
                                   AVRO_FLAGS + ["--offheap-indexmap-dir", str(store)])
    assert isinstance(td.index_map, OffHeapIndexMap)
    names = [td.index_map.get_feature_name(i) for i in range(len(td.index_map))]
    assert names == [jd.index_map.get_feature_name(i) for i in range(len(jd.index_map))]
    assert len(names) == len(AVRO_NAMES) + 1
    _assert_same_models(jd, td, jdir, tdir)


def test_diagnostic_mode_requires_validation_data(tmp_path):
    argv = ["--training-data-directory", str(tmp_path), "--output-directory", str(tmp_path / "o"),
            "--task", "LOGISTIC_REGRESSION", "--diagnostic-mode", "VALIDATE", "--device", "cpu"]
    with pytest.raises(ValueError, match="requires --validating-data-directory"):
        tdriver.main(argv)
