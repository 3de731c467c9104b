"""The port's GLM driver against the JAX driver end to end (CPU): the same
tiny LIBSVM train/validate pair through both ``main([...])``, LBFGS over a
3-lambda grid with STANDARDIZATION. Per-lambda text models and validation
metrics at the ``solver`` tolerance, the same best lambda, and each
package's text models read by the other's reader (one on-disk layout).
"""

import os

import numpy as np
import pytest

from photon_ml_tpu.cli import glm_driver as jdriver
from photon_ml_tpu.utils.io_utils import read_models_from_text as jread
from photon_ml_tpu_torch.cli import glm_driver as tdriver
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
    (["--selected-features-file", "features.txt"], "--selected-features-file"),
    (["--streaming-chunk-rows", "64"], "--streaming-chunk-rows"),
    (["--diagnostic-mode", "VALIDATE"], "--diagnostic-mode VALIDATE"),
    (["--coefficient-box-constraints", "[]"], "--coefficient-box-constraints"),
    (["--tensor-cache", "cache"], "--tensor-cache"),
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
    avro = [a if a != "LIBSVM" else "AVRO" for a in argv]
    with pytest.raises(ValueError, match="--input-file-format AVRO is not yet ported"):
        tdriver.main(avro)
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
