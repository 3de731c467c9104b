"""Deterministic mode: each entry point of the port turns on
``torch.use_deterministic_algorithms`` (and cuBLAS's fixed workspace)
before any work, and the evaluators' running sums, which replace the float
``torch.cumsum`` that mode refuses on a CUDA tensor, keep the metrics at the
JAX package's values (CPU)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from photon_ml_tpu.evaluation import evaluators as jevaluators
from photon_ml_tpu.evaluation import metrics as jmetrics
from photon_ml_tpu_torch.cli import feature_indexing, game_scoring_driver, game_training_driver
from photon_ml_tpu_torch.cli import glm_driver
from photon_ml_tpu_torch.device import enable_determinism
from photon_ml_tpu_torch.evaluation import evaluators as tevaluators
from photon_ml_tpu_torch.evaluation import metrics as tmetrics
from photon_ml_tpu_torch.evaluation.evaluators import running_sum
from test_game_drivers import COMMON_FLAGS, game_avro_dirs  # noqa: F401
from tolerances import assert_allclose


@pytest.fixture
def determinism_off(monkeypatch):
    """Each case starts with the mode off and the workspace unset, and
    leaves the process as it found it."""
    was = torch.are_deterministic_algorithms_enabled()
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    torch.use_deterministic_algorithms(False)
    yield
    torch.use_deterministic_algorithms(was)


def _assert_on():
    assert torch.are_deterministic_algorithms_enabled()
    assert not torch.is_deterministic_algorithms_warn_only_enabled()
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"


def test_enable_determinism_keeps_a_set_workspace(determinism_off, monkeypatch):
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    enable_determinism()
    assert torch.are_deterministic_algorithms_enabled()
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"


def test_every_driver_main_turns_the_mode_on(determinism_off, game_avro_dirs, tmp_path):  # noqa: F811
    train_dir, val_dir, _ = game_avro_dirs
    game_training_driver.main(["--train-input-dirs", train_dir, "--output-dir",
                               str(tmp_path / "game"), "--device", "cpu", *COMMON_FLAGS])
    _assert_on()
    torch.use_deterministic_algorithms(False)
    game_scoring_driver.main(["--input-dirs", val_dir, "--game-model-input-dir",
                              str(tmp_path / "game" / "best"), "--output-dir",
                              str(tmp_path / "scores"), "--device", "cpu",
                              "--feature-shard-id-to-feature-section-keys-map",
                              "global:fixedFeatures|per_user:userFeatures"])
    _assert_on()
    torch.use_deterministic_algorithms(False)
    feature_indexing.main(["--data-input-dirs", train_dir, "--output-dir",
                           str(tmp_path / "index"), "--feature-shard-id-to-feature-section-keys-map",
                           "global:fixedFeatures"])
    _assert_on()
    torch.use_deterministic_algorithms(False)
    (tmp_path / "train.txt").write_text("1 1:0.5 2:1\n0 1:-0.5\n1 2:0.25\n0 1:1 2:-1\n")
    glm_driver.main(["--training-data-directory", str(tmp_path / "train.txt"),
                     "--output-directory", str(tmp_path / "glm"), "--task", "LOGISTIC_REGRESSION",
                     "--input-file-format", "LIBSVM", "--device", "cpu"])
    _assert_on()


@pytest.mark.parametrize("n", [0, 1, 2, 7, 1000, 1025])
def test_running_sum_is_a_prefix_sum(n):
    x = torch.from_numpy(np.random.default_rng(n).normal(size=n))
    assert_allclose(running_sum(x).numpy(), np.cumsum(x.numpy()), kind="elementwise")


def test_metrics_with_running_sums_match_jax(rng, determinism_off):
    n = 2000
    scores = rng.normal(size=n).astype(np.float32)
    scores[:200] = np.round(scores[:200])  # ties
    labels = (rng.random(n) < 0.4).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    t = [torch.from_numpy(a) for a in (scores, labels, weights)]
    j = [jnp.asarray(a) for a in (scores, labels, weights)]
    torch.use_deterministic_algorithms(True)
    assert_allclose(tevaluators.area_under_roc_curve(*t).numpy(),
                    np.asarray(jevaluators.area_under_roc_curve(*j)), kind="elementwise")
    for fn in ("area_under_pr", "peak_f1"):
        assert_allclose(getattr(tmetrics, fn)(*t).numpy(), np.asarray(getattr(jmetrics, fn)(*j)),
                        kind="elementwise", err_msg=fn)
