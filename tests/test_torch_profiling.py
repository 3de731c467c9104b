"""``utils/profiling.maybe_trace`` (CPU): a no-op without
``PHOTON_ML_TPU_PROFILE``; with it, a ``torch.profiler`` trace of the
stage, as the JAX package's hook writes a ``jax.profiler`` one, and the
GAME driver's train stage traced under the JAX driver's stage name."""

import json
import os

import torch

from photon_ml_tpu_torch.utils import profiling


def test_no_env_is_a_no_op(monkeypatch, tmp_path):
    monkeypatch.delenv("PHOTON_ML_TPU_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.maybe_trace("glm-train"):
        torch.ones(3).sum()
    assert profiling.profile_dir() is None and os.listdir(tmp_path) == []


def test_env_traces_the_stage(monkeypatch, tmp_path):
    monkeypatch.setenv("PHOTON_ML_TPU_PROFILE", str(tmp_path))
    with profiling.maybe_trace("game-combo-0"):
        (torch.arange(64.0).reshape(8, 8) @ torch.ones(8)).sum()
    stage = tmp_path / "game-combo-0"
    assert sorted(os.listdir(stage)) == ["kernels.txt", "trace.json"]
    events = json.loads((stage / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "aten::matmul" for e in events)
    assert "aten::matmul" in (stage / "kernels.txt").read_text()
