"""The PyTorch port stands alone: importing any of its modules loads neither
jax nor the JAX package, no file of it names either, and asking for the card
where there is none raises instead of running on the CPU."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import photon_ml_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.join(REPO, "photon_ml_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "photon_ml_tpu")


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(photon_ml_tpu_torch.__path__, "photon_ml_tpu_torch.")
    )


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"mods = {_modules()!r}\n"
        "before = set(sys.modules)\n"
        "for m in mods: importlib.import_module(m)\n"
        "new = sorted(k for k in set(sys.modules) - before\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'photon_ml_tpu'))\n"
        "print(len(mods), new)\n"
        "assert not new, new\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 121  # every module was imported
    for mod in ("photon_ml_tpu_torch.ops.fused_sparse", "photon_ml_tpu_torch.optim.tron",
                "photon_ml_tpu_torch.data.game", "photon_ml_tpu_torch.algorithm.random_effect",
                "photon_ml_tpu_torch.algorithm.coordinate_descent",
                "photon_ml_tpu_torch.io.avro_data", "photon_ml_tpu_torch.io.model_io",
                "photon_ml_tpu_torch.cli.game_training_driver",
                "photon_ml_tpu_torch.io.avro_native", "photon_ml_tpu_torch.io.offheap",
                "photon_ml_tpu_torch.io.name_and_term", "photon_ml_tpu_torch.projectors",
                "photon_ml_tpu_torch.resilience", "photon_ml_tpu_torch.resilience.retry",
                "photon_ml_tpu_torch.utils.date_range", "photon_ml_tpu_torch.cli.feature_indexing",
                "photon_ml_tpu_torch.cli.game_scoring_driver", "photon_ml_tpu_torch.checkpoint",
                "photon_ml_tpu_torch.checkpoint_async", "photon_ml_tpu_torch.resilience.faults",
                "photon_ml_tpu_torch.resilience.guards", "photon_ml_tpu_torch.resilience.preemption",
                "photon_ml_tpu_torch.resilience.sites", "photon_ml_tpu_torch.retrain.manifest",
                "photon_ml_tpu_torch.optim.constraints", "photon_ml_tpu_torch.utils.prng",
                "photon_ml_tpu_torch.bootstrap", "photon_ml_tpu_torch.diagnostics.common",
                "photon_ml_tpu_torch.diagnostics.reporting", "photon_ml_tpu_torch.diagnostics.reports",
                "photon_ml_tpu_torch.diagnostics.avro_reports",
                "photon_ml_tpu_torch.diagnostics.feature_importance",
                "photon_ml_tpu_torch.diagnostics.independence",
                "photon_ml_tpu_torch.diagnostics.hosmer_lemeshow",
                "photon_ml_tpu_torch.diagnostics.fitting",
                "photon_ml_tpu_torch.diagnostics.bootstrap_diagnostic",
                "photon_ml_tpu_torch.data.sampler",
                "photon_ml_tpu_torch.algorithm.factored_random_effect",
                "photon_ml_tpu_torch.algorithm.bucketed_random_effect",
                "photon_ml_tpu_torch.compile", "photon_ml_tpu_torch.compile.canonical",
                "photon_ml_tpu_torch.utils.profiling", "photon_ml_tpu_torch.compile.stats",
                "photon_ml_tpu_torch.compile.overrides", "photon_ml_tpu_torch.compile.plan",
                "photon_ml_tpu_torch.optim.scheduler", "photon_ml_tpu_torch.optim.convergence",
                "photon_ml_tpu_torch.optim.fused_schedule",
                "photon_ml_tpu_torch.serve.server", "photon_ml_tpu_torch.cli.serve_driver",
                "photon_ml_tpu_torch.parallel", "photon_ml_tpu_torch.parallel.mesh",
                "photon_ml_tpu_torch.parallel.multihost", "photon_ml_tpu_torch.parallel.shuffle",
                "photon_ml_tpu_torch.parallel.distributed",
                "photon_ml_tpu_torch.parallel.perhost_ingest",
                "photon_ml_tpu_torch.parallel.perhost_factored",
                "photon_ml_tpu_torch.parallel.elastic",
                "photon_ml_tpu_torch.cli.game_multihost_driver",
                "photon_ml_tpu_torch.cli.game_multihost_scoring_driver"):
        assert mod in _modules()


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_of_the_package_imports_jax_or_the_jax_package():
    offenders = []
    for root, _, files in os.walk(PKG_DIR):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
                if bad:
                    offenders.append((os.path.relpath(path, REPO), bad))
    assert not offenders, offenders


def test_cuda_requested_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the no-card refusal cannot be exercised")
    from photon_ml_tpu_torch.cli import glm_driver
    from photon_ml_tpu_torch.device import resolve_device
    from photon_ml_tpu_torch.io.libsvm import HostDataset, to_batch

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)  # the default is the card
    ds = HostDataset(np.zeros(2, np.float32), np.array([0, 1, 2]), np.array([0, 0], np.int32),
                     np.ones(2, np.float32), 1)
    with pytest.raises(RuntimeError, match="cuda"):
        to_batch(ds)
    train = tmp_path / "train.txt"
    train.write_text("1 1:0.5\n0 1:-0.5\n")
    with pytest.raises(RuntimeError, match="cuda"):
        glm_driver.main([
            "--training-data-directory", str(train), "--output-directory", str(tmp_path / "out"),
            "--task", "LOGISTIC_REGRESSION", "--input-file-format", "LIBSVM",
        ])
    assert not (tmp_path / "out").exists()  # nothing ran on the CPU instead


def test_game_driver_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the no-card refusal cannot be exercised")
    from photon_ml_tpu_torch.cli import game_training_driver

    with pytest.raises(RuntimeError, match="cuda"):
        game_training_driver.main([
            "--train-input-dirs", str(tmp_path), "--output-dir", str(tmp_path / "out"),
            "--task-type", "LOGISTIC_REGRESSION", "--updating-sequence", "fixed",
            "--fixed-effect-data-configurations", "fixed:global,1",
        ])
    assert not (tmp_path / "out").exists()


def test_scoring_driver_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the no-card refusal cannot be exercised")
    from photon_ml_tpu_torch.cli import game_scoring_driver

    with pytest.raises(RuntimeError, match="cuda"):
        game_scoring_driver.main([
            "--input-dirs", str(tmp_path), "--game-model-input-dir", str(tmp_path),
            "--output-dir", str(tmp_path / "out"),
        ])
    assert not (tmp_path / "out").exists()


def test_kernel_wrapper_refuses_cpu_tensors():
    from photon_ml_tpu_torch.ops import fused_glm, losses

    x = torch.zeros((8, 4))
    v = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        fused_glm.fused_value_grad_kernel(losses.logistic, x, v, v, v, torch.zeros(4))
    assert fused_glm.select_fused_block_rows(losses.logistic, 8, 4, torch.float32, "cpu") is None
