"""Per-task dataset sanity checks (port of photon_ml_tpu/data/validators.py).

Reference spec: data/DataValidators.scala — finite labels/features/offsets,
binary labels for logistic and smoothed hinge, non-negative labels for
Poisson. VALIDATE_FULL checks every row, VALIDATE_SAMPLE a 10% subsample
(rows chosen by numpy with the JAX package's seed), VALIDATE_DISABLED skips.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from photon_ml_tpu_torch.ops.features import DenseFeatures, SparseFeatures
from photon_ml_tpu_torch.ops.objective import GLMBatch
from photon_ml_tpu_torch.types import DataValidationType, TaskType


def _finite(a: torch.Tensor) -> bool:
    return bool(torch.all(torch.isfinite(a)))


def finite_labels(batch: GLMBatch) -> bool:
    return _finite(batch.labels)


def finite_offsets(batch: GLMBatch) -> bool:
    return _finite(batch.offsets)


def finite_features(batch: GLMBatch) -> bool:
    feats = batch.features
    return _finite(feats.matrix if isinstance(feats, DenseFeatures) else feats.values)


def binary_labels(batch: GLMBatch) -> bool:
    return bool(torch.all((batch.labels == 0.0) | (batch.labels == 1.0)))


def non_negative_labels(batch: GLMBatch) -> bool:
    return bool(torch.all(batch.labels >= 0.0))


def validators_for(task: TaskType) -> Dict[str, object]:
    common = {"Finite features": finite_features, "Finite offsets": finite_offsets}
    if task == TaskType.LINEAR_REGRESSION:
        return {"Finite labels": finite_labels, **common}
    if task == TaskType.POISSON_REGRESSION:
        return {"Finite labels": finite_labels, "Non-negative labels": non_negative_labels, **common}
    return {"Binary labels": binary_labels, **common}


def _subsample(batch: GLMBatch, fraction: float, seed: int = 42) -> GLMBatch:
    rng = np.random.default_rng(seed)
    idx = np.nonzero(rng.random(batch.num_rows) < fraction)[0]
    if idx.size == 0:
        idx = np.array([0])
    rows = torch.from_numpy(idx).to(batch.device)
    take = lambda a: a[rows]
    feats = batch.features
    if isinstance(feats, DenseFeatures):
        feats = DenseFeatures(take(feats.matrix))
    else:
        # the transpose layout covers every row; a row sample drops it
        feats = SparseFeatures(take(feats.indices), take(feats.values), feats.dim)
    return GLMBatch(feats, take(batch.labels), take(batch.offsets), take(batch.weights))


def sanity_check_data(batch: GLMBatch, task: TaskType,
                      validation_type: DataValidationType = DataValidationType.VALIDATE_FULL) -> None:
    """Raise ValueError listing every failed check (Driver.scala:191-193 use)."""
    if validation_type == DataValidationType.VALIDATE_DISABLED:
        return
    if validation_type == DataValidationType.VALIDATE_SAMPLE:
        batch = _subsample(batch, 0.10)
    failed: List[str] = [name for name, fn in validators_for(task).items() if not fn(batch)]
    if failed:
        raise ValueError(f"data validation failed for {task.value}: {', '.join(failed)}")
