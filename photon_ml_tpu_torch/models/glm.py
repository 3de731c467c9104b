"""Generalized linear models: coefficients + per-task mean functions (port of
photon_ml_tpu/models/glm.py).

Reference spec: model/Coefficients.scala:27-85 and
supervised/model/GeneralizedLinearModel.scala:31-145 (logistic sigmoid,
linear identity, Poisson exp, smoothed-hinge SVM raw margin).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_tpu_torch.ops import losses as losses_mod
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMBatch
from photon_ml_tpu_torch.types import TaskType

Tensor = torch.Tensor


@dataclasses.dataclass
class Coefficients:
    """(means, optional variances) — Coefficients.scala:27 parity."""

    means: Tensor  # (D,)
    variances: Optional[Tensor] = None

    @property
    def dim(self) -> int:
        return self.means.shape[-1]


@dataclasses.dataclass
class GeneralizedLinearModel:
    coefficients: Coefficients
    task: TaskType = TaskType.LOGISTIC_REGRESSION

    def compute_margins(self, batch: GLMBatch,
                        norm: Optional[NormalizationContext] = None) -> Tensor:
        w = self.coefficients.means
        if norm is not None and not norm.is_identity:
            w_eff = norm.effective_coefficients(w)
            return batch.features.matvec(w_eff) + norm.margin_shift(w_eff) + batch.offsets
        return batch.features.matvec(w) + batch.offsets

    def compute_mean_functions(self, batch: GLMBatch,
                               norm: Optional[NormalizationContext] = None) -> Tensor:
        """Mean prediction with offset (computeMeanFunctionWithOffset parity)."""
        return losses_mod.for_task(self.task).mean(self.compute_margins(batch, norm))

    def means_as_numpy(self):
        return self.coefficients.means.detach().cpu().numpy()
