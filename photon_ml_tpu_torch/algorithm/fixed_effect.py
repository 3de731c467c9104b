"""Fixed-effect coordinate: one GLM solve over all rows (port of
photon_ml_tpu/algorithm/fixed_effect.py).

Reference spec: algorithm/FixedEffectCoordinate.scala:33-176 — update =
(down-sample, then) solve on the full data with residual offsets; score =
the dense product with the model. Down-sampling zeroes the weights of the
dropped rows (``data/sampler.py``) with the same seeded draws every update.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from photon_ml_tpu_torch.data.sampler import maybe_down_sample
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMBatch
from photon_ml_tpu_torch.optim.common import OptResult
from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem, variances_from_hessian_diag
from photon_ml_tpu_torch.types import real_dtype

Tensor = torch.Tensor

# The down-sampler's key: every update redraws PRNGKey(7), as the JAX
# package's FixedEffectCoordinate does.
DOWN_SAMPLING_SEED = 7


@dataclasses.dataclass
class FixedEffectCoordinate:
    """Couples a fixed-effect batch with its optimization problem."""

    batch: GLMBatch
    problem: GLMOptimizationProblem
    norm: NormalizationContext = dataclasses.field(default_factory=NormalizationContext.identity)
    down_sampling_rate: Optional[float] = None

    @property
    def dim(self) -> int:
        return self.batch.dim

    def initial_coefficients(self) -> Tensor:
        return torch.zeros((self.dim,), dtype=real_dtype(), device=self.batch.device)

    def _residual_batch(self, residual_offsets: Tensor) -> GLMBatch:
        b = self.batch
        return GLMBatch(b.features, b.labels, b.offsets + residual_offsets, b.weights)

    def update(self, residual_offsets: Tensor, init_coefficients: Tensor,
               reg_weight: Optional[float] = None) -> Tuple[Tensor, OptResult]:
        """Solve on residuals: offsets = base + the other coordinates'
        scores (Coordinate.scala:43-49); ``reg_weight`` overrides the
        problem's total regularization weight (the lambda grid)."""
        batch = maybe_down_sample(self._residual_batch(residual_offsets), self.problem.task,
                                  self.down_sampling_rate, DOWN_SAMPLING_SEED)
        model, result = self.problem.run(batch, self.norm, init_coefficients,
                                         reg_weight=reg_weight)
        return model.coefficients.means, result

    def score(self, coefficients: Tensor) -> Tensor:
        """Raw margins x.w (no offset, no mean function): GAME scores are
        additive margin contributions (FixedEffectModel.scala:91-100)."""
        w_eff = self.norm.effective_coefficients(coefficients)
        return self.batch.features.matvec(w_eff) + self.norm.margin_shift(w_eff)

    def coefficient_variances(self, coefficients: Tensor, residual_offsets: Tensor) -> Tensor:
        """1/diag(H) at the final coefficients on the residual-offset batch."""
        l2 = self.problem.regularization.l2_weight
        diag = self.problem.objective.hessian_diagonal(
            coefficients, self._residual_batch(residual_offsets), self.norm, l2
        )
        return variances_from_hessian_diag(diag)

    def regularization_term(self, coefficients: Tensor,
                            reg_weight: Optional[float] = None) -> Tensor:
        return self.problem.regularization_term_value(coefficients, reg_weight)
