"""GLM optimization problems: objective + optimizer + regularization (port of
photon_ml_tpu/optim/problem.py).

Reference spec: optimization/GeneralizedLinearOptimizationProblem.scala:42-279
and OptimizerFactory.scala:49-70. LBFGS accepts any once-differentiable loss
(L1/elastic net switch it to OWL-QN). TRON is not yet ported. Variances are
1 / diag(Hessian) as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.ops import losses as losses_mod
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMBatch, GLMObjective
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optim.common import OptimizerConfig, OptResult
from photon_ml_tpu_torch.optim.lbfgs import lbfgs_minimize_lanes
from photon_ml_tpu_torch.types import OptimizerType, RegularizationType, TaskType, real_dtype

Tensor = torch.Tensor


def variances_from_hessian_diag(diag: Tensor) -> Tensor:
    """variance = 1/H_jj with the shared numerical floor."""
    return 1.0 / torch.clamp_min(diag, 1e-12)


def _split_reg_weight(reg: RegularizationContext, reg_weight) -> Tuple[float, float]:
    """Split a total regularization weight into (l1, l2) per the context's
    type; ``reg_weight=None`` uses the context's own weight."""
    if reg_weight is None:
        return reg.l1_weight, reg.l2_weight
    if reg.reg_type == RegularizationType.L1:
        return reg_weight, 0.0
    if reg.reg_type == RegularizationType.L2:
        return 0.0, reg_weight
    if reg.reg_type == RegularizationType.ELASTIC_NET:
        a = reg.elastic_net_alpha
        return a * reg_weight, (1.0 - a) * reg_weight
    return 0.0, 0.0


@dataclasses.dataclass(frozen=True)
class GLMOptimizationProblem:
    """Static problem description; ``run`` solves it on a batch."""

    task: TaskType
    optimizer: OptimizerType = OptimizerType.LBFGS
    # None -> the reference defaults (LBFGS 80 iterations / 1e-7)
    optimizer_config: Optional[OptimizerConfig] = None
    regularization: RegularizationContext = dataclasses.field(
        default_factory=RegularizationContext.none
    )
    compute_variance: bool = False
    # rows per tile of the fused value+grad kernel, set by
    # ops.fused_glm.select_fused_block_rows; None = the plain two-pass path
    fused_block_rows: Optional[int] = None
    # carry per-iteration coefficient snapshots through the solve (the
    # ModelTracker analogue backing --validate-per-iteration)
    track_coefficients: bool = False

    def __post_init__(self):
        if self.optimizer == OptimizerType.TRON:
            raise ValueError("--optimizer TRON is not yet ported to photon_ml_tpu_torch")
        if self.optimizer_config is None:
            object.__setattr__(self, "optimizer_config", OptimizerConfig.lbfgs_default())

    @property
    def objective(self) -> GLMObjective:
        return GLMObjective(losses_mod.for_task(self.task), self.fused_block_rows)

    def run(
        self,
        batch: GLMBatch,
        norm: NormalizationContext,
        init_coefficients: Optional[Tensor] = None,
        reg_weight: Optional[float] = None,
    ) -> Tuple[GeneralizedLinearModel, OptResult]:
        """Solve on ``batch`` (on its device); returns (model, solve result).

        ``reg_weight`` overrides the context's total weight (the
        updateObjective analogue for lambda sweeps).
        """
        obj = self.objective
        l1, l2 = _split_reg_weight(self.regularization, reg_weight)
        w0 = (
            init_coefficients
            if init_coefficients is not None
            else torch.zeros((batch.dim,), dtype=real_dtype(), device=batch.device)
        )

        def lane_vg(w_lanes):
            vals, grads = zip(*(obj.value_and_grad(w, batch, norm, l2) for w in w_lanes))
            return torch.stack(vals), torch.stack(grads)

        res = lbfgs_minimize_lanes(
            lane_vg, w0[None], self.optimizer_config, l1_weight=l1,
            track_coefficients=self.track_coefficients,
        )
        result = OptResult(*(None if f is None else f[0] for f in res))
        w = result.coefficients
        variances = None
        if self.compute_variance:
            variances = variances_from_hessian_diag(obj.hessian_diagonal(w, batch, norm, l2))
        return GeneralizedLinearModel(Coefficients(w, variances), self.task), result
