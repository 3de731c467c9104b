"""GLM optimization problems: objective + optimizer + regularization (port of
photon_ml_tpu/optim/problem.py).

Reference spec: optimization/GeneralizedLinearOptimizationProblem.scala:42-279
and OptimizerFactory.scala:49-70. LBFGS accepts any once-differentiable loss
(L1/elastic net switch it to OWL-QN); TRON needs a twice-differentiable loss
and refuses L1/elastic net (Params.scala:177-180). Variances are
1 / diag(Hessian) as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.ops import losses as losses_mod
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMBatch, GLMObjective
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optim.common import OptimizerConfig, OptResult
from photon_ml_tpu_torch.optim.constraints import BoxConstraints
from photon_ml_tpu_torch.optim.lbfgs import lbfgs_minimize_lanes
from photon_ml_tpu_torch.optim.tron import tron_minimize_lanes
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
    # None -> the reference defaults (LBFGS 80 / 1e-7, TRON 15 / 1e-5)
    optimizer_config: Optional[OptimizerConfig] = None
    regularization: RegularizationContext = dataclasses.field(
        default_factory=RegularizationContext.none
    )
    compute_variance: bool = False
    # box constraints on coefficients (OptimizationUtils.projectCoefficientsToHypercube);
    # densified (lower, upper) tensors — see optim/constraints.py
    constraints: Optional[BoxConstraints] = None
    # rows per tile of the fused value+grad kernel, set by
    # ops.fused_glm.select_fused_block_rows; None = the plain two-pass path
    fused_block_rows: Optional[int] = None
    # carry per-iteration coefficient snapshots through the solve (the
    # ModelTracker analogue backing --validate-per-iteration)
    track_coefficients: bool = False

    def __post_init__(self):
        tron = self.optimizer == OptimizerType.TRON
        if self.optimizer_config is None:
            cfg = OptimizerConfig.tron_default() if tron else OptimizerConfig.lbfgs_default()
            object.__setattr__(self, "optimizer_config", cfg)
        if tron:
            if not losses_mod.for_task(self.task).twice_differentiable:
                raise ValueError(
                    f"TRON requires a twice-differentiable loss; {self.task} is first-order "
                    "only (OptimizerFactory.scala:49-70 parity)"
                )
            if self.regularization.reg_type in (RegularizationType.L1,
                                                RegularizationType.ELASTIC_NET):
                raise ValueError(
                    "TRON does not support L1/ELASTIC_NET regularization "
                    "(Params.scala:177-180 parity)"
                )

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
        w0 = (
            init_coefficients
            if init_coefficients is not None
            else torch.zeros((batch.dim,), dtype=real_dtype(), device=batch.device)
        )
        res = self.run_lanes([batch], norm, w0[None], reg_weight)
        result = OptResult(*(None if f is None else f[0] for f in res))
        w = result.coefficients
        variances = None
        if self.compute_variance:
            _, l2 = _split_reg_weight(self.regularization, reg_weight)
            variances = variances_from_hessian_diag(
                self.objective.hessian_diagonal(w, batch, norm, l2))
        return GeneralizedLinearModel(Coefficients(w, variances), self.task), result

    def run_lanes(
        self,
        batches: Sequence[GLMBatch],
        norm: NormalizationContext,
        w0: Tensor,
        reg_weight: Optional[float] = None,
    ) -> OptResult:
        """Solve one problem per batch as the lanes of one solve: lane ``l``
        minimizes this problem on ``batches[l]`` from ``w0[l]`` and stops on
        its own test. Returns the lane-stacked result."""
        obj = self.objective
        l1, l2 = _split_reg_weight(self.regularization, reg_weight)
        bounds = (
            (self.constraints.lower, self.constraints.upper)
            if self.constraints is not None
            else None
        )

        def lane_vg(w_lanes):
            vals, grads = zip(*(obj.value_and_grad(w, b, norm, l2)
                                for w, b in zip(w_lanes, batches)))
            return torch.stack(vals), torch.stack(grads)

        if self.optimizer == OptimizerType.TRON:
            def lane_hvp(w_lanes, v_lanes):
                return torch.stack([obj.hessian_vector(w, v, b, norm, l2)
                                    for w, v, b in zip(w_lanes, v_lanes, batches)])

            return tron_minimize_lanes(
                lane_vg, lane_hvp, w0, self.optimizer_config, bounds=bounds,
                track_coefficients=self.track_coefficients,
            )
        return lbfgs_minimize_lanes(
            lane_vg, w0, self.optimizer_config, l1_weight=l1, bounds=bounds,
            track_coefficients=self.track_coefficients,
        )

    def regularization_term_value(self, w: Tensor, reg_weight: Optional[float] = None) -> Tensor:
        """lambda_1 * ||w||_1 + lambda_2/2 * ||w||^2 (GLOP.scala:235-278)."""
        l1, l2 = _split_reg_weight(self.regularization, reg_weight)
        return l1 * torch.sum(torch.abs(w)) + 0.5 * l2 * torch.sum(torch.square(w))
