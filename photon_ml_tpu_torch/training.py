"""High-level GLM training: warm-started regularization-weight grid (port of
``train_glm_grid`` in photon_ml_tpu/training.py).

Reference spec: ModelTraining.scala:51-197 — weights sorted high-to-low, each
solve warm-started from the previous lambda's model. The streaming and
lambda-batched variants are not yet ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.ops import losses as losses_mod
from photon_ml_tpu_torch.ops.features import DenseFeatures
from photon_ml_tpu_torch.ops.fused_glm import select_fused_block_rows
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMBatch
from photon_ml_tpu_torch.optim.common import OptResult
from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.types import real_dtype


@dataclasses.dataclass
class TrainedModelList:
    """(lambda, model, solve result) triples, sorted high-to-low lambda."""

    weights: List[float]
    models: List[GeneralizedLinearModel]
    results: List[OptResult]

    def as_map(self) -> Dict[float, GeneralizedLinearModel]:
        return dict(zip(self.weights, self.models))


def train_glm_grid(
    problem: GLMOptimizationProblem,
    batch: GLMBatch,
    norm: NormalizationContext,
    reg_weights: Sequence[float],
    warm_start_models: Optional[Dict[float, GeneralizedLinearModel]] = None,
) -> TrainedModelList:
    """Train one model per regularization weight with warm starts, on the
    batch's device. The first solve starts from the highest-lambda
    warm-start model when given (ModelTraining.scala:158-191), else zeros.
    On the card, dense bf16/f32 batches take the fused value+grad kernel.
    """
    if problem.fused_block_rows is None and isinstance(batch.features, DenseFeatures):
        block = select_fused_block_rows(
            losses_mod.for_task(problem.task), batch.num_rows, batch.dim,
            batch.features.matrix.dtype, batch.device,
        )
        if block is not None:
            problem = dataclasses.replace(problem, fused_block_rows=block)

    if warm_start_models:
        w = warm_start_models[max(warm_start_models)].coefficients.means
    else:
        w = torch.zeros((batch.dim,), dtype=real_dtype(), device=batch.device)

    weights, models, results = [], [], []
    for lam in sorted(reg_weights, reverse=True):
        model, res = problem.run(batch, norm, init_coefficients=w, reg_weight=lam)
        w = model.coefficients.means
        weights.append(lam)
        models.append(model)
        results.append(res)
    return TrainedModelList(weights, models, results)
