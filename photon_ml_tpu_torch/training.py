"""High-level GLM training: warm-started regularization-weight grid (port of
``train_glm_grid`` in photon_ml_tpu/training.py).

Reference spec: ModelTraining.scala:51-197 — weights sorted high-to-low, each
solve warm-started from the previous lambda's model.
:func:`train_glm_grid_streaming` runs the same grid over chunk-streamed data
(optim/streaming.py). The lambda-batched variant is not yet ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.ops import losses as losses_mod
from photon_ml_tpu_torch.ops.features import DenseFeatures
from photon_ml_tpu_torch.ops.fused_glm import select_fused_block_rows
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMBatch
from photon_ml_tpu_torch.optim.common import OptResult
from photon_ml_tpu_torch.optim.problem import (
    GLMOptimizationProblem,
    _split_reg_weight,
    variances_from_hessian_diag,
)
from photon_ml_tpu_torch.types import OptimizerType, real_dtype


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


def train_glm_grid_streaming(
    problem: GLMOptimizationProblem,
    source,
    norm: NormalizationContext,
    reg_weights: Sequence[float],
    bucketer=None,
    device=None,
) -> TrainedModelList:
    """The warm-started lambda grid of :func:`train_glm_grid` over a
    chunk-streamed ``source`` (optim/streaming.ChunkedGLMSource) on
    ``device``: LBFGS / OWL-QN stream one pass per evaluation, TRON one
    more per CG step. ``bucketer`` pads every chunk's rows up the ladder.
    The per-chunk pass is the plain objective (the fused kernel is raced
    only on the in-memory path, as in the JAX package)."""
    from photon_ml_tpu_torch.device import resolve_device
    from photon_ml_tpu_torch.optim.streaming import (
        lbfgs_minimize_streaming,
        make_streaming_hvp,
        make_streaming_value_and_grad,
        streaming_hessian_diagonal,
        tron_minimize_streaming,
    )

    dev = resolve_device(device)
    obj = problem.objective
    bounds = ((problem.constraints.lower, problem.constraints.upper)
              if problem.constraints is not None else None)
    tron = problem.optimizer == OptimizerType.TRON
    w = torch.zeros((source.dim,), dtype=real_dtype(), device=dev)
    vg_base = make_streaming_value_and_grad(source, obj, norm, bucketer=bucketer, device=dev)
    hvp_base = make_streaming_hvp(source, obj, norm, bucketer=bucketer, device=dev) if tron else None
    weights, models, results = [], [], []
    for lam in sorted(reg_weights, reverse=True):
        l1, l2 = _split_reg_weight(problem.regularization, lam)
        vg = lambda wt, l2=l2: vg_base(wt, l2_weight=float(l2))
        if tron:
            hvp = lambda wt, v, l2=l2: hvp_base(wt, v, l2_weight=float(l2))
            res = tron_minimize_streaming(vg, hvp, w, problem.optimizer_config, bounds=bounds)
        else:
            res = lbfgs_minimize_streaming(vg, w, problem.optimizer_config,
                                           l1_weight=float(l1), bounds=bounds)
        w = res.coefficients
        variances = None
        if problem.compute_variance:
            variances = variances_from_hessian_diag(streaming_hessian_diagonal(
                source, obj, norm, w, float(l2), bucketer=bucketer))
        models.append(GeneralizedLinearModel(Coefficients(w, variances), problem.task))
        weights.append(lam)
        results.append(res)
    return TrainedModelList(weights, models, results)
