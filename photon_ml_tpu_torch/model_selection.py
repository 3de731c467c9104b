"""Model selection: pick the best regularization weight on validation data
(port of photon_ml_tpu/model_selection.py).

Reference spec: ModelSelection.scala:31-86 — classifiers by AUROC, linear
regression by RMSE, Poisson regression by per-datum log likelihood.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

from photon_ml_tpu_torch.evaluation import metrics as metrics_mod
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMBatch
from photon_ml_tpu_torch.types import TaskType

_SELECTION_METRIC = {
    TaskType.LOGISTIC_REGRESSION: metrics_mod.AREA_UNDER_RECEIVER_OPERATOR_CHARACTERISTICS,
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: metrics_mod.AREA_UNDER_RECEIVER_OPERATOR_CHARACTERISTICS,
    TaskType.LINEAR_REGRESSION: metrics_mod.ROOT_MEAN_SQUARE_ERROR,
    TaskType.POISSON_REGRESSION: metrics_mod.DATA_LOG_LIKELIHOOD,
}


def selection_metric_for(task: TaskType) -> str:
    return _SELECTION_METRIC[task]


def select_best_model(
    models: Iterable[Tuple[float, GeneralizedLinearModel]],
    validation_batch: GLMBatch,
    norm: Optional[NormalizationContext] = None,
) -> Tuple[float, GeneralizedLinearModel, Dict[float, Dict[str, float]]]:
    """Evaluate every (lambda, model) on validation data; return (best lambda,
    best model, all metric maps keyed by lambda)."""
    models = list(models)
    if not models:
        raise ValueError("no models to select from")
    metric = selection_metric_for(models[0][1].task)
    larger = metrics_mod.METRIC_LARGER_IS_BETTER.get(metric, True)
    # a model whose metric map lacks the selection metric must always lose
    worst = float("-inf") if larger else float("inf")
    all_metrics: Dict[float, Dict[str, float]] = {}
    scored = []
    for lam, model in models:
        m = metrics_mod.evaluate(model, validation_batch, norm)
        all_metrics[lam] = m
        scored.append((m.get(metric, worst), lam, model))
    best = max(scored, key=lambda t: t[0] if larger else -t[0])
    return best[1], best[2], all_metrics
