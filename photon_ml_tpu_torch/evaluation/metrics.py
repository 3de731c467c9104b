"""Batch model evaluation: the full metric map per trained model (port of
photon_ml_tpu/evaluation/metrics.py).

Reference spec: Evaluation.scala:30-190 — score once with the mean function
(offset included), then the metrics of the model family: MAE/MSE/RMSE for
regression, AUROC/AUPR/peak F1 for binary classifiers, per-datum log
likelihood and AICc for logistic and Poisson. Metric keys are
string-identical to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from photon_ml_tpu_torch.evaluation.evaluators import area_under_roc_curve, running_sum
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMBatch
from photon_ml_tpu_torch.types import TaskType

Tensor = torch.Tensor

MEAN_ABSOLUTE_ERROR = "Mean absolute error"
MEAN_SQUARE_ERROR = "Mean square error"
ROOT_MEAN_SQUARE_ERROR = "Root mean square error"
AREA_UNDER_PRECISION_RECALL = "Area under precision/recall"
AREA_UNDER_RECEIVER_OPERATOR_CHARACTERISTICS = "Area under ROC"
PEAK_F1_SCORE = "Peak F1 score"
DATA_LOG_LIKELIHOOD = "Per-datum log likelihood"
AIKAKE_INFORMATION_CRITERION = "Aikake information criterion"
EPSILON = 1e-9

_REGRESSION_TASKS = (TaskType.LINEAR_REGRESSION, TaskType.POISSON_REGRESSION)
_CLASSIFIER_TASKS = (TaskType.LOGISTIC_REGRESSION, TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM)


def _roc_pr_curves(scores: Tensor, labels: Tensor, weights: Optional[Tensor]):
    """Sorted-descending cumulative weighted TP/FP counts."""
    order = torch.argsort(-scores, stable=True)
    lab = labels[order]
    w = torch.ones_like(lab) if weights is None else weights[order]
    return running_sum(w * lab), running_sum(w * (1.0 - lab))


def area_under_pr(scores: Tensor, labels: Tensor, weights: Optional[Tensor] = None) -> Tensor:
    """AUPR by trapezoidal integration of (recall, precision) points,
    anchored at (0, p(first point)) like Spark's BinaryClassificationMetrics."""
    tp, fp = _roc_pr_curves(scores, labels, weights)
    recall = tp / torch.clamp_min(tp[-1], 1.0)
    precision = tp / torch.clamp_min(tp + fp, EPSILON)
    r = torch.cat([torch.zeros_like(recall[:1]), recall])
    p = torch.cat([precision[:1], precision])
    return torch.sum((r[1:] - r[:-1]) * 0.5 * (p[1:] + p[:-1]))


def peak_f1(scores: Tensor, labels: Tensor, weights: Optional[Tensor] = None) -> Tensor:
    """max_t F1(t) over all score thresholds."""
    tp, fp = _roc_pr_curves(scores, labels, weights)
    precision = tp / torch.clamp_min(tp + fp, EPSILON)
    recall = tp / torch.clamp_min(tp[-1], 1.0)
    f1 = 2.0 * precision * recall / torch.clamp_min(precision + recall, EPSILON)
    return torch.max(f1)


def _wmean(v: Tensor, weights: Optional[Tensor]) -> Tensor:
    if weights is None:
        return torch.mean(v)
    return torch.sum(weights * v) / torch.clamp_min(torch.sum(weights), EPSILON)


def logistic_log_likelihood(mean_scores: Tensor, labels: Tensor,
                            weights: Optional[Tensor] = None) -> Tensor:
    """Per-datum average of y log(p) + (1-y) log(1-p), both logs clipped
    symmetrically at log(EPSILON) (the JAX package's documented deviation
    from Evaluation.logisticRegressionLogLikelihood)."""
    p = mean_scores
    log_p = torch.log(torch.clamp_min(p, EPSILON))
    log_1mp = torch.where(p > 1.0 - EPSILON, torch.full_like(p, math.log(EPSILON)), torch.log1p(-p))
    return _wmean(labels * log_p + (1.0 - labels) * log_1mp, weights)


def poisson_log_likelihood(margins: Tensor, labels: Tensor,
                           weights: Optional[Tensor] = None) -> Tensor:
    """Per-datum average of y wTx - exp(wTx) - logGamma(1+y)
    (Evaluation.poissonRegressionLogLikelihood :124-135)."""
    return _wmean(labels * margins - torch.exp(margins) - torch.lgamma(1.0 + labels), weights)


def _aic(log_likelihood_per_datum: float, n: float, coefficients: Tensor) -> float:
    """AICc: 2(k - LL) + 2k(k+1)/(n-k-1), k = #{|coef| > 1e-9}
    (Evaluation.scala:99-116); +inf when n <= k+1."""
    k = float(torch.sum(torch.abs(coefficients) > EPSILON))
    base = 2.0 * (k - n * log_likelihood_per_datum)
    denom = n - k - 1.0
    if denom <= 0.0:
        return float("inf")
    return base + 2.0 * k * (k + 1.0) / denom


def evaluate(model: GeneralizedLinearModel, batch: GLMBatch,
             norm: Optional[NormalizationContext] = None) -> Dict[str, float]:
    """Full metric map for one model on one dataset (Evaluation.evaluate).

    Pass the training ``norm`` when the coefficients live in normalized space.
    """
    task = model.task
    mean_scores = model.compute_mean_functions(batch, norm)
    labels = batch.labels
    weights = batch.weights  # weight 0 = padding
    n = float(torch.sum(weights > 0.0))
    metrics: Dict[str, float] = {}

    if task in _REGRESSION_TASKS:
        err = mean_scores - labels
        mse = float(_wmean(torch.square(err), weights))
        metrics[MEAN_ABSOLUTE_ERROR] = float(_wmean(torch.abs(err), weights))
        metrics[MEAN_SQUARE_ERROR] = mse
        metrics[ROOT_MEAN_SQUARE_ERROR] = mse ** 0.5

    if task in _CLASSIFIER_TASKS:
        metrics[AREA_UNDER_PRECISION_RECALL] = float(area_under_pr(mean_scores, labels, weights))
        metrics[AREA_UNDER_RECEIVER_OPERATOR_CHARACTERISTICS] = float(
            area_under_roc_curve(mean_scores, labels, weights)
        )
        metrics[PEAK_F1_SCORE] = float(peak_f1(mean_scores, labels, weights))

    if task == TaskType.LOGISTIC_REGRESSION:
        metrics[DATA_LOG_LIKELIHOOD] = float(logistic_log_likelihood(mean_scores, labels, weights))
    elif task == TaskType.POISSON_REGRESSION:
        margins = model.compute_margins(batch, norm)
        metrics[DATA_LOG_LIKELIHOOD] = float(poisson_log_likelihood(margins, labels, weights))

    if DATA_LOG_LIKELIHOOD in metrics:
        metrics[AIKAKE_INFORMATION_CRITERION] = _aic(
            metrics[DATA_LOG_LIKELIHOOD], n, model.coefficients.means
        )
    return metrics


# metric ordering: True = larger is better (Evaluation.metricMetadata)
METRIC_LARGER_IS_BETTER: Dict[str, bool] = {
    MEAN_ABSOLUTE_ERROR: False,
    MEAN_SQUARE_ERROR: False,
    ROOT_MEAN_SQUARE_ERROR: False,
    AREA_UNDER_PRECISION_RECALL: True,
    AREA_UNDER_RECEIVER_OPERATOR_CHARACTERISTICS: True,
    PEAK_F1_SCORE: True,
    DATA_LOG_LIKELIHOOD: True,
    AIKAKE_INFORMATION_CRITERION: False,
}
