"""Machine-readable diagnostic outputs (port of
photon_ml_tpu/diagnostics/avro_reports.py).

The reference ships report record schemas (EvaluationResultAvro,
Curve2DAvro, FeatureSummarizationResultAvro, ... —
photon-avro-schemas/src/main/avro/) consumed by offline tooling; its driver
emits HTML only. Here the GLM driver writes BOTH: the HTML report and an
``diagnostics/`` directory of avro records per trained model — scalar
metric maps, ROC / precision-recall curves (classifiers), and per-feature
summary statistics — in the reference's schemas so existing consumers can
read them unchanged.
"""

from __future__ import annotations

import os
from email.utils import format_datetime
from datetime import datetime, timezone
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.io import avro as avro_io
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.types import ConvergenceReason, TaskType

EVALUATION_FILE = "evaluation-results.avro"
FEATURE_SUMMARY_FILE = "feature-summaries.avro"

# ConvergenceReason -> ConvergenceReasonAvro symbol (AbstractOptimizer
# reasons; NOT_CONVERGED has no symbol and maps to null)
_REASON_SYMBOL = {
    ConvergenceReason.MAX_ITERATIONS: "MAX_ITERATIONS",
    ConvergenceReason.FUNCTION_VALUES_CONVERGED: "FUNCTION_VALUES_CONVERGED",
    ConvergenceReason.GRADIENT_CONVERGED: "GRADIENT_CONVERGED",
    ConvergenceReason.OBJECTIVE_NOT_IMPROVING: "OBJECTIVE_NOT_IMPROVING",
}


def _rfc2822_now() -> str:
    return format_datetime(datetime.now(timezone.utc))


def _weighted_tp_fp(
    scores: np.ndarray, labels: np.ndarray, weights: Optional[np.ndarray]
) -> Tuple[np.ndarray, np.ndarray]:
    """Cumulative WEIGHTED TP/FP, descending-score sweep — the same
    semantics as evaluation.metrics._roc_pr_curves, so the persisted curves
    agree with the weighted scalar AUC/AUPR; weight-0 rows (row padding
    from to_batch) contribute nothing."""
    order = np.argsort(-scores, kind="stable")
    y = (labels[order] > 0.5).astype(np.float64)
    w = np.ones_like(y) if weights is None else np.asarray(weights, np.float64)[order]
    tp = np.cumsum(w * y)
    fp = np.cumsum(w * (1.0 - y))
    return tp, fp


def roc_curve(
    scores: np.ndarray,
    labels: np.ndarray,
    weights: Optional[np.ndarray] = None,
    max_points: int = 200,
) -> List[dict]:
    """(FPR, TPR) Point2DAvro list, weighted, subsampled."""
    tp, fp = _weighted_tp_fp(scores, labels, weights)
    n_pos, n_neg = max(tp[-1], 1.0), max(fp[-1], 1.0)
    tpr = np.concatenate([[0.0], tp / n_pos])
    fpr = np.concatenate([[0.0], fp / n_neg])
    idx = np.unique(np.linspace(0, len(tpr) - 1, max_points).astype(int))
    return [{"x": float(fpr[i]), "y": float(tpr[i])} for i in idx]


def pr_curve(
    scores: np.ndarray,
    labels: np.ndarray,
    weights: Optional[np.ndarray] = None,
    max_points: int = 200,
) -> List[dict]:
    """(recall, precision) Point2DAvro list, weighted."""
    tp, fp = _weighted_tp_fp(scores, labels, weights)
    precision = tp / np.maximum(tp + fp, 1e-9)
    recall = tp / max(tp[-1], 1.0)
    idx = np.unique(np.linspace(0, len(tp) - 1, max_points).astype(int))
    return [{"x": float(recall[i]), "y": float(precision[i])} for i in idx]


def training_context(
    task: TaskType,
    lambda1: float,
    lambda2: float,
    normalized: bool,
    optimizer: str,
    tolerance: float,
    num_iterations: int,
    reason: Optional[ConvergenceReason],
    source_data_path: str,
) -> dict:
    return {
        "trainingTask": task.value if task != TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM
        else "LOGISTIC_REGRESSION",  # enum has no SVM symbol; nearest task
        "lambda1": float(lambda1),
        "lambda2": float(lambda2),
        "applyFeatureNormalization": bool(normalized),
        "timestamp": _rfc2822_now(),
        "modelSource": "PHOTONML",
        "optimizer": f"com.linkedin.photon.ml.optimization.{optimizer}",
        "convergenceTolerance": float(tolerance),
        "numberOfIterations": int(num_iterations),
        "convergenceReason": _REASON_SYMBOL.get(reason),
        "sourceDataPath": source_data_path,
        "description": None,
        "lossFunction": schemas.LOSS_CLASS_BY_TASK[task.value],
        "scoreFunction": schemas.LOSS_CLASS_BY_TASK[task.value],
    }


def evaluation_result(
    model_id: str,
    model_path: str,
    data_path: str,
    train_ctx: dict,
    scalar_metrics: Dict[str, float],
    scores: Optional[np.ndarray] = None,
    labels: Optional[np.ndarray] = None,
    weights: Optional[np.ndarray] = None,
    with_curves: bool = False,
) -> dict:
    curves: Dict[str, dict] = {}
    if with_curves and scores is not None and labels is not None and len(scores):
        s_, l_ = np.asarray(scores), np.asarray(labels)
        w_ = None if weights is None else np.asarray(weights)
        curves["roc"] = {
            "xLabel": "false positive rate",
            "yLabel": "true positive rate",
            "points": roc_curve(s_, l_, w_),
        }
        curves["precisionRecall"] = {
            "xLabel": "recall",
            "yLabel": "precision",
            "points": pr_curve(s_, l_, w_),
        }
    return {
        "evaluationContext": {
            "metricsCalculator": "photon_ml_tpu_torch.evaluation.metrics",
            "modelId": model_id,
            "modelPath": model_path,
            "modelTrainingContext": train_ctx,
            "timestamp": _rfc2822_now(),
            "dataPath": data_path,
            "segmentContext": None,
        },
        "scalarMetrics": {k: float(v) for k, v in scalar_metrics.items()},
        "curves": curves,
    }


def write_evaluation_results(output_dir: str, records: Sequence[dict]) -> str:
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, EVALUATION_FILE)
    avro_io.write_container(path, records, schemas.EVALUATION_RESULT)
    return path


def feature_summaries(
    feature_names: Sequence[str],
    summary,
) -> List[dict]:
    """BasicStatisticalSummary -> FeatureSummarizationResultAvro records
    (name/term split on ':' — the HTML report's display convention)."""
    out = []
    host = lambda t: t.detach().cpu().numpy()
    mean = host(summary.mean)
    var = host(summary.variance)
    mn = host(summary.min)
    mx = host(summary.max)
    nnz = host(summary.num_nonzeros)
    for j, full in enumerate(feature_names):
        name, _, term = full.partition(":")
        out.append(
            {
                "featureName": name,
                "featureTerm": term,
                "metrics": {
                    "mean": float(mean[j]),
                    "variance": float(var[j]),
                    "min": float(mn[j]),
                    "max": float(mx[j]),
                    "numNonzeros": float(nnz[j]),
                },
            }
        )
    return out


def write_feature_summaries(output_dir: str, records: Sequence[dict]) -> str:
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, FEATURE_SUMMARY_FILE)
    avro_io.write_container(path, records, schemas.FEATURE_SUMMARIZATION_RESULT)
    return path
