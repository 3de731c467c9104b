"""Bootstrap training diagnostic: metric distributions + coefficient CIs
(port of photon_ml_tpu/diagnostics/bootstrap_diagnostic.py).

Reference spec: diagnostics/bootstrap/ — BootstrapTrainingDiagnostic runs
BootstrapTraining over the dataset and reports (BootstrapReport.scala:27-32):
metric distributions (min/q1/median/q3/max), bagged-model metrics (simple
coefficient averaging), the coefficient distributions of the most important
features, and features whose bootstrap CI straddles zero.

Built on photon_ml_tpu_torch.bootstrap: the replicates are the lanes of one
solve over a (k, N) resample-weight matrix, with no data copies.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.bootstrap import BootstrapResult, CoefficientSummary, bootstrap_train
from photon_ml_tpu_torch.diagnostics.common import feature_names_or_indices
from photon_ml_tpu_torch.diagnostics.reporting import SectionReport, SimpleTextReport, TableReport
from photon_ml_tpu_torch.evaluation import metrics as metrics_mod
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMBatch
from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem

DEFAULT_BOOTSTRAP_SAMPLES = 10
NUM_IMPORTANT_FEATURES = 20
MAX_ZERO_CROSSING_ROWS = 25


@dataclasses.dataclass
class BootstrapDiagnosticReport:
    """BootstrapReport.scala parity."""

    # metric -> (min, q1, median, q3, max)
    metric_distributions: Dict[str, Tuple[float, float, float, float, float]]
    bagged_model_metrics: Dict[str, float]
    # feature name -> coefficient summary, for the most important features
    important_feature_distributions: Dict[str, CoefficientSummary]
    # feature name -> (index, importance, summary) for CI-straddles-zero features
    zero_crossing_features: Dict[str, Tuple[int, float, CoefficientSummary]]


def diagnose(
    problem: GLMOptimizationProblem,
    batch: GLMBatch,
    norm: NormalizationContext,
    holdout: GLMBatch,
    feature_names: Optional[Sequence[str]] = None,
    num_samples: int = DEFAULT_BOOTSTRAP_SAMPLES,
) -> BootstrapDiagnosticReport:
    result: BootstrapResult = bootstrap_train(
        problem,
        batch,
        norm,
        num_samples=num_samples,
        metrics_fn=lambda m: metrics_mod.evaluate(m, holdout, norm),
    )

    metric_distributions = {
        name: (s.min, s.q1, s.median, s.q3, s.max)
        for name, s in result.metric_summaries.items()
    }

    # Bagged model = mean coefficients across replicates
    mean_coeffs = np.mean(
        [m.means_as_numpy() for m in result.models], axis=0
    )
    bagged = GeneralizedLinearModel(
        Coefficients(torch.from_numpy(mean_coeffs).to(holdout.device)), problem.task)
    bagged_metrics = metrics_mod.evaluate(bagged, holdout, norm)

    names = feature_names_or_indices(feature_names, mean_coeffs.shape[0])
    importance = np.abs(mean_coeffs)
    top = np.argsort(-importance)[:NUM_IMPORTANT_FEATURES]
    important = {
        str(names[int(i)]): result.coefficient_summaries[int(i)] for i in top
    }
    zero_crossing = {
        str(names[j]): (j, float(importance[j]), s)
        for j, s in enumerate(result.coefficient_summaries)
        if s.contains_zero() and importance[j] > 0.0
    }
    return BootstrapDiagnosticReport(
        metric_distributions, bagged_metrics, important, zero_crossing
    )


def to_section(report: BootstrapDiagnosticReport) -> SectionReport:
    items: List[object] = [
        TableReport(
            ["Metric", "Min", "Q1", "Median", "Q3", "Max"],
            [[m, *vals] for m, vals in sorted(report.metric_distributions.items())],
            caption="Holdout metric distribution across bootstrap replicates",
        ),
        TableReport(
            ["Metric", "Bagged model value"],
            [[m, v] for m, v in sorted(report.bagged_model_metrics.items())],
            caption="Metrics of the coefficient-averaged (bagged) model",
        ),
        TableReport(
            ["Feature", "Min", "Q1", "Median", "Q3", "Max"],
            [
                [name, s.min, s.q1, s.median, s.q3, s.max]
                for name, s in report.important_feature_distributions.items()
            ],
            caption="Coefficient distributions of the most important features",
        ),
    ]
    if report.zero_crossing_features:
        rows = sorted(
            report.zero_crossing_features.items(), key=lambda kv: -kv[1][1]
        )[:MAX_ZERO_CROSSING_ROWS]
        items.append(
            TableReport(
                ["Feature", "Index", "|mean coefficient|", "Min", "Max"],
                [[name, idx, imp, s.min, s.max] for name, (idx, imp, s) in rows],
                caption="Features whose bootstrap CI straddles zero "
                "(candidates for removal)",
            )
        )
    else:
        items.append(SimpleTextReport("No feature CI straddles zero."))
    return SectionReport("Bootstrap analysis", items)
