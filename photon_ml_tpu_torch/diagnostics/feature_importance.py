"""Feature importance diagnostics (port of
photon_ml_tpu/diagnostics/feature_importance.py).

Reference spec: diagnostics/featureimportance/ — two rankings over the model
coefficients (AbstractFeatureImportanceDiagnostic.scala:38-100):

  EXPECTED_MAGNITUDE : importance_j = |w_j * E|x_j||   (meanAbs from summary)
  VARIANCE           : importance_j = |w_j * Var x_j|

Without a statistical summary both fall back to |w_j|. The report keeps the
top MAX_RANKED_FEATURES features with descriptions plus an importance-by-
fractile curve (getRankToImportance :84-94).

The |w| * stat product runs on the batch's device; the ranking and the
report are built on the host from that one vector.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.diagnostics.common import feature_names_or_indices
from photon_ml_tpu_torch.diagnostics.reporting import PlotReport, SectionReport, SimpleTextReport, TableReport
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.ops.stats import BasicStatisticalSummary

MAX_RANKED_FEATURES = 100
NUM_IMPORTANCE_FRACTILES = 20

EXPECTED_MAGNITUDE = "EXPECTED_MAGNITUDE"
VARIANCE = "VARIANCE"


@dataclasses.dataclass
class FeatureImportanceReport:
    """FeatureImportanceReport.scala parity."""

    importance_type: str  # EXPECTED_MAGNITUDE or VARIANCE
    importance_description: str
    # (feature name, index, importance, description), descending importance
    ranked_features: List[Tuple[str, int, float, str]]
    # fractile (percent) -> importance at that rank
    rank_to_importance: Dict[float, float]


def _importance_vector(
    model: GeneralizedLinearModel,
    summary: Optional[BasicStatisticalSummary],
    importance_type: str,
) -> Tuple[np.ndarray, str]:
    w = torch.abs(model.coefficients.means)
    host = lambda t: t.detach().cpu().numpy()
    if summary is None:
        return host(w), "|coefficient| (no data summary available)"
    if importance_type == EXPECTED_MAGNITUDE:
        return host(w * summary.mean_abs), "|coefficient * E[|feature|]|"
    if importance_type == VARIANCE:
        return host(w * summary.variance), "|coefficient * Var[feature]|"
    raise ValueError(f"unknown importance type {importance_type}")


def diagnose(
    model: GeneralizedLinearModel,
    summary: Optional[BasicStatisticalSummary],
    feature_names: Optional[Sequence[str]] = None,
    importance_type: str = EXPECTED_MAGNITUDE,
    max_features: int = MAX_RANKED_FEATURES,
) -> FeatureImportanceReport:
    imp, description = _importance_vector(model, summary, importance_type)
    order = np.argsort(-imp)
    coeffs = model.means_as_numpy()

    names = feature_names_or_indices(feature_names, imp.shape[0])
    if summary is not None:
        mean, std, mean_abs = (t.detach().cpu().numpy()
                               for t in (summary.mean, summary.std, summary.mean_abs))
    ranked = []
    for idx in order[:max_features]:
        idx = int(idx)
        desc = f"coefficient={coeffs[idx]:.6g}"
        if summary is not None:
            desc += (
                f", mean={float(mean[idx]):.4g}"
                f", std={float(std[idx]):.4g}"
                f", mean|x|={float(mean_abs[idx]):.4g}"
            )
        ranked.append((str(names[idx]), idx, float(imp[idx]), desc))

    # importance at the 0th, 5th, ... 100th percentile rank (:84-94)
    d = imp.shape[0]
    rank_to_importance = {}
    sorted_desc = imp[order]
    for f in range(NUM_IMPORTANCE_FRACTILES + 1):
        pos = f * (d - 1) // NUM_IMPORTANCE_FRACTILES if d else 0
        rank_to_importance[100.0 * f / NUM_IMPORTANCE_FRACTILES] = (
            float(sorted_desc[pos]) if d else 0.0
        )
    return FeatureImportanceReport(importance_type, description, ranked, rank_to_importance)


def to_section(report: FeatureImportanceReport, top_rows: int = 25) -> SectionReport:
    fractiles = sorted(report.rank_to_importance)
    return SectionReport(
        f"Feature importance ({report.importance_type})",
        [
            SimpleTextReport(f"Importance measure: {report.importance_description}"),
            TableReport(
                ["Feature", "Index", "Importance", "Detail"],
                [list(r) for r in report.ranked_features[:top_rows]],
                caption=f"Top {min(top_rows, len(report.ranked_features))} features",
            ),
            PlotReport(
                title="Importance by rank fractile",
                x_label="Rank fractile (%)",
                y_label="Importance",
                series={
                    "importance": (
                        fractiles,
                        [report.rank_to_importance[f] for f in fractiles],
                    )
                },
            ),
        ],
    )
