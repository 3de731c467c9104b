"""Report assembly: system + per-model chapters -> one document (port of
photon_ml_tpu/diagnostics/reports.py).

Reference spec: diagnostics/reporting/reports/ — SystemReport (params +
feature summary) and ModelDiagnosticReport (per-lambda model: metrics,
coefficient summary, fit/importance/HL/independence/bootstrap sections) are
combined by DiagnosticToPhysicalReportTransformer into the document that
Driver.writeDiagnostics renders (Driver.scala:577-597).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.diagnostics.common import feature_names_or_indices
from photon_ml_tpu_torch.diagnostics.reporting import (
    ChapterReport,
    DocumentReport,
    SectionReport,
    SimpleTextReport,
    TableReport,
)
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.ops.stats import BasicStatisticalSummary

MAX_SUMMARY_ROWS = 50


@dataclasses.dataclass
class SystemReport:
    """ParametersReport + FeatureSummaryReport parity."""

    params: Dict[str, object]
    summary: Optional[BasicStatisticalSummary] = None
    feature_names: Optional[Sequence[str]] = None

    def to_chapter(self) -> ChapterReport:
        sections = [
            SectionReport(
                "Parameters",
                [
                    TableReport(
                        ["Parameter", "Value"],
                        [[k, str(v)] for k, v in sorted(self.params.items())],
                    )
                ],
            )
        ]
        if self.summary is not None:
            host = lambda t: t.detach().cpu().numpy()
            mean = host(self.summary.mean)
            d = mean.shape[0]
            names = feature_names_or_indices(self.feature_names, d)
            var = host(self.summary.variance)
            mn = host(self.summary.min)
            mx = host(self.summary.max)
            nnz = host(self.summary.num_nonzeros)
            shown = min(d, MAX_SUMMARY_ROWS)
            rows = [
                [str(names[j]), float(mean[j]), float(var[j]), float(mn[j]),
                 float(mx[j]), int(nnz[j])]
                for j in range(shown)
            ]
            items: List[object] = [
                TableReport(
                    ["Feature", "Mean", "Variance", "Min", "Max", "Non-zeros"],
                    rows,
                    caption=f"Feature summary ({shown} of {d} features, "
                    f"n = {int(float(self.summary.count))})",
                )
            ]
            if d > shown:
                items.append(SimpleTextReport(f"... {d - shown} more features omitted."))
            sections.append(SectionReport("Feature summary", items))
        return ChapterReport("System", sections)


@dataclasses.dataclass
class ModelDiagnosticReport:
    """One trained model's diagnostic chapter
    (ModelDiagnosticReport.scala parity)."""

    model: GeneralizedLinearModel
    reg_weight: float
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)
    sections: List[SectionReport] = dataclasses.field(default_factory=list)

    def to_chapter(self) -> ChapterReport:
        head = [
            SectionReport(
                "Summary",
                [
                    SimpleTextReport(self.model.summary()),
                    TableReport(
                        ["Metric", "Value"],
                        [[k, v] for k, v in sorted(self.metrics.items())],
                    ),
                ],
            )
        ]
        return ChapterReport(
            f"Model (lambda = {self.reg_weight:g})", head + list(self.sections)
        )


def assemble_document(
    title: str,
    system: Optional[SystemReport],
    model_reports: List[ModelDiagnosticReport],
) -> DocumentReport:
    chapters: List[ChapterReport] = []
    if system is not None:
        chapters.append(system.to_chapter())
    chapters.extend(m.to_chapter() for m in model_reports)
    return DocumentReport(title, chapters)
