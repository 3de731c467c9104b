"""Hosmer–Lemeshow goodness-of-fit test for logistic models (port of
photon_ml_tpu/diagnostics/hosmer_lemeshow.py).

Reference spec: diagnostics/hl/ — scores are binned into uniform-width
probability bins (HistogramBin semantics in
PredictedProbabilityVersusObservedFrequencyHistogramBin.scala:39-64:
expected positives = ceil(count * bin midpoint)); the default binner picks
min(dim + 2, 0.9*sqrt(n) + 0.9*log1p(n)) bins
(DefaultPredictedProbabilityVersusObservedFrequencyBinner.scala:29-57); the
chi-square statistic sums (obs-exp)^2/exp over pos and neg sides per bin
with a minimum-expected-count caveat of 5, dof = bins - 2, and the report
carries the chi2 CDF probability plus standard-confidence cutoffs
(HosmerLemeshowDiagnostic.scala:46-105).

Binning runs on the batch's device: bin indices, then per-bin integer
counts by a stable sort and an integer running sum (exact, and
deterministic on the card, where a weighted bincount is not); only the
B-bin histogram lands on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch

from photon_ml_tpu_torch.diagnostics.reporting import (
    PlotReport,
    SectionReport,
    SimpleTextReport,
    TableReport,
)
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.ops.objective import GLMBatch
from photon_ml_tpu_torch.types import TaskType

STANDARD_CONFIDENCE_LEVELS = (
    0.000001, 0.01, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5,
    0.6, 0.7, 0.8, 0.9, 0.95, 0.99, 0.999999,
)
MINIMUM_EXPECTED_IN_BUCKET = 5


@dataclasses.dataclass
class HistogramBin:
    """One probability bin; expected positives = ceil(count * midpoint)."""

    lower: float
    upper: float
    observed_pos: int = 0
    observed_neg: int = 0

    @property
    def expected_pos(self) -> int:
        mid = (self.lower + self.upper) / 2.0
        return int(math.ceil((self.observed_pos + self.observed_neg) * mid))

    @property
    def expected_neg(self) -> int:
        return self.observed_pos + self.observed_neg - self.expected_pos


@dataclasses.dataclass
class HosmerLemeshowReport:
    binning_msg: str
    chi_square_msg: str
    chi_square: float
    degrees_of_freedom: int
    chi_square_probability: float  # P(X <= chi2) under the null
    confidence_cutoffs: List[Tuple[float, float]]  # (level, chi2 cutoff)
    histogram: List[HistogramBin]

    def test_description(self) -> str:
        return (
            f"chi2 = {self.chi_square:.6g} with {self.degrees_of_freedom} d.o.f.; "
            f"P(chi2 <= observed | model is well calibrated) = "
            f"{self.chi_square_probability:.6g}"
        )


def default_bin_count(num_items: int, num_dimensions: int) -> Tuple[str, int]:
    """min(dimension-driven, data-driven) uniform bins, never below 3
    (dof = bins - 2 must stay positive for the chi2 to be defined)."""
    by_dim = num_dimensions + 2
    # The reference applies factor 0.9 to both terms
    # (DefaultPredictedProbabilityVersusObservedFrequencyBinner.scala:51-57).
    by_data = int(0.9 * math.sqrt(num_items) + 0.9 * math.log1p(num_items))
    bins = max(3, min(by_dim, by_data))
    ok = (
        "Sufficient bins for a discriminative test"
        if bins >= by_dim
        else "Not enough bins for a discriminative test; please be careful when "
        "interpreting these results or rerun with more data"
    )
    msg = (
        f"Number of test set samples: {num_items}\n"
        f"Sample dimensionality: {num_dimensions}\n"
        f"Target number of bins based on dimensionality alone: {by_dim}\n"
        f"Target number of bins based on data alone: {by_data}\n" + ok
    )
    return msg, bins


def _bin_sums(idx: torch.Tensor, values: torch.Tensor, num_bins: int) -> List[int]:
    """Per-bin integer sums of ``values`` by bin index: a stable sort by bin,
    an int64 running sum, and differences at the bins' edges."""
    order = torch.argsort(idx, stable=True)
    edges = torch.searchsorted(
        idx[order], torch.arange(num_bins + 1, dtype=idx.dtype, device=idx.device))
    running = torch.cat([torch.zeros(1, dtype=torch.int64, device=idx.device),
                         torch.cumsum(values[order].to(torch.int64), 0)])
    return (running[edges[1:]] - running[edges[:-1]]).cpu().tolist()


def bin_scores(
    predicted: torch.Tensor,
    labels: torch.Tensor,
    num_bins: int,
    weights: Optional[torch.Tensor] = None,
) -> List[HistogramBin]:
    """Histogram (predicted probability, label) pairs into uniform bins.

    One pass on the device: bin index = floor(p * B) clamped, pos/neg
    counts in integers. Padding rows (weight 0) are dropped.
    """
    p = torch.clamp(predicted, 0.0, 1.0)
    idx = torch.clamp_max((p * num_bins).to(torch.int32), num_bins - 1)
    present = (
        torch.ones_like(p) if weights is None else (weights > 0.0).to(p.dtype)
    )
    # integer accumulation: float32 sums saturate at 2^24 rows
    pos = (labels * present).to(torch.int32)
    neg = ((1.0 - labels) * present).to(torch.int32)
    pos_counts = _bin_sums(idx, pos, num_bins)
    neg_counts = _bin_sums(idx, neg, num_bins)
    return [
        HistogramBin(
            i / num_bins, (i + 1) / num_bins, int(pos_counts[i]), int(neg_counts[i])
        )
        for i in range(num_bins)
    ]


def hosmer_lemeshow_test(
    bins: List[HistogramBin], binning_msg: str = ""
) -> HosmerLemeshowReport:
    """Chi-square over the binned histogram (HosmerLemeshowDiagnostic.scala:
    46-105 semantics, including the per-side zero-expected guard)."""
    from scipy.stats import chi2 as chi2_dist

    msgs: List[str] = []
    score = 0.0
    for b in bins:
        if b.expected_pos > 0:
            score += (b.observed_pos - b.expected_pos) ** 2 / float(b.expected_pos)
        if b.expected_pos < MINIMUM_EXPECTED_IN_BUCKET:
            msgs.append(
                f"For bin [{b.lower:.4f}, {b.upper:.4f}), expected positive count "
                "is too small to soundly use in a Chi^2 estimate"
            )
        if b.expected_neg > 0:
            score += (b.observed_neg - b.expected_neg) ** 2 / float(b.expected_neg)
        if b.expected_neg < MINIMUM_EXPECTED_IN_BUCKET:
            msgs.append(
                f"For bin [{b.lower:.4f}, {b.upper:.4f}), expected negative count "
                "is too small to soundly use in a Chi^2 estimate"
            )

    dof = max(len(bins) - 2, 1)
    dist = chi2_dist(dof)
    cutoffs = [(lvl, float(dist.ppf(lvl))) for lvl in STANDARD_CONFIDENCE_LEVELS]
    prob = float(dist.cdf(score))
    return HosmerLemeshowReport(binning_msg, "\n".join(msgs), score, dof, prob, cutoffs, bins)


def diagnose(
    model: GeneralizedLinearModel,
    batch: GLMBatch,
    num_bins: Optional[int] = None,
) -> HosmerLemeshowReport:
    """Full HL diagnostic on a logistic model over one batch."""
    if model.task != TaskType.LOGISTIC_REGRESSION:
        raise ValueError("Hosmer-Lemeshow requires a logistic regression model")
    predicted = model.compute_mean_functions(batch)
    n = int(torch.sum(batch.weights > 0.0))
    if num_bins is None:
        msg, num_bins = default_bin_count(n, batch.dim)
    else:
        msg = f"Fixed bin count: {num_bins}"
    bins = bin_scores(predicted, batch.labels, num_bins, batch.weights)
    return hosmer_lemeshow_test(bins, msg)


def to_section(report: HosmerLemeshowReport) -> SectionReport:
    """Physical-report transformer (NaiveHosmerLemeshowToPhysicalReport-
    Transformer.scala parity): histogram table, calibration plot, chi2 text."""
    rows = [
        [f"[{b.lower:.3f}, {b.upper:.3f})", b.observed_pos, b.expected_pos,
         b.observed_neg, b.expected_neg]
        for b in report.histogram
    ]
    mids = [(b.lower + b.upper) / 2.0 for b in report.histogram]
    total = [max(b.observed_pos + b.observed_neg, 1) for b in report.histogram]
    observed_freq = [
        b.observed_pos / t for b, t in zip(report.histogram, total)
    ]
    items: List[object] = [
        SimpleTextReport(report.binning_msg),
        SimpleTextReport(report.test_description()),
        TableReport(
            ["Score range", "Pos observed", "Pos expected", "Neg observed", "Neg expected"],
            rows,
            caption="Predicted probability vs observed frequency",
        ),
        PlotReport(
            title="Calibration (Hosmer-Lemeshow)",
            x_label="Predicted probability (bin midpoint)",
            y_label="Observed positive frequency",
            series={
                "observed": (mids, observed_freq),
                "perfectly calibrated": (mids, mids),
            },
        ),
        TableReport(
            ["Confidence level", "Chi^2 cutoff"],
            [[lvl, cut] for lvl, cut in report.confidence_cutoffs],
            caption="Chi^2 cutoffs at standard confidence levels "
            f"(d.o.f. = {report.degrees_of_freedom})",
        ),
    ]
    if report.chi_square_msg:
        items.insert(2, SimpleTextReport(report.chi_square_msg))
    return SectionReport("Hosmer-Lemeshow calibration", items)
