"""Prediction–error independence analysis via Kendall's tau (port of
photon_ml_tpu/diagnostics/independence.py).

Reference spec: diagnostics/independence/ — KendallTauAnalysis.scala:32-95
subsamples ~sqrt(n) points, counts concordant / discordant / tied pairs over
the cartesian square, and reports tau-alpha, tau-beta, the normal-
approximation z score (z = tau / sqrt(2(2n+5)/(9n(n-1)))) and the two-sided
p mass; PredictionErrorIndependenceDiagnostic.scala pairs (prediction,
label - prediction).

The pair census is a vectorized (m, m) sign comparison on the batch's
device, counted in integers (exact and deterministic on the card). The
subsample is numpy's, drawn from the seed as in the JAX package, and the
census runs in float32, the precision the JAX package's census has with
64-bit types off.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.diagnostics.reporting import SectionReport, SimpleTextReport, TableReport
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.ops.objective import GLMBatch

Tensor = torch.Tensor


@dataclasses.dataclass
class KendallTauReport:
    """KendallTauReport.scala parity."""

    num_concordant: int
    num_discordant: int
    num_samples: int
    num_pairs: int
    effective_pairs: int  # concordant + discordant
    tau_alpha: float
    tau_beta: float
    z_alpha: float
    p_value: float
    message: str


def _pair_census(a: Tensor, b: Tensor) -> Tuple[int, int, int, int]:
    """Count concordant/discordant/tied-in-a/tied-in-b unordered pairs."""
    sa = torch.sign(a[:, None] - a[None, :])
    sb = torch.sign(b[:, None] - b[None, :])
    upper = torch.triu(torch.ones_like(sa, dtype=torch.bool), diagonal=1)
    concordant = torch.sum((sa * sb > 0) & upper)
    discordant = torch.sum((sa * sb < 0) & upper)
    ties_a = torch.sum((sa == 0) & upper)
    # Reference tie taxonomy (KendallTauAnalysis.checkConcordance): a pair
    # tied in A is counted as TIES_IN_A regardless of B; TIES_IN_B only
    # counts pairs with distinct A values.
    ties_b = torch.sum((sa != 0) & (sb == 0) & upper)
    counts = torch.stack([concordant, discordant, ties_a, ties_b]).cpu().tolist()
    return tuple(int(c) for c in counts)


def analyze(
    a: np.ndarray, b: np.ndarray, max_points: Optional[int] = None, seed: int = 0,
    device=None,
) -> KendallTauReport:
    """Kendall-tau independence test between two draws of (A, B).

    ``max_points=None`` reproduces the reference's sqrt(n) subsample for
    n > ~10k points; smaller inputs are used whole. The census runs on
    ``device`` (default the CPU).
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    n = a.shape[0]
    if max_points is None:
        max_points = max(int(math.sqrt(n)), min(n, 2048))
    if n > max_points:
        idx = np.random.default_rng(seed).choice(n, size=max_points, replace=False)
        a, b = a[idx], b[idx]
    m = a.shape[0]

    as_f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=device)
    conc, disc, ties_a, ties_b = _pair_census(as_f32(a), as_f32(b))
    return analyze_counts(conc, disc, ties_a, ties_b, m)


def analyze_counts(
    num_concordant: int,
    num_discordant: int,
    num_ties_a: int,
    num_ties_b: int,
    num_items: int,
) -> KendallTauReport:
    """KendallTauAnalysis.analyze(counts) parity."""
    from scipy.stats import norm

    num_pairs = num_items * (num_items - 1) // 2
    no_ties_a = num_pairs - num_ties_a
    no_ties_b = num_pairs - num_ties_b
    effective = num_concordant + num_discordant
    tau_alpha = (num_concordant - num_discordant) / effective if effective else 0.0
    denom = math.sqrt(float(no_ties_a) * float(no_ties_b))
    tau_beta = (num_concordant - num_discordant) / denom if denom > 0 else 0.0

    a = 2.0 * (2.0 * num_items + 5.0)
    b = 9.0 * num_items * (num_items - 1.0)
    d = math.sqrt(a / b) if b > 0 else 1.0
    z_alpha = tau_alpha / d
    # Deviation from KendallTauAnalysis.scala:76-77 (which stores the
    # confidence mass P(|Z| <= z)): this is the actual two-sided p-value —
    # small p rejects independence, large p is consistent with it.
    p_value = float(2.0 * (1.0 - norm.cdf(abs(z_alpha))))

    message = ""
    if num_ties_a + num_ties_b > 0:
        message = (
            f"Note: detected ties (ties in first variable: {num_ties_a}, ties in "
            f"second variable: {num_ties_b}). The computed z score / p value for "
            "tau-alpha over-estimates the degree of independence between A and B."
        )
    return KendallTauReport(
        num_concordant, num_discordant, num_items, num_pairs, effective,
        tau_alpha, tau_beta, z_alpha, p_value, message,
    )


@dataclasses.dataclass
class PredictionErrorIndependenceReport:
    """(prediction, error) independence (PredictionErrorIndependenceReport
    .scala parity)."""

    kendall_tau: KendallTauReport


def diagnose(model: GeneralizedLinearModel, batch: GLMBatch) -> PredictionErrorIndependenceReport:
    """Test independence of prediction vs (label - prediction), subsampled
    with the default seed."""
    pred = model.compute_mean_functions(batch).detach().cpu().numpy()
    labels = batch.labels.detach().cpu().numpy()
    mask = batch.weights.detach().cpu().numpy() > 0.0
    pred, labels = pred[mask], labels[mask]
    return PredictionErrorIndependenceReport(
        analyze(pred, labels - pred, device=batch.device))


def to_section(report: PredictionErrorIndependenceReport) -> SectionReport:
    kt = report.kendall_tau
    items = [
        SimpleTextReport(
            "Kendall tau test of independence between model prediction and "
            "prediction error (label - prediction). Small |tau| / large p-value "
            "is consistent with independence."
        ),
        TableReport(
            ["Statistic", "Value"],
            [
                ["Samples analyzed", kt.num_samples],
                ["Total pairs", kt.num_pairs],
                ["Concordant pairs", kt.num_concordant],
                ["Discordant pairs", kt.num_discordant],
                ["Effective (untied) pairs", kt.effective_pairs],
                ["tau-alpha", kt.tau_alpha],
                ["tau-beta", kt.tau_beta],
                ["z (tau-alpha)", kt.z_alpha],
                ["two-sided p-value", kt.p_value],
            ],
        ),
    ]
    if kt.message:
        items.append(SimpleTextReport(kt.message))
    return SectionReport("Prediction / error independence", items)
