"""Fitting diagnostic: learning curves over growing training fractions (port
of photon_ml_tpu/diagnostics/fitting.py).

Reference spec: diagnostics/fitting/FittingDiagnostic.scala:33-130 — rows
are tagged uniformly into 10 partitions; the last is held out; models are
trained on growing prefixes (10%, 20%, ... 90%) with warm start from the
previous prefix, and train/holdout metric maps are recorded per
regularization weight. Skipped when n <= 10 * dimension (MIN_SAMPLES_PER_
PARTITION_PER_DIMENSION = 10, NUM_TRAINING_PARTITIONS = 10).

A "subset" is a weight mask, not a data copy: the batch tensors stay on the
device across all prefix solves, and each prefix is one ``train_glm_grid``,
which on the card is the fused value+gradient kernel path. The partition
tags are the JAX package's draw, bit for bit, made on the host by
``utils/prng.py`` from the same seed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.diagnostics.reporting import PlotReport, SectionReport, SimpleTextReport
from photon_ml_tpu_torch.evaluation import metrics as metrics_mod
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMBatch
from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.training import train_glm_grid
from photon_ml_tpu_torch.utils import prng

NUM_TRAINING_PARTITIONS = 10
MIN_SAMPLES_PER_PARTITION_PER_DIMENSION = 10
SEED = 0  # the partition draw's seed, the JAX package's default


@dataclasses.dataclass
class FittingReport:
    """metric name -> (portions %, train values, holdout values)
    (FittingReport.scala parity)."""

    metrics: Dict[str, Tuple[List[float], List[float], List[float]]]
    message: str = ""


def partition_tags(seed: int, num_rows: int) -> np.ndarray:
    """Each row's partition, ``randint(PRNGKey(seed), (N,), 0, 10)`` bit for
    bit (int32)."""
    return prng.randint(prng.prng_key(seed), (num_rows,), 0, NUM_TRAINING_PARTITIONS)


def _masked(batch: GLMBatch, mask: torch.Tensor) -> GLMBatch:
    return GLMBatch(batch.features, batch.labels, batch.offsets, batch.weights * mask)


def diagnose(
    problem: GLMOptimizationProblem,
    batch: GLMBatch,
    norm: NormalizationContext,
    reg_weights: List[float],
) -> Dict[float, FittingReport]:
    """Learning curves per regularization weight. The first prefix starts
    cold; each later one starts from the previous prefix's models.

    Returns an empty map when the dataset is too small for a meaningful
    curve (reference behavior).
    """
    # Every one of the 10 partitions must support the model: n must exceed
    # partitions * dim * per-partition minimum. (The reference compares only
    # against dim * 10, FittingDiagnostic.scala:57-58, letting a 10% prefix
    # train on ~dim samples; the constant's intent is per-partition.)
    n_total = int(torch.sum(batch.weights > 0.0))
    min_samples = (
        batch.dim * MIN_SAMPLES_PER_PARTITION_PER_DIMENSION * NUM_TRAINING_PARTITIONS
    )
    if n_total <= min_samples:
        return {}

    tags = torch.from_numpy(partition_tags(SEED, batch.num_rows)).to(batch.device)
    dtype = batch.weights.dtype
    holdout_mask = (tags == NUM_TRAINING_PARTITIONS - 1).to(dtype)
    holdout = _masked(batch, holdout_mask)

    # per lambda: metric -> (portions, train, test)
    curves: Dict[float, Dict[str, Tuple[List[float], List[float], List[float]]]] = {
        lam: {} for lam in reg_weights
    }
    warm: Optional[Dict[float, GeneralizedLinearModel]] = None
    for max_tag in range(NUM_TRAINING_PARTITIONS - 1):
        train_mask = (tags <= max_tag).to(dtype)
        subset = _masked(batch, train_mask)
        portion = 100.0 * float(torch.sum(train_mask * (batch.weights > 0.0))) / n_total

        trained = train_glm_grid(problem, subset, norm, reg_weights, warm_start_models=warm)
        warm = trained.as_map()

        for lam, model in zip(trained.weights, trained.models):
            test_metrics = metrics_mod.evaluate(model, holdout, norm)
            train_metrics = metrics_mod.evaluate(model, subset, norm)
            for name, test_value in test_metrics.items():
                slot = curves[lam].setdefault(name, ([], [], []))
                slot[0].append(portion)
                slot[1].append(train_metrics.get(name, float("nan")))
                slot[2].append(test_value)

    return {lam: FittingReport(by_metric) for lam, by_metric in curves.items()}


def to_section(reports: Dict[float, FittingReport]) -> SectionReport:
    """FittingToPhysicalReportTransformer parity: one train-vs-holdout plot
    per (lambda, metric)."""
    items: List[object] = [
        SimpleTextReport(
            "Metrics as a function of training set size; diverging train/holdout "
            "curves indicate overfitting, jointly poor curves indicate underfitting."
        )
    ]
    for lam in sorted(reports):
        rep = reports[lam]
        sub: List[object] = []
        if rep.message:
            sub.append(SimpleTextReport(rep.message))
        for metric in sorted(rep.metrics):
            portions, train, test = rep.metrics[metric]
            finite = [t for t in train + test if np.isfinite(t)]
            if not finite:
                continue
            sub.append(
                PlotReport(
                    title=f"{metric} (lambda={lam:g})",
                    x_label="% of training data",
                    y_label=metric,
                    series={"train": (portions, train), "holdout": (portions, test)},
                )
            )
        items.append(SectionReport(f"lambda = {lam:g}", sub))
    return SectionReport("Fitting analysis (learning curves)", items)
