"""Bootstrap training: coefficient confidence intervals + metric percentiles
(port of photon_ml_tpu/bootstrap.py).

Reference spec: BootstrapTraining.scala:28-180 — draw numBootstrapSamples
resamples (with replacement), train a model grid per resample, then
aggregate (a) per-coefficient streaming summaries (CoefficientSummary:
min/max/mean/var/quartiles) and (b) per-metric summaries.

A bootstrap resample of an (N,)-row batch is a weight vector: counts drawn
from Multinomial(N, 1/N) multiply the example weights. The k replicates are
the k lanes of one LBFGS or TRON solve (``GLMOptimizationProblem.run_lanes``),
each lane stopping on its own test; the data tensors are shared, never
copied. The counts are the JAX package's draw bit for bit (``split`` then a
per-replicate ``randint`` and a scatter-add), made on the host by
``utils/prng.py`` and handed to the device as one (k, N) tensor. The solve
uses the problem as given: the GLM driver hands over its own, whose
objective is the plain two-pass one (the fused kernel is set only on the
copy ``train_glm_grid`` solves with), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np
import torch

from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMBatch
from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.types import real_dtype
from photon_ml_tpu_torch.utils import prng

Tensor = torch.Tensor

SEED = 0  # the resample draw's seed, the JAX package's default


@dataclasses.dataclass
class CoefficientSummary:
    """Distribution summary of one scalar across bootstrap replicates.

    (supervised/model/CoefficientSummary.scala parity: min/max/mean/var and
    quartile estimates; computed exactly here since k is small.)
    """

    min: float
    max: float
    mean: float
    variance: float
    q1: float
    median: float
    q3: float

    @staticmethod
    def from_samples(samples: np.ndarray) -> "CoefficientSummary":
        return CoefficientSummary(
            min=float(samples.min()),
            max=float(samples.max()),
            mean=float(samples.mean()),
            variance=float(samples.var(ddof=1)) if samples.size > 1 else 0.0,
            q1=float(np.quantile(samples, 0.25)),
            median=float(np.quantile(samples, 0.5)),
            q3=float(np.quantile(samples, 0.75)),
        )

    def contains_zero(self) -> bool:
        """CI-includes-zero check used for post-hoc feature pruning."""
        return self.min <= 0.0 <= self.max


@dataclasses.dataclass
class BootstrapResult:
    coefficient_summaries: List[CoefficientSummary]  # one per coefficient
    metric_summaries: Dict[str, CoefficientSummary]  # metric name -> summary
    models: List[GeneralizedLinearModel]  # one per replicate


def bootstrap_weights(seed: int, num_samples: int, n: int, device=None) -> Tensor:
    """(k, N) multinomial resample counts — the weight-space image of
    "sample N rows with replacement" (uniform probability)."""
    return torch.from_numpy(prng.bootstrap_counts(seed, num_samples, n)).to(device)


def bootstrap_train(
    problem: GLMOptimizationProblem,
    batch: GLMBatch,
    norm: NormalizationContext,
    num_samples: int,
    metrics_fn: Callable[[GeneralizedLinearModel], Dict[str, float]],
) -> BootstrapResult:
    """Train ``num_samples`` bootstrap replicates from zero coefficients
    and aggregate.

    ``metrics_fn`` maps a trained model to a metric map (typically
    ``lambda m: evaluation.metrics.evaluate(m, holdout_batch)``).
    """
    n = batch.num_rows
    counts = bootstrap_weights(SEED, num_samples, n, batch.device).to(batch.weights.dtype)
    resampled = [
        GLMBatch(batch.features, batch.labels, batch.offsets, batch.weights * counts[i])
        for i in range(num_samples)
    ]
    w0 = torch.zeros((num_samples, batch.dim), dtype=real_dtype(), device=batch.device)
    result = problem.run_lanes(resampled, norm, w0)
    means = result.coefficients  # (k, D)
    means_k = means.detach().cpu().numpy()

    models = [
        GeneralizedLinearModel(Coefficients(means[i]), problem.task)
        for i in range(num_samples)
    ]
    coef_summaries = [
        CoefficientSummary.from_samples(means_k[:, j]) for j in range(means_k.shape[1])
    ]

    metric_summaries: Dict[str, CoefficientSummary] = {}
    per_model = [metrics_fn(m) for m in models]
    keys = set().union(*[set(m) for m in per_model]) if per_model else set()
    for key in sorted(keys):
        vals = np.array([m[key] for m in per_model if key in m])
        metric_summaries[key] = CoefficientSummary.from_samples(vals)

    return BootstrapResult(coef_summaries, metric_summaries, models)
