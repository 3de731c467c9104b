"""Down-sampling within a coordinate by weights (port of
photon_ml_tpu/data/sampler.py).

Reference spec: sampler/BinaryClassificationDownSampler.scala:31-60
(negatives kept with probability ``rate``, survivors re-weighted by
1/rate) and sampler/DefaultDownSampler.scala:26-45 (a uniform sample,
survivors re-weighted by 1/rate). The reference drops rows; here a dropped
row keeps its place with weight 0, which no objective sees, so the batch's
shapes never change.

The uniform draws are ``jax.random.uniform(PRNGKey(seed), labels.shape)``
bit for bit (``utils/prng.py``), made on the host and moved to the batch's
device, so the card, the CPU and the JAX package keep the same rows.
"""

from __future__ import annotations

import numpy as np
import torch

from photon_ml_tpu_torch.ops.objective import GLMBatch
from photon_ml_tpu_torch.types import TaskType
from photon_ml_tpu_torch.utils import prng


def _draws(batch: GLMBatch, key: np.ndarray) -> torch.Tensor:
    u = prng.uniform(key, tuple(batch.labels.shape))
    return torch.from_numpy(u).to(batch.device)


def _rate(batch: GLMBatch, rate: float) -> torch.Tensor:
    """``rate`` as a float32 tensor on the batch's device: compared and
    divided as the JAX package does (a scalar operand of a CUDA division
    would become a multiplication by its reciprocal)."""
    return torch.tensor(np.float32(rate), device=batch.device)


def down_sample_binary(batch: GLMBatch, rate: float, key: np.ndarray) -> GLMBatch:
    """Keep every positive; keep a negative with probability ``rate`` and
    re-weight it by 1/rate (an unbiased gradient)."""
    u = _draws(batch, key)
    is_positive = batch.labels > 0.5
    keep = is_positive | (u < _rate(batch, rate))
    scale = torch.where(is_positive, torch.ones_like(batch.weights),
                        torch.full_like(batch.weights, np.float32(1.0 / rate)))
    new_w = torch.where(keep, batch.weights * scale, torch.zeros_like(batch.weights))
    return GLMBatch(batch.features, batch.labels, batch.offsets, new_w)


def down_sample_default(batch: GLMBatch, rate: float, key: np.ndarray) -> GLMBatch:
    """Keep each row with probability ``rate``, re-weighted by 1/rate."""
    u = _draws(batch, key)
    rate_t = _rate(batch, rate)
    new_w = torch.where(u < rate_t, batch.weights / rate_t, torch.zeros_like(batch.weights))
    return GLMBatch(batch.features, batch.labels, batch.offsets, new_w)


def maybe_down_sample(batch: GLMBatch, task: TaskType, rate, seed: int) -> GLMBatch:
    """The task's sampler (GeneralizedLinearOptimizationProblem.downSample):
    the binary one for logistic regression, the uniform one otherwise; the
    batch unchanged when ``rate`` is None or at least 1."""
    if rate is None or rate >= 1.0:
        return batch
    sampler = down_sample_binary if task == TaskType.LOGISTIC_REGRESSION else down_sample_default
    return sampler(batch, rate, prng.prng_key(seed))
