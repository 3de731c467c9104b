"""Per-column statistical summaries (port of photon_ml_tpu/ops/stats.py).

Reference spec: stat/BasicStatisticalSummary.scala:33-100 (Spark colStats:
mean/variance/count/numNonzeros/max/min/normL1/normL2 + meanAbs), computed
in one pass over the non-padding rows. Feeds the normalization factory.
"""

from __future__ import annotations

import dataclasses

import torch

from photon_ml_tpu_torch.ops.objective import GLMBatch

Tensor = torch.Tensor


@dataclasses.dataclass
class BasicStatisticalSummary:
    mean: Tensor
    variance: Tensor
    count: Tensor  # scalar — number of (non-padding) rows
    num_nonzeros: Tensor
    max: Tensor
    min: Tensor
    norm_l1: Tensor
    norm_l2: Tensor
    mean_abs: Tensor

    @property
    def std(self) -> Tensor:
        return torch.sqrt(torch.clamp_min(self.variance, 0.0))

    @property
    def max_magnitude(self) -> Tensor:
        return torch.maximum(torch.abs(self.max), torch.abs(self.min))


def summarize(batch: GLMBatch) -> BasicStatisticalSummary:
    """Unweighted column stats over non-padding rows (MLlib colStats ignores
    sample weights, and so does the reference)."""
    x = batch.features.to_dense()
    present = (batch.weights > 0.0).to(x.dtype)[:, None]  # (N, 1)
    n = torch.clamp_min(torch.sum(present), 1.0)
    xm = x * present
    mean = torch.sum(xm, dim=0) / n
    # unbiased variance (MLlib convention)
    var = (torch.sum(torch.square(xm), dim=0) - n * torch.square(mean)) / torch.clamp_min(n - 1.0, 1.0)
    big = torch.finfo(x.dtype).max
    rows = present > 0
    return BasicStatisticalSummary(
        mean=mean,
        variance=torch.clamp_min(var, 0.0),
        count=n,
        num_nonzeros=torch.sum((xm != 0.0).to(x.dtype), dim=0),
        max=torch.amax(torch.where(rows, x, torch.full_like(x, -big)), dim=0),
        min=torch.amin(torch.where(rows, x, torch.full_like(x, big)), dim=0),
        norm_l1=torch.sum(torch.abs(xm), dim=0),
        norm_l2=torch.sqrt(torch.sum(torch.square(xm), dim=0)),
        mean_abs=torch.sum(torch.abs(xm), dim=0) / n,
    )
