"""Metric kernels on tensors (port of the part of
photon_ml_tpu/evaluation/evaluators.py that ``metrics.evaluate`` uses).

AUC is the exact weighted Mann-Whitney statistic through one sort + cumsum +
searchsorted (ties get 0.5 credit). Rows with weight 0 are padding and drop
out of every metric.
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


def area_under_roc_curve(scores: Tensor, labels: Tensor,
                         weights: Optional[Tensor] = None) -> Tensor:
    """AUC = sum_pos w_i (W_neg<s_i + 0.5 W_neg=s_i) / (W_pos W_neg)."""
    if weights is None:
        weights = torch.ones_like(scores)
    pos_w = weights * labels
    neg_w = weights * (1.0 - labels)
    order = torch.argsort(scores)
    s_sorted = scores[order]
    cum_neg = torch.cumsum(neg_w[order], 0)
    lo = torch.searchsorted(s_sorted, scores, side="left")
    hi = torch.searchsorted(s_sorted, scores, side="right")
    zero = torch.zeros_like(scores)
    below = torch.where(lo > 0, cum_neg[torch.clamp_min(lo - 1, 0)], zero)
    upto = torch.where(hi > 0, cum_neg[torch.clamp_min(hi - 1, 0)], zero)
    numer = torch.sum(pos_w * (below + 0.5 * (upto - below)))
    return numer / torch.clamp_min(torch.sum(pos_w) * torch.sum(neg_w), 1e-30)

