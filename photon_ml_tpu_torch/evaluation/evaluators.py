"""Evaluators on tensors (port of photon_ml_tpu/evaluation/evaluators.py).

Reference spec: evaluation/Evaluator.scala:24-75 (evaluate + betterThan),
the AUC / RMSE / loss evaluators, PrecisionAtKEvaluator.scala:35-85 and
EvaluatorType.scala. AUC is the exact weighted Mann-Whitney statistic
through one sort + cumsum + searchsorted (ties get 0.5 credit). Rows with
weight 0 are padding and drop out of every metric.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional

import torch

from photon_ml_tpu_torch.ops import losses as losses_mod

Tensor = torch.Tensor


class EvaluatorType(enum.Enum):
    AUC = "AUC"
    RMSE = "RMSE"
    PRECISION_AT_K = "PRECISION_AT_K"
    LOGISTIC_LOSS = "LOGISTIC_LOSS"
    POISSON_LOSS = "POISSON_LOSS"
    SQUARED_LOSS = "SQUARED_LOSS"
    SMOOTHED_HINGE_LOSS = "SMOOTHED_HINGE_LOSS"


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



def _weighted_mean(v: Tensor, weights: Optional[Tensor]) -> Tensor:
    if weights is None:
        return torch.mean(v)
    return torch.sum(v * weights) / torch.clamp_min(torch.sum(weights), 1e-30)


def rmse(scores: Tensor, labels: Tensor, weights: Optional[Tensor] = None) -> Tensor:
    return torch.sqrt(_weighted_mean(torch.square(scores - labels), weights))


def _loss_mean(loss) -> Callable:
    def fn(scores, labels, weights=None):
        return _weighted_mean(loss.loss(scores, labels), weights)

    return fn


logistic_loss = _loss_mean(losses_mod.logistic)
squared_loss = _loss_mean(losses_mod.squared)
poisson_loss = _loss_mean(losses_mod.poisson)
smoothed_hinge_loss = _loss_mean(losses_mod.smoothed_hinge)


def precision_at_k(scores: Tensor, labels: Tensor, group_ids: Tensor, k: int,
                   weights: Optional[Tensor] = None) -> Tensor:
    """Mean over groups of (positives in the group's top-K by score) / K
    (PrecisionAtKEvaluator.scala:59-78); rows with weight 0 are excluded."""
    if weights is None:
        weights = torch.ones_like(scores)
    valid = weights > 0.0
    n = scores.shape[0]
    big = torch.where(valid, group_ids.long(), torch.full_like(group_ids.long(), 2 ** 30))
    # by group ascending, then score descending (a stable two-key sort)
    by_score = torch.argsort(-scores, stable=True)
    order = by_score[torch.argsort(big[by_score], stable=True)]
    g_sorted = big[order]
    first_pos = torch.searchsorted(g_sorted, g_sorted, side="left")
    rank = torch.arange(n, device=scores.device) - first_pos
    v_sorted = valid[order]
    hits = (rank < k) & v_sorted & (labels[order] > 0.5)
    starts = torch.cat([torch.ones(1, dtype=torch.bool, device=scores.device),
                        g_sorted[1:] != g_sorted[:-1]])
    num_groups = torch.sum(starts & v_sorted)
    return torch.sum(hits) / torch.clamp_min(num_groups * k, 1)


@dataclasses.dataclass(frozen=True)
class Evaluator:
    """Metric and direction (Evaluator.betterThan parity)."""

    etype: EvaluatorType
    fn: Callable
    larger_is_better: bool
    k: Optional[int] = None

    def evaluate(self, scores, labels, weights=None, group_ids=None) -> Tensor:
        if self.etype == EvaluatorType.PRECISION_AT_K:
            return self.fn(scores, labels, group_ids, self.k, weights)
        return self.fn(scores, labels, weights)

    def better_than(self, a: float, b: float) -> bool:
        return a > b if self.larger_is_better else a < b


def evaluator_for(etype: EvaluatorType, k: int = 10) -> Evaluator:
    table = {
        EvaluatorType.AUC: (area_under_roc_curve, True),
        EvaluatorType.RMSE: (rmse, False),
        EvaluatorType.LOGISTIC_LOSS: (logistic_loss, False),
        EvaluatorType.POISSON_LOSS: (poisson_loss, False),
        EvaluatorType.SQUARED_LOSS: (squared_loss, False),
        EvaluatorType.SMOOTHED_HINGE_LOSS: (smoothed_hinge_loss, False),
        EvaluatorType.PRECISION_AT_K: (precision_at_k, True),
    }
    fn, larger = table[etype]
    return Evaluator(etype, fn, larger, k if etype == EvaluatorType.PRECISION_AT_K else None)
