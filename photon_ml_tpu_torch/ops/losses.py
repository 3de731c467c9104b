"""Pointwise GLM losses on the margin ``z = x.w + offset`` (port of
photon_ml_tpu/ops/losses.py).

Each loss exposes ``loss(z, y)``, ``d1(z, y)`` (dl/dz), ``d2(z, y)``
(d2l/dz2) and ``mean(z)`` (the GLM mean function). All are elementwise,
dtype-preserving and numerically stable. ``kernel_id`` names the loss inside
the CUDA kernel (csrc/fused_glm.cu), whose device functions follow the same
formulas.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PointwiseLoss:
    name: str
    loss: Callable[[Tensor, Tensor], Tensor]
    d1: Callable[[Tensor, Tensor], Tensor]
    d2: Callable[[Tensor, Tensor], Tensor]
    mean: Callable[[Tensor], Tensor]
    kernel_id: int
    # smoothed hinge is first-order only (SmoothedHingeLossFunction.scala:26)
    twice_differentiable: bool = True


# Logistic: log(1 + e^z) - y z, y in {0, 1}; stable form below.
def _logistic_loss(z: Tensor, y: Tensor) -> Tensor:
    return torch.clamp_min(z, 0.0) + torch.log1p(torch.exp(-torch.abs(z))) - y * z


def _logistic_d1(z: Tensor, y: Tensor) -> Tensor:
    return torch.sigmoid(z) - y


def _logistic_d2(z: Tensor, y: Tensor) -> Tensor:
    s = torch.sigmoid(z)
    return s * (1.0 - s)


logistic = PointwiseLoss(
    name="LOGISTIC",
    loss=_logistic_loss,
    d1=_logistic_d1,
    d2=_logistic_d2,
    mean=torch.sigmoid,
    kernel_id=0,
)

# Squared: (z - y)^2 / 2
squared = PointwiseLoss(
    name="SQUARED",
    loss=lambda z, y: 0.5 * torch.square(z - y),
    d1=lambda z, y: z - y,
    d2=lambda z, y: torch.ones_like(z),
    mean=lambda z: z,
    kernel_id=1,
)

# Poisson: e^z - y z (negative log-likelihood up to a constant)
poisson = PointwiseLoss(
    name="POISSON",
    loss=lambda z, y: torch.exp(z) - y * z,
    d1=lambda z, y: torch.exp(z) - y,
    d2=lambda z, y: torch.exp(z),
    mean=torch.exp,
    kernel_id=2,
)


# Rennie smoothed hinge on t = (2y - 1) z:
#   1/2 - t for t <= 0;  (1 - t)^2 / 2 for 0 < t < 1;  0 for t >= 1
def _hinge_t(z: Tensor, y: Tensor) -> Tensor:
    return (2.0 * y - 1.0) * z


def _smoothed_hinge_loss(z: Tensor, y: Tensor) -> Tensor:
    t = _hinge_t(z, y)
    zero = torch.zeros_like(t)
    return torch.where(t <= 0.0, 0.5 - t, torch.where(t < 1.0, 0.5 * torch.square(1.0 - t), zero))


def _smoothed_hinge_d1(z: Tensor, y: Tensor) -> Tensor:
    t = _hinge_t(z, y)
    zero = torch.zeros_like(t)
    dldt = torch.where(t <= 0.0, -torch.ones_like(t), torch.where(t < 1.0, t - 1.0, zero))
    return (2.0 * y - 1.0) * dldt


def _smoothed_hinge_d2(z: Tensor, y: Tensor) -> Tensor:
    t = _hinge_t(z, y)
    return ((t > 0.0) & (t < 1.0)).to(z.dtype)


smoothed_hinge = PointwiseLoss(
    name="SMOOTHED_HINGE",
    loss=_smoothed_hinge_loss,
    d1=_smoothed_hinge_d1,
    d2=_smoothed_hinge_d2,
    mean=lambda z: z,
    kernel_id=3,
    twice_differentiable=False,
)

_BY_TASK = {
    "LOGISTIC_REGRESSION": logistic,
    "LINEAR_REGRESSION": squared,
    "POISSON_REGRESSION": poisson,
    "SMOOTHED_HINGE_LOSS_LINEAR_SVM": smoothed_hinge,
}


def for_task(task) -> PointwiseLoss:
    """Look up the pointwise loss for a TaskType (enum or string)."""
    return _BY_TASK[getattr(task, "value", task)]
