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


# On a CPU tensor torch's vectorized elementwise loops compute the elements
# that do not fill a last pair of vector registers with scalar code
# (``vectorized_loop`` in aten/src/ATen/native/cpu/Loops.h hands the rest
# to ``basic_loop``), and a loop over more than ``at::internal::GRAIN_SIZE``
# (32768, aten/src/ATen/Parallel.h) elements is split between threads,
# each part with its own tail. The scalar exp, log1p and sigmoid can differ
# from the vector ones in the last bit, so an element's bits would depend
# on where it sits in its tensor. The solve scheduler's compacted batches
# move a lane's rows to other places, so on a CPU these functions run a
# lane batch (two axes or more) over zero-padded flat blocks of whole
# vectors, each under the grain: every element takes the vector code
# wherever it sits. One problem (one axis) has no batch and runs as it is.
# tests/test_torch_ops.py places one lane at every offset to catch a torch
# that breaks this. (A CUDA kernel computes every element alike.)
_CPU_BLOCK = 16384  # elements a block: whole vector pairs, below the 32768 grain
_CPU_VECTORS = 64  # a multiple of two vector registers of floats or doubles


def _every_element_alike(fn: Callable[[Tensor], Tensor]) -> Callable[[Tensor], Tensor]:
    def apply(t: Tensor) -> Tensor:
        if t.is_cuda or t.dim() < 2 or t.numel() == 0:
            return fn(t)
        flat = t.reshape(-1)
        n = flat.numel()
        if n % _CPU_VECTORS:
            flat = torch.cat([flat, flat.new_zeros(_CPU_VECTORS - n % _CPU_VECTORS)])
        out = torch.cat([fn(flat[i:i + _CPU_BLOCK]) for i in range(0, flat.numel(), _CPU_BLOCK)])
        return out[:n].reshape(t.shape)

    return apply


_exp = _every_element_alike(torch.exp)
_log1p = _every_element_alike(torch.log1p)
_sigmoid = _every_element_alike(torch.sigmoid)


# Logistic: log(1 + e^z) - y z, y in {0, 1}; stable form below.
def _logistic_loss(z: Tensor, y: Tensor) -> Tensor:
    return torch.clamp_min(z, 0.0) + _log1p(_exp(-torch.abs(z))) - y * z


def _logistic_d1(z: Tensor, y: Tensor) -> Tensor:
    return _sigmoid(z) - y


def _logistic_d2(z: Tensor, y: Tensor) -> Tensor:
    s = _sigmoid(z)
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
    loss=lambda z, y: _exp(z) - y * z,
    d1=lambda z, y: _exp(z) - y,
    d2=lambda z, y: _exp(z),
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
