"""Convert parameters and state between the JAX package and this port,
through numpy.

``from_jax_numpy(obj, device)`` takes a JAX package object (or a numpy/JAX
array) and returns the port's counterpart, with tensors on ``device``
(default cuda, as every entry point of the port); ``to_numpy(obj)`` takes a port
object (or tensor) and returns plain numpy data that the JAX package's
constructors accept. Objects are recognised by their class name and read by
attribute, so this module imports neither jax nor the JAX package.

Covered: arrays, ``Coefficients``, ``GeneralizedLinearModel``,
``NormalizationContext``, ``OptimizerConfig`` and ``RegularizationContext``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optim.common import OptimizerConfig
from photon_ml_tpu_torch.types import RegularizationType, TaskType


def _tensor(a, device):
    if a is None:
        return None
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_jax_numpy(obj, device=None):
    """The port's counterpart of a JAX package object or array."""
    device = resolve_device(device)
    kind = type(obj).__name__
    if kind == "Coefficients":
        return Coefficients(_tensor(obj.means, device), _tensor(obj.variances, device))
    if kind == "GeneralizedLinearModel":
        return GeneralizedLinearModel(
            from_jax_numpy(obj.coefficients, device), TaskType(obj.task.value)
        )
    if kind == "NormalizationContext":
        return NormalizationContext(
            _tensor(obj.factors, device), _tensor(obj.shifts, device), obj.intercept_id
        )
    if kind == "OptimizerConfig":
        return OptimizerConfig(**{
            f.name: getattr(obj, f.name) for f in dataclasses.fields(OptimizerConfig)
        })
    if kind == "RegularizationContext":
        return RegularizationContext(
            RegularizationType(obj.reg_type.value), float(obj.reg_weight),
            float(obj.elastic_net_alpha),
        )
    return _tensor(obj, device)


def _array(t):
    return None if t is None else t.detach().cpu().numpy()


def to_numpy(obj):
    """Plain numpy data of a port object: an array for a tensor, else a dict
    of the fields the JAX package's constructor takes (enums as their
    string values)."""
    if isinstance(obj, torch.Tensor):
        return _array(obj)
    if isinstance(obj, Coefficients):
        return {"means": _array(obj.means), "variances": _array(obj.variances)}
    if isinstance(obj, GeneralizedLinearModel):
        return {"coefficients": to_numpy(obj.coefficients), "task": obj.task.value}
    if isinstance(obj, NormalizationContext):
        return {"factors": _array(obj.factors), "shifts": _array(obj.shifts),
                "intercept_id": obj.intercept_id}
    if isinstance(obj, OptimizerConfig):
        return dataclasses.asdict(obj)
    if isinstance(obj, RegularizationContext):
        return {"reg_type": obj.reg_type.value, "reg_weight": obj.reg_weight,
                "elastic_net_alpha": obj.elastic_net_alpha}
    raise TypeError(f"no numpy form for {type(obj).__name__}")
