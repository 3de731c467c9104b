"""Convert parameters and state between the JAX package and this port,
through numpy.

``from_jax_numpy(obj, device)`` takes a JAX package object (or a numpy/JAX
array) and returns the port's counterpart, with tensors on ``device``
(default cuda, as every entry point of the port); ``to_numpy(obj)`` takes a port
object (or tensor) and returns plain numpy data that the JAX package's
constructors accept. Objects are recognised by their class name and read by
attribute, so this module imports neither jax nor the JAX package.

Covered: arrays (per-entity coefficient matrices among them),
``Coefficients``, ``GeneralizedLinearModel``, ``NormalizationContext``,
``OptimizerConfig`` (LBFGS's and TRON's fields), ``RegularizationContext``,
``RandomEffectDataset``, ``SparseSlab``, ``SparseFeatures`` (its sorted
transpose included), ``FixedEffectModel``,
``RandomEffectModel`` and ``GameModel``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_ml_tpu_torch.data.game import RandomEffectDataset
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.models.game import FixedEffectModel, GameModel, RandomEffectModel
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.ops.features import SparseFeatures
from photon_ml_tpu_torch.ops.fused_sparse import SparseSlab
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optim.common import OptimizerConfig
from photon_ml_tpu_torch.types import RegularizationType, TaskType


def _tensor(a, device):
    if a is None:
        return None
    arr = np.array(a, copy=True)
    if arr.dtype.name == "bfloat16":  # numpy has no bf16 of its own: via f32, exactly
        return torch.from_numpy(arr.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(arr).to(device)


_SPARSE_TRANSPOSE = ("t_idx", "t_row", "t_val")


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
    if kind == "RandomEffectDataset":
        return RandomEffectDataset(
            **{f: _tensor(getattr(obj, f), device) for f in RandomEffectDataset.TENSOR_FIELDS},
            num_entities=int(obj.num_entities), global_dim=int(obj.global_dim),
            projection_matrix=_tensor(obj.projection_matrix, device),
        )
    if kind == "SparseSlab":
        return SparseSlab(_tensor(obj.idx, device), _tensor(obj.val, device), int(obj.dim),
                          str(obj.kernel))
    if kind == "SparseFeatures":
        return SparseFeatures(*(_tensor(getattr(obj, f), device) for f in ("indices", "values")),
                              int(obj.dim), **{f: _tensor(getattr(obj, f), device)
                                               for f in _SPARSE_TRANSPOSE})
    if kind == "FixedEffectModel":
        return FixedEffectModel(_tensor(obj.coefficients, device), obj.feature_shard_id,
                                TaskType(obj.task.value))
    if kind == "RandomEffectModel":
        return RandomEffectModel(
            _tensor(obj.coefficients, device), _tensor(obj.local_to_global, device),
            obj.random_effect_id, obj.feature_shard_id, TaskType(obj.task.value),
            None if obj.entity_tensor_pos is None else np.array(obj.entity_tensor_pos),
            None if obj.entity_vocab is None else list(obj.entity_vocab),
        )
    if kind == "GameModel":
        return GameModel({k: from_jax_numpy(m, device) for k, m in obj.models.items()},
                         TaskType(obj.task.value))
    return _tensor(obj, device)


def _array(t):
    """numpy of a tensor; bf16 comes back as the f32 array of the same values."""
    if t is None:
        return None
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


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
    if isinstance(obj, RandomEffectDataset):
        out = {f: _array(getattr(obj, f)) for f in RandomEffectDataset.TENSOR_FIELDS}
        return {**out, "num_entities": obj.num_entities, "global_dim": obj.global_dim,
                "projection_matrix": _array(obj.projection_matrix)}
    if isinstance(obj, SparseSlab):
        return {"idx": _array(obj.idx), "val": _array(obj.val), "dim": obj.dim,
                "kernel": obj.kernel}
    if isinstance(obj, SparseFeatures):
        return {"indices": _array(obj.indices), "values": _array(obj.values), "dim": obj.dim,
                **{f: _array(getattr(obj, f)) for f in _SPARSE_TRANSPOSE}}
    if isinstance(obj, FixedEffectModel):
        return {"coefficients": _array(obj.coefficients),
                "feature_shard_id": obj.feature_shard_id, "task": obj.task.value}
    if isinstance(obj, RandomEffectModel):
        return {"coefficients": _array(obj.coefficients),
                "local_to_global": _array(obj.local_to_global),
                "random_effect_id": obj.random_effect_id,
                "feature_shard_id": obj.feature_shard_id, "task": obj.task.value,
                "entity_tensor_pos": obj.entity_tensor_pos, "entity_vocab": obj.entity_vocab}
    if isinstance(obj, GameModel):
        return {"models": {k: to_numpy(m) for k, m in obj.models.items()},
                "task": obj.task.value}
    raise TypeError(f"no numpy form for {type(obj).__name__}")
