"""GAME model containers: fixed effect, random effect, the whole GAME model
(port of the fixed/random parts of photon_ml_tpu/models/game.py).

Reference spec: model/GAMEModel.scala:29-115 (coordinate -> sub-model, total
score = sum of sub-scores), FixedEffectModel.scala, RandomEffectModel.scala:
32-160 (a datum whose entity has no model scores 0). A random-effect model is
one stacked coefficient tensor (E, D_loc) plus the gather bookkeeping.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.types import TaskType

Tensor = torch.Tensor


@dataclasses.dataclass
class FixedEffectModel:
    """Global coefficients for one feature shard."""

    coefficients: Tensor  # (D,)
    feature_shard_id: str
    task: TaskType

    def score(self, features) -> Tensor:
        """Raw margin contribution (FixedEffectModel.scala:91-100)."""
        return features.matvec(self.coefficients)


@dataclasses.dataclass
class RandomEffectModel:
    """Stacked per-entity coefficients in a projected local space.

    ``entity_tensor_pos`` maps dense entity index -> row of ``coefficients``
    (-1 = entity unseen at train time -> scores 0).
    """

    coefficients: Tensor  # (E, D_loc)
    local_to_global: Tensor  # (E, D_loc) int32, -1 padded
    random_effect_id: str
    feature_shard_id: str
    task: TaskType
    entity_tensor_pos: Optional[np.ndarray] = None
    entity_vocab: Optional[List[str]] = None

    def score_rows(self, entity_pos: Tensor, feat_idx: Tensor, feat_val: Tensor) -> Tensor:
        """Score rows given their local projections (gather form)."""
        ep = torch.clamp_min(entity_pos, 0).long()
        li = torch.clamp_min(feat_idx, 0).long()
        coefs = self.coefficients[ep[:, None], li]
        valid = (entity_pos[:, None] >= 0) & (feat_idx >= 0)
        return torch.sum(torch.where(valid, coefs * feat_val, torch.zeros_like(coefs)), dim=-1)


@dataclasses.dataclass
class GameModel:
    """Coordinate name -> sub-model; total score = sum of sub-scores
    (GAMEModel.scala:92-94)."""

    models: Dict[str, object]
    task: TaskType

    def __getitem__(self, name: str):
        return self.models[name]

    def coordinate_names(self) -> List[str]:
        return list(self.models)
