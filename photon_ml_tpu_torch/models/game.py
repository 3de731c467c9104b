"""GAME model containers: fixed effect, random effect, factored random
effect, matrix factorization and the whole GAME model (port of
photon_ml_tpu/models/game.py).

Reference spec: model/GAMEModel.scala:29-115 (coordinate -> sub-model, total
score = sum of sub-scores), FixedEffectModel.scala, RandomEffectModel.scala:
32-160 (a datum whose entity has no model scores 0),
FactoredRandomEffectModel.scala:30-80, MatrixFactorizationModel.scala:32-180.
A random-effect model is one stacked coefficient tensor (E, D_loc) plus the
gather bookkeeping.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.ops.fused_sparse import tree_row_sum
from photon_ml_tpu_torch.types import TaskType

Tensor = torch.Tensor


def gather_scores(coefficients: Tensor, entity_pos: Tensor, feat_idx: Tensor,
                  feat_val: Tensor) -> Tensor:
    """score_n = sum_k val_nk * coefficients[entity_pos_n, idx_nk] over
    padded-COO rows whose pad slots carry index 0 and value 0; a row with
    entity_pos -1 (no model) scores 0 (RandomEffectModel.scala:129-158).
    The scoring driver's, the server's and the training driver's validation
    gather. The K terms are summed by ``tree_row_sum``: a row's score has
    the same bits in a batch of any row count and at any zero-padded K."""
    gathered = coefficients[torch.clamp_min(entity_pos, 0)[:, None], feat_idx]
    valid = entity_pos[:, None] >= 0
    return tree_row_sum(torch.where(valid, gathered * feat_val, torch.zeros_like(gathered)))


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
class FactoredRandomEffectModel:
    """Per-entity latent coefficients and the shared latent matrix
    (model/FactoredRandomEffectModel.scala:30-80)."""

    latent_coefficients: Tensor  # (E, k)
    latent_matrix: Tensor  # (k, D_loc)
    random_effect_id: str
    feature_shard_id: str
    task: TaskType
    entity_tensor_pos: Optional[np.ndarray] = None
    entity_vocab: Optional[List[str]] = None

    def to_random_effect_model(self, local_to_global: Tensor) -> RandomEffectModel:
        """The original-space stacked coefficients W = V M
        (FactoredRandomEffectModel.toRandomEffectModel)."""
        return RandomEffectModel(
            coefficients=self.latent_coefficients @ self.latent_matrix,
            local_to_global=local_to_global,
            random_effect_id=self.random_effect_id,
            feature_shard_id=self.feature_shard_id,
            task=self.task,
            entity_tensor_pos=self.entity_tensor_pos,
            entity_vocab=self.entity_vocab,
        )


@dataclasses.dataclass
class MatrixFactorizationModel:
    """Row and column latent factors; a datum scores the dot of its row's and
    its column's factors (model/MatrixFactorizationModel.scala:32-180: the
    RDDs of (id, vector) become two stacked factor tensors)."""

    row_effect_type: str
    col_effect_type: str
    row_latent_factors: Tensor  # (R, k)
    col_latent_factors: Tensor  # (C, k)
    row_vocab: Optional[List[str]] = None
    col_vocab: Optional[List[str]] = None

    @property
    def num_latent_factors(self) -> int:
        return self.row_latent_factors.shape[-1]

    def score(self, row_ids: Tensor, col_ids: Tensor) -> Tensor:
        """(N,) scores of paired (row, column) indices; an index < 0 (no
        factor) scores 0, as the reference's cogroup drops such datums."""
        r = torch.clamp_min(row_ids, 0).long()
        c = torch.clamp_min(col_ids, 0).long()
        dots = torch.sum(self.row_latent_factors[r] * self.col_latent_factors[c], dim=-1)
        valid = (row_ids >= 0) & (col_ids >= 0)
        return torch.where(valid, dots, torch.zeros_like(dots))

    def to_summary_string(self) -> str:
        rn = np.linalg.norm(self.row_latent_factors.detach().cpu().numpy(), axis=-1)
        cn = np.linalg.norm(self.col_latent_factors.detach().cpu().numpy(), axis=-1)
        return (
            f"MatrixFactorizationModel(row={self.row_effect_type}, "
            f"col={self.col_effect_type}, k={self.num_latent_factors}): "
            f"row L2 mean={rn.mean():.4g} max={rn.max():.4g}; "
            f"col L2 mean={cn.mean():.4g} max={cn.max():.4g}"
        )


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
