"""Per-host factored random-effect coordinate (port of
photon_ml_tpu/parallel/perhost_factored.py).

The multihost analogue of the reference's cluster-side factored coordinate
(FactoredRandomEffectCoordinate.scala:36-285): per-entity latent
coefficients ``v_e`` live on the rank that OWNS the entity (the per-host
block of :class:`~photon_ml_tpu_torch.parallel.perhost_ingest.
ShardedREData`), the shared latent matrix M is replicated, and each update

  (a) solves the rank's entities' latent coefficients over its block
      projected by M (no collective: entities are independent);
  (b) refits M with the rank's data value, gradient and Hv summed over the
      ranks in rank order, so every rank walks one trajectory on M — the
      reference's treeAggregate over executors.

The block must be built by ``per_host_re_dataset(projector="IDENTITY")``:
the factored model projects the GLOBAL shard space through M.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.algorithm.factored_random_effect import (
    FactoredRandomEffectCoordinate,
    FactoredState,
    MFOptimizationConfig,
)
from photon_ml_tpu_torch.data.game import RandomEffectDataset
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optim.common import OptimizerConfig
from photon_ml_tpu_torch.parallel.mesh import MeshContext
from photon_ml_tpu_torch.parallel.perhost_ingest import ShardedREData, _unpack_u64
from photon_ml_tpu_torch.types import OptimizerType, TaskType

Tensor = torch.Tensor


@dataclasses.dataclass
class PerHostFactoredRandomEffectCoordinate:
    """Drop-in CoordinateDescent coordinate over a per-host IDENTITY block.
    The state is a :class:`FactoredState` whose ``v`` is the rank's block
    and whose ``matrix`` is replicated."""

    data: ShardedREData
    task: TaskType
    mf_config: MFOptimizationConfig = dataclasses.field(default_factory=MFOptimizationConfig)
    re_optimizer: OptimizerType = OptimizerType.LBFGS
    re_optimizer_config: Optional[OptimizerConfig] = None
    re_regularization: RegularizationContext = dataclasses.field(
        default_factory=RegularizationContext.none)
    latent_optimizer: OptimizerType = OptimizerType.LBFGS
    latent_optimizer_config: Optional[OptimizerConfig] = None
    latent_regularization: RegularizationContext = dataclasses.field(
        default_factory=RegularizationContext.none)
    ctx: MeshContext = None  # type: ignore[assignment]

    @property
    def cd_jit(self) -> bool:
        """The fused cycle refuses the coordinate across ranks (the JAX
        ``cd_jit = process_count() == 1``)."""
        return self.ctx.world == 1

    # the checkpoint gathers v across ranks; M is replicated
    rank_sharded_leaves = (0,)

    def __post_init__(self):
        d = self.data
        if d.projector != "IDENTITY":
            raise ValueError(
                "PerHostFactoredRandomEffectCoordinate requires blocks built with "
                f"per_host_re_dataset(projector='IDENTITY') — got {d.projector!r} (the latent "
                "matrix projects the global shard space)")
        none = torch.zeros((1,), dtype=torch.int32, device=d.x.device)
        block = RandomEffectDataset(
            row_index=d.row_index, x=d.x, labels=d.labels, base_offsets=d.base_offsets,
            weights=d.weights, entity_pos=none, feat_idx=none[None],
            feat_val=none[None].to(d.x.dtype), local_to_global=d.local_to_global,
            num_entities=d.x.shape[0], global_dim=d.global_dim)
        # one inner coordinate for the instance: the refit's collective and
        # every closure it builds are made here once, not per call
        self.inner = FactoredRandomEffectCoordinate(
            block, self.task, mf_config=self.mf_config, re_optimizer=self.re_optimizer,
            re_optimizer_config=self.re_optimizer_config,
            re_regularization=self.re_regularization,
            latent_optimizer=self.latent_optimizer,
            latent_optimizer_config=self.latent_optimizer_config,
            latent_regularization=self.latent_regularization, collective=self.ctx.sum)

    @property
    def latent_dim(self) -> int:
        return self.mf_config.latent_space_dimension

    def initial_coefficients(self) -> FactoredState:
        """Zero latent coefficients on the block and the seeded Gaussian
        matrix, identical on every rank with no collective."""
        return self.inner.initial_coefficients()

    def update(self, residual_offsets: Tensor, state: FactoredState):
        return self.inner.update(residual_offsets, state)

    def score(self, state: FactoredState) -> Tensor:
        """Owner-computes factored scoring: each rank projects its OWN rows'
        features (IDENTITY space = global index) through M, dots with its
        v-block, and one fixed-order sum merges the (N,) partials."""
        d = self.data
        if not d.row_ids_dense:
            raise ValueError("dataset was built slab_build_only from non-dense row ids; "
                             "scoring would drop out-of-range rows")
        sfi, sfv, srow = d.score_feat_idx, d.score_feat_val, d.score_row_index
        vals = torch.where(sfi >= 0, sfv, torch.zeros_like(sfv))
        xp = torch.sum(state.matrix.T[torch.clamp_min(sfi, 0).long()] * vals[:, :, None], dim=1)
        s = torch.sum(xp * state.v[torch.clamp_min(d.score_slot, 0).long()], dim=-1)
        valid = srow >= 0
        out = torch.zeros((d.num_rows,), dtype=s.dtype, device=s.device)
        out[srow[valid].long()] = s[valid]
        return self.ctx.sum(out)

    def regularization_term(self, state: FactoredState) -> Tensor:
        """The v-term summed over ranks (v is sharded) plus the M-term once
        (M is replicated)."""
        re, lat = self.re_regularization, self.latent_regularization
        v_term = re.l1_weight * torch.sum(torch.abs(state.v)) + (
            0.5 * re.l2_weight * torch.sum(torch.square(state.v)))
        m_term = lat.l1_weight * torch.sum(torch.abs(state.matrix)) + (
            0.5 * lat.l2_weight * torch.sum(torch.square(state.matrix)))
        return self.ctx.sum(v_term.reshape(1))[0] + m_term

    def random_effect_coefficients(self, state: FactoredState) -> Tensor:
        """The rank's block of the equivalent plain coefficients W = V M
        (stays sharded, so the model save writes per-host part files)."""
        return state.v @ state.matrix

    def latent_factors_by_raw_id(self, state: FactoredState) -> Dict[str, np.ndarray]:
        """Raw id -> latent vector for this rank's entities."""
        d = self.data
        keys_h = d.entity_keys.cpu().numpy()
        keys = _unpack_u64(keys_h[:, 0], keys_h[:, 1])
        v = state.v.detach().cpu().numpy()
        return {d.raw_ids_by_key[int(keys[lane])]: np.asarray(v[lane], np.float32)
                for lane in np.nonzero(d.entity_mask.cpu().numpy())[0]}
