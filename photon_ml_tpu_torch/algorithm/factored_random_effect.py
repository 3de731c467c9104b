"""Factored random-effect coordinate: alternating latent-space optimization
(port of photon_ml_tpu/algorithm/factored_random_effect.py).

Reference spec: algorithm/FactoredRandomEffectCoordinate.scala:36-285 and
optimization/game/FactoredRandomEffectOptimizationProblem.scala:36-138. The
model is a k-dimensional latent coefficient vector v_e per entity plus one
shared (k, d) latent matrix M (Gaussian-random at the start, without an
intercept row, FactoredRandomEffectCoordinate.scala:195-201). An update
alternates ``num_inner_iterations`` times:

  (a) project the dataset by the current M (``xp = X Mᵀ``, (E, M, k)) and
      solve every entity's GLM in the k-dimensional space, the entities
      as the lanes of one solve (``random_effect.entity_lane_fns``);
  (b) refit M as one GLM over the Kronecker features x ⊗ v_e, warm-started
      from the current M (updateLatentProjectionMatrix :218-253).

The Kronecker features are never built. A row's margin under M is
``Σ_k (x Mᵀ)_k v_k``, so step (b) is closed-form matrix products: the
gradient ``(s∘V)ᵀ X + l2·M`` with ``s = w·ℓ'`` and, for TRON, the
Hessian-vector product ``(c∘V)ᵀ X + l2·T`` with ``c = w·ℓ''·Σ_k (X Tᵀ)∘V``.
They are plain torch matrix products (the JAX package leaves them to XLA;
no Pallas kernel is behind them). Scoring gathers M's columns for each
row's features and dots them with the row's entity factors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from photon_ml_tpu_torch.algorithm.random_effect import entity_lane_fns
from photon_ml_tpu_torch.data.game import RandomEffectDataset
from photon_ml_tpu_torch.ops import losses as losses_mod
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optim import lbfgs, tron
from photon_ml_tpu_torch.optim.common import OptimizerConfig, OptResult
from photon_ml_tpu_torch.projectors import gaussian_random_projection_matrix
from photon_ml_tpu_torch.types import OptimizerType, TaskType, real_dtype

Tensor = torch.Tensor

# The seed of the initial Gaussian latent matrix (the JAX package's
# FactoredRandomEffectCoordinate default), numpy-drawn so both packages
# start from the same bytes.
LATENT_MATRIX_SEED = 1234567890


@dataclasses.dataclass(frozen=True)
class MFOptimizationConfig:
    """(numInnerIterations, latentSpaceDimension) —
    optimization/game/MFOptimizationConfiguration.scala:23-55."""

    num_inner_iterations: int = 1
    latent_space_dimension: int = 5

    @staticmethod
    def parse(config_string: str) -> "MFOptimizationConfig":
        """The command-line spelling ``numInnerIterations,latentSpaceDim``."""
        inner, latent = config_string.split(",")
        return MFOptimizationConfig(int(inner), int(latent))


@dataclasses.dataclass
class FactoredState:
    """The coordinate's parameters: per-entity latent coefficients and the
    shared matrix. ``tree_flatten``/``tree_unflatten`` give checkpoints the
    JAX pytree node's leaves and spelling (``v`` then ``matrix``)."""

    v: Tensor  # (E, k)
    matrix: Tensor  # (k, d)

    def tree_flatten(self):
        return (self.v, self.matrix), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def _default_config(optimizer: OptimizerType) -> OptimizerConfig:
    return (OptimizerConfig.tron_default() if optimizer == OptimizerType.TRON
            else OptimizerConfig.lbfgs_default())


@dataclasses.dataclass
class FactoredRandomEffectCoordinate:
    """Alternating (v, M) optimization over an IDENTITY-projection
    RandomEffectDataset (the reference factors the unprojected dataset,
    FactoredRandomEffectCoordinate.scala:147-166)."""

    dataset: RandomEffectDataset
    task: TaskType
    mf_config: MFOptimizationConfig = dataclasses.field(default_factory=MFOptimizationConfig)
    # the per-entity latent solves
    re_optimizer: OptimizerType = OptimizerType.LBFGS
    re_optimizer_config: Optional[OptimizerConfig] = None
    re_regularization: RegularizationContext = dataclasses.field(
        default_factory=RegularizationContext.none
    )
    # the latent matrix's solve
    latent_optimizer: OptimizerType = OptimizerType.LBFGS
    latent_optimizer_config: Optional[OptimizerConfig] = None
    latent_regularization: RegularizationContext = dataclasses.field(
        default_factory=RegularizationContext.none
    )

    def __post_init__(self):
        ds = self.dataset
        if ds.projection_matrix is not None or ds.local_dim != ds.global_dim:
            raise ValueError(
                "FactoredRandomEffectCoordinate requires an IDENTITY-projection "
                f"dataset (one shared local space == the global {ds.global_dim}-dim "
                f"shard space); got local_dim={ds.local_dim}"
                + (", RANDOM projection" if ds.projection_matrix is not None else "")
                + ". Build with RandomEffectDataConfig(projector='IDENTITY')."
            )
        if self.re_optimizer_config is None:
            self.re_optimizer_config = _default_config(self.re_optimizer)
        if self.latent_optimizer_config is None:
            self.latent_optimizer_config = _default_config(self.latent_optimizer)

    @property
    def latent_dim(self) -> int:
        return self.mf_config.latent_space_dimension

    def initial_coefficients(self) -> FactoredState:
        """Zero latent coefficients and the seeded Gaussian matrix (no
        intercept row)."""
        ds = self.dataset
        m0 = gaussian_random_projection_matrix(
            self.latent_dim, ds.local_dim, keep_intercept=False, seed=LATENT_MATRIX_SEED
        )
        v0 = torch.zeros((ds.num_entities, self.latent_dim), dtype=real_dtype(),
                         device=ds.device)
        return FactoredState(v=v0, matrix=torch.from_numpy(m0).to(ds.device, real_dtype()))

    # ------------------------------------------------------------------
    def _latent_fns(self, loss, x_rows, y_rows, off_rows, w_rows, v_rows):
        """Value+gradient and Hessian-vector product of the latent fit over
        the flattened matrix (k*d,), in closed form."""
        k, d = self.latent_dim, x_rows.shape[-1]
        l2 = self.latent_regularization.l2_weight

        def margins(mat):
            return torch.sum((x_rows @ mat.T) * v_rows, dim=-1) + off_rows

        def value_and_grad(m_flat):
            mat = m_flat.reshape(k, d)
            z = margins(mat)
            f = torch.sum(loss.loss(z, y_rows) * w_rows)
            s = w_rows * loss.d1(z, y_rows)
            g = ((s[:, None] * v_rows).T @ x_rows).reshape(-1)
            return f + 0.5 * l2 * torch.sum(torch.square(m_flat)), g + l2 * m_flat

        def hvp(m_flat, tangent):
            z = margins(m_flat.reshape(k, d))
            t = tangent.reshape(k, d)
            c = w_rows * loss.d2(z, y_rows) * torch.sum((x_rows @ t.T) * v_rows, dim=-1)
            return ((c[:, None] * v_rows).T @ x_rows).reshape(-1) + l2 * tangent

        return value_and_grad, hvp

    def update(self, residual_offsets: Tensor,
               state: FactoredState) -> Tuple[FactoredState, OptResult]:
        """``num_inner_iterations`` alternating updates; returns the new state
        and the last inner iteration's per-entity OptResult (lane axis)."""
        ds = self.dataset
        loss = losses_mod.for_task(self.task)
        gathered = residual_offsets[torch.clamp_min(ds.row_index, 0).long()]
        off = ds.base_offsets + torch.where(ds.row_index >= 0, gathered,
                                            torch.zeros_like(gathered))
        e, m_cap, d = ds.x.shape
        x_rows = ds.x.reshape(e * m_cap, d)
        y_rows, off_rows, w_rows = ds.labels.reshape(-1), off.reshape(-1), ds.weights.reshape(-1)
        solve = entity_lane_fns(self.task, self.re_optimizer, self.re_optimizer_config,
                                self.re_regularization)[0]
        lat_cfg = self.latent_optimizer_config

        v, mat = state.v, state.matrix
        results = None
        for _ in range(self.mf_config.num_inner_iterations):
            # (a) per-entity solves in the space projected by the current M
            results = solve(ds.x @ mat.T, ds.labels, off, ds.weights, v)
            v = results.coefficients
            # (b) the latent matrix refit, warm-started from the current M
            vg, hvp = self._latent_fns(loss, x_rows, y_rows, off_rows, w_rows,
                                       torch.repeat_interleave(v, m_cap, dim=0))
            if self.latent_optimizer == OptimizerType.TRON:
                lat = tron.tron_minimize_(vg, hvp, mat.reshape(-1), lat_cfg)
            else:
                lat = lbfgs.lbfgs_minimize(vg, mat.reshape(-1), lat_cfg,
                                           l1_weight=self.latent_regularization.l1_weight)
            mat = lat.coefficients.reshape(self.latent_dim, d)
        return FactoredState(v=v, matrix=mat), results

    # ------------------------------------------------------------------
    def score(self, state: FactoredState) -> Tensor:
        """Global (N,) scores: each row's features projected by M (a gather
        of M's columns), dotted with the row's entity factors."""
        ds = self.dataset
        ep = torch.clamp_min(ds.entity_pos, 0).long()
        cols = torch.clamp_min(ds.feat_idx, 0).long()
        valid = (ds.entity_pos[:, None] >= 0) & (ds.feat_idx >= 0)
        vals = torch.where(valid, ds.feat_val, torch.zeros_like(ds.feat_val))
        xp = torch.sum(state.matrix.T[cols] * vals[:, :, None], dim=1)  # (N, k)
        return torch.sum(xp * state.v[ep], dim=-1)

    def regularization_term(self, state: FactoredState) -> Tensor:
        """The RE regularization over the latent coefficients plus the latent
        problem's over M (getRegularizationTermValue)."""
        re, lat = self.re_regularization, self.latent_regularization
        re_term = re.l1_weight * torch.sum(torch.abs(state.v)) + (
            0.5 * re.l2_weight * torch.sum(torch.square(state.v)))
        lat_term = lat.l1_weight * torch.sum(torch.abs(state.matrix)) + (
            0.5 * lat.l2_weight * torch.sum(torch.square(state.matrix)))
        return re_term + lat_term

    def random_effect_coefficients(self, state: FactoredState) -> Tensor:
        """The plain random-effect coefficients in the original space,
        W = V M (FactoredRandomEffectModel.toRandomEffectModel)."""
        return state.v @ state.matrix
