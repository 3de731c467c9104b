"""Random-effect coordinate: per-entity GLM solves as lanes of one solve
(port of photon_ml_tpu/algorithm/random_effect.py, without the solve
scheduler and the mesh).

Reference spec: algorithm/RandomEffectCoordinate.scala:36-201. Entities are
the leading axis of the padded ``(E, M, D_loc)`` tensors (data/game.py), so
"one optimizer per entity" is one lane-batched LBFGS or TRON solve whose
objective evaluates every entity at once. With a sparse spec
(``PHOTON_SPARSE_KERNEL``, or ``sparse_kernel``) the features are a
``SparseSlab`` built once from the dense stack; the ``pallas`` family then
runs every value+gradient through the GEVM kernel and every CG step of TRON
through the HVP kernel, one launch for all entities.

Scoring is one gather: score_n = sum_k val_nk * W[entity(n), col_nk]; rows
whose entity has no model score 0.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from photon_ml_tpu_torch.data.game import RandomEffectDataset
from photon_ml_tpu_torch.ops import fused_sparse
from photon_ml_tpu_torch.ops import losses as losses_mod
from photon_ml_tpu_torch.ops.features import DenseFeatures
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMBatch, GLMObjective
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optim import lbfgs, tron
from photon_ml_tpu_torch.optim.common import OptimizerConfig, OptResult
from photon_ml_tpu_torch.optim.problem import _split_reg_weight, variances_from_hessian_diag
from photon_ml_tpu_torch.types import OptimizerType, TaskType, real_dtype

Tensor = torch.Tensor


def entity_lane_fns(task, optimizer, optimizer_config, regularization, reg_weight=None):
    """The lane-batched solve over the entities' ``(feats, y, off, wt)``
    problems, ``feats`` a dense ``(E, M, D)`` tensor or a ``SparseSlab``:
    ``solve(feats, y, off, wt, w0) -> OptResult``, a leading lane axis on
    every field. (The resumable init/advance/result closures of the JAX
    package serve its solve scheduler, which is not ported.)
    """
    obj = GLMObjective(losses_mod.for_task(task))
    norm = NormalizationContext.identity()
    l1, l2 = _split_reg_weight(regularization, reg_weight)
    cfg = optimizer_config

    def batch_of(feats, y, off, wt):
        f = feats if isinstance(feats, fused_sparse.SparseSlab) else DenseFeatures(feats)
        return GLMBatch(f, y, off, wt)

    def vg_of(*data) -> Callable:
        batch = batch_of(*data)
        return lambda w: obj.value_and_grad(w, batch, norm, l2)

    if optimizer == OptimizerType.TRON:

        def hvp_of(*data) -> Callable:
            batch = batch_of(*data)
            return lambda w, v: obj.hessian_vector(w, v, batch, norm, l2)

        def solve(feats, y, off, wt, w0):
            data = (feats, y, off, wt)
            return tron.tron_minimize_lanes(vg_of(*data), hvp_of(*data), w0, cfg)

        return solve

    def solve(feats, y, off, wt, w0):
        return lbfgs.lbfgs_minimize_lanes(vg_of(feats, y, off, wt), w0, cfg, l1_weight=l1)

    return solve


@dataclasses.dataclass
class RandomEffectCoordinate:
    """Per-entity models over a RandomEffectDataset.

    ``sparse_kernel``: None reads ``PHOTON_SPARSE_KERNEL`` (default off =
    the dense stack); a family name builds the slab once, here, from the
    dataset's dense stack (on its device) and keeps it for every update. A
    RANDOM-projected dataset is dense in every slot, so it always solves on
    the dense stack and builds no slab.
    """

    dataset: RandomEffectDataset
    task: TaskType
    optimizer: OptimizerType = OptimizerType.LBFGS
    optimizer_config: Optional[OptimizerConfig] = None
    regularization: RegularizationContext = dataclasses.field(
        default_factory=RegularizationContext.none
    )
    solve_label: str = "re_solve"
    sparse_kernel: Optional[str] = None

    def __post_init__(self):
        if self.optimizer_config is None:
            self.optimizer_config = (
                OptimizerConfig.tron_default()
                if self.optimizer == OptimizerType.TRON
                else OptimizerConfig.lbfgs_default()
            )
        self.slab: Optional[fused_sparse.SparseSlab] = None
        spec = fused_sparse.resolve_sparse_kernel(self.sparse_kernel)
        if spec is not None and self.dataset.projection_matrix is None:
            self.slab = fused_sparse.build_and_select(self.dataset.x, spec, self.solve_label)

    @property
    def num_entities(self) -> int:
        return self.dataset.num_entities

    @property
    def local_dim(self) -> int:
        return self.dataset.local_dim

    def initial_coefficients(self) -> Tensor:
        return torch.zeros((self.num_entities, self.local_dim), dtype=real_dtype(),
                           device=self.dataset.device)

    def gathered_offsets(self, residual_offsets: Tensor) -> Tensor:
        """The global (N,) residual scores gathered into the entity-major
        (E, M) layout, plus the base offsets (RandomEffectDataSet.scala:
        57-74 addScoresToOffsets); padding slots get the base offset only."""
        ds = self.dataset
        gathered = residual_offsets[torch.clamp_min(ds.row_index, 0).long()]
        return ds.base_offsets + torch.where(ds.row_index >= 0, gathered,
                                             torch.zeros_like(gathered))

    def update(self, residual_offsets: Tensor, init_coefficients: Tensor,
               reg_weight: Optional[float] = None) -> Tuple[Tensor, OptResult]:
        """Solve every entity's local problem; returns the stacked
        coefficients (E, D_loc) and the lane-batched OptResult."""
        ds = self.dataset
        feats = self.slab if self.slab is not None else ds.x
        solve = entity_lane_fns(self.task, self.optimizer, self.optimizer_config,
                                self.regularization, reg_weight)
        results = solve(feats, ds.labels, self.gathered_offsets(residual_offsets),
                        ds.weights, init_coefficients)
        return results.coefficients, results

    def coefficient_variances(self, coefficients: Tensor, residual_offsets: Tensor) -> Tensor:
        """Per-entity variances 1 / diag(H) at the final coefficients
        (E, D_loc), on the dense stack."""
        ds = self.dataset
        obj = GLMObjective(losses_mod.for_task(self.task))
        batch = GLMBatch(DenseFeatures(ds.x), ds.labels,
                         self.gathered_offsets(residual_offsets), ds.weights)
        diag = obj.hessian_diagonal(coefficients, batch, NormalizationContext.identity(),
                                    self.regularization.l2_weight)
        return variances_from_hessian_diag(diag)

    def score(self, coefficients: Tensor) -> Tensor:
        """Global (N,) scores for all rows (active and passive)."""
        ds = self.dataset
        ep = torch.clamp_min(ds.entity_pos, 0).long()
        li = torch.clamp_min(ds.feat_idx, 0).long()
        coefs = coefficients[ep[:, None], li]
        valid = (ds.entity_pos[:, None] >= 0) & (ds.feat_idx >= 0)
        return torch.sum(torch.where(valid, coefs * ds.feat_val, torch.zeros_like(coefs)), dim=-1)

    def regularization_term(self, coefficients: Tensor,
                            reg_weight: Optional[float] = None) -> Tensor:
        """Sum of the per-entity regularization terms."""
        l1, l2 = _split_reg_weight(self.regularization, reg_weight)
        return l1 * torch.sum(torch.abs(coefficients)) + 0.5 * l2 * torch.sum(
            torch.square(coefficients))

    def global_coefficients(self, coefficients: Tensor) -> Tensor:
        return global_coefficients(self.dataset, coefficients)


def global_coefficients(dataset: RandomEffectDataset, coefficients: Tensor) -> Tensor:
    """Per-entity local coefficients back in the global feature space,
    (E, D_global) (RandomEffectModelInProjectedSpace.toRandomEffectModel
    parity): INDEX_MAP/IDENTITY scatter through local_to_global, RANDOM
    back-projects through the shared matrix (W_global = W_proj @ M)."""
    if dataset.projection_matrix is not None:
        return coefficients @ dataset.projection_matrix
    e = coefficients.shape[0]
    out = torch.zeros((e, dataset.global_dim), dtype=coefficients.dtype,
                      device=coefficients.device)
    cols = torch.clamp_min(dataset.local_to_global, 0).long()
    rows = torch.arange(e, device=cols.device)[:, None].expand_as(cols)
    vals = torch.where(dataset.local_to_global >= 0, coefficients, torch.zeros_like(coefficients))
    return out.index_put_((rows.reshape(-1), cols.reshape(-1)), vals.reshape(-1), accumulate=True)
