"""Random-effect coordinate: per-entity GLM solves as lanes of one solve
(port of photon_ml_tpu/algorithm/random_effect.py, without the mesh).

Reference spec: algorithm/RandomEffectCoordinate.scala:36-201. Entities are
the leading axis of the padded ``(E, M, D_loc)`` tensors (data/game.py), so
"one optimizer per entity" is one lane-batched LBFGS or TRON solve whose
objective evaluates every entity at once. With a sparse spec
(``PHOTON_SPARSE_KERNEL``, or ``sparse_kernel``) the features are a
``SparseSlab`` built once from the dense stack (``auto``: when it wins the
race against the dense stack); the ``pallas`` family then
runs every value+gradient through the GEVM kernel and every CG step of TRON
through the HVP kernel, one launch for all entities. With a
``solve_schedule`` (optim/scheduler.py) the solve runs chunked and
convergence-compacted, on the host loop or the device rung loop, with the
same bits as the one-shot solve.

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
from photon_ml_tpu_torch.optim.common import FIXED_SUMS, OptimizerConfig, OptResult
from photon_ml_tpu_torch.optim.problem import _split_reg_weight, variances_from_hessian_diag
from photon_ml_tpu_torch.types import OptimizerType, TaskType, real_dtype

Tensor = torch.Tensor


def entity_lane_fns(task, optimizer, optimizer_config, regularization, reg_weight=None):
    """The lane-batched solve over the entities' ``(feats, y, off, wt)``
    problems, ``feats`` a dense ``(E, M, D)`` tensor, a ``SparseSlab`` or a
    ``SlabLanes`` view, as the resumable closures the solve scheduler
    drives (optim/scheduler.py, optim/fused_schedule.py):

      * ``solve(feats, y, off, wt, w0) -> OptResult``, the one-shot solve;
      * ``init(feats, y, off, wt, w0) -> state`` (one objective evaluation);
      * ``advance(feats, y, off, wt, state, limit, trips=None) -> state``:
        every lane to the absolute iteration bound ``limit``, on the host
        loop (``trips`` None, ``limit`` an int), or in ``trips`` fixed-trip
        iterations with no host sync (``limit`` a 0-dim tensor on the
        lanes' device: the body of a captured CUDA graph);
      * ``result(state) -> OptResult``.

    Every field of the state and the result has a leading lane axis, and a
    lane's arithmetic does not depend on the batch it rides in: the solvers
    reduce over its coefficients with ``FIXED_SUMS``.
    """
    obj = GLMObjective(losses_mod.for_task(task))
    norm = NormalizationContext.identity()
    l1, l2 = _split_reg_weight(regularization, reg_weight)
    cfg = optimizer_config

    def batch_of(feats, y, off, wt):
        f = (feats if isinstance(feats, (fused_sparse.SparseSlab, fused_sparse.SlabLanes))
             else DenseFeatures(feats))
        return GLMBatch(f, y, off, wt)

    def vg_of(*data) -> Callable:
        batch = batch_of(*data)
        return lambda w: obj.value_and_grad(w, batch, norm, l2)

    if optimizer == OptimizerType.TRON:

        def hvp_of(*data) -> Callable:
            batch = batch_of(*data)
            return lambda w, v: obj.hessian_vector(w, v, batch, norm, l2)

        def init(feats, y, off, wt, w0):
            return tron.tron_init_(vg_of(feats, y, off, wt), w0, cfg, sums=FIXED_SUMS)

        def advance(feats, y, off, wt, state, limit, trips=None):
            data = (feats, y, off, wt)
            if trips is None:
                return tron.tron_advance_(vg_of(*data), hvp_of(*data), state, cfg,
                                          iteration_limit=limit, sums=FIXED_SUMS)
            return tron.tron_chunk_(vg_of(*data), hvp_of(*data), state, cfg, limit, trips,
                                    sums=FIXED_SUMS)

        def result(state):
            return tron.tron_result(state, sums=FIXED_SUMS)

        def solve(feats, y, off, wt, w0):
            data = (feats, y, off, wt)
            return tron.tron_minimize_lanes(vg_of(*data), hvp_of(*data), w0, cfg,
                                            sums=FIXED_SUMS)

        return solve, init, advance, result

    def init(feats, y, off, wt, w0):
        return lbfgs.lbfgs_init_(vg_of(feats, y, off, wt), w0, cfg, l1_weight=l1,
                                 sums=FIXED_SUMS)

    def advance(feats, y, off, wt, state, limit, trips=None):
        vg = vg_of(feats, y, off, wt)
        if trips is None:
            return lbfgs.lbfgs_advance_(vg, state, cfg, l1_weight=l1, iteration_limit=limit,
                                        sums=FIXED_SUMS)
        return lbfgs.lbfgs_chunk_(vg, state, cfg, limit, trips, l1_weight=l1, sums=FIXED_SUMS)

    def solve(feats, y, off, wt, w0):
        return lbfgs.lbfgs_minimize_lanes(vg_of(feats, y, off, wt), w0, cfg, l1_weight=l1,
                                          sums=FIXED_SUMS)

    return solve, init, advance, lbfgs.lbfgs_result


@dataclasses.dataclass
class RandomEffectCoordinate:
    """Per-entity models over a RandomEffectDataset.

    ``sparse_kernel``: None reads ``PHOTON_SPARSE_KERNEL`` (default off =
    the dense stack); a family name builds the slab once, here, from the
    dataset's dense stack (on its device) and keeps it for every update;
    ``auto`` races the families and the dense stack on this dataset's own
    tensors and keeps the winner. A RANDOM-projected dataset is dense in
    every slot, so it always solves on the dense stack and builds no slab.
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
    bucketer: Optional[object] = None  # the slab width's ladder; None reads PHOTON_SHAPE_LADDER
    # convergence-compaction schedule (optim.scheduler.SolveSchedule, None =
    # one-shot): chunked solves whose converged lanes stop riding along
    solve_schedule: Optional[object] = None
    # a slab built elsewhere (the streaming coordinate's per-block one),
    # taken as it is; None builds one here when the spec asks for it
    sparse_slab: Optional[fused_sparse.SparseSlab] = None

    def __post_init__(self):
        if self.optimizer_config is None:
            self.optimizer_config = (
                OptimizerConfig.tron_default()
                if self.optimizer == OptimizerType.TRON
                else OptimizerConfig.lbfgs_default()
            )
        self.slab: Optional[fused_sparse.SparseSlab] = self.sparse_slab
        # chunk or rung pauses re-enter the host: the fused cycle refuses
        # a scheduled coordinate (its plan fuses per solve instead)
        self.cd_jit = self.solve_schedule is None
        # the device loop's captured rung programs, keyed by this
        # coordinate's own tensors (optim/fused_schedule.py)
        self._graphs: dict = {}
        spec = fused_sparse.resolve_sparse_kernel(self.sparse_kernel)
        if self.slab is None and spec is not None and self.dataset.projection_matrix is None:
            ds = self.dataset
            # None: the race handed the dataset back to the dense incumbent
            self.slab = fused_sparse.build_and_select(
                self.task, ds.x, ds.labels, ds.base_offsets, ds.weights, spec,
                self.solve_label, bucketer=self.bucketer)

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
               reg_weight: Optional[float] = None,
               resume: Optional[dict] = None) -> Tuple[Tensor, OptResult]:
        """Solve every entity's local problem; returns the stacked
        coefficients (E, D_loc) and the lane-batched OptResult. With a
        schedule the solve is compacted, its chunk (or rung) boundaries are
        preemption drain points, and ``resume`` (a ``kind="scheduler"``
        snapshot from one) finishes an interrupted solve bitwise."""
        ds = self.dataset
        feats = self.slab if self.slab is not None else ds.x
        data = (feats, ds.labels, self.gathered_offsets(residual_offsets), ds.weights)
        if self.solve_schedule is not None:
            from photon_ml_tpu_torch.optim.scheduler import compacted_solve

            results = compacted_solve(
                data, init_coefficients, task=self.task, optimizer=self.optimizer,
                optimizer_config=self.optimizer_config, regularization=self.regularization,
                schedule=self.solve_schedule, label=self.solve_label, resume=resume,
                reg_weight=reg_weight, graphs=self._graphs)
            return results.coefficients, results
        if resume is not None:
            raise ValueError("a resume payload needs a solve schedule: only a scheduled "
                             "solve pauses inside the coordinate")
        solve = entity_lane_fns(self.task, self.optimizer, self.optimizer_config,
                                self.regularization, reg_weight)[0]
        results = solve(*data, init_coefficients)
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
