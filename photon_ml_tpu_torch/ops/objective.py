"""The GLM objective: value / gradient / Hessian-vector / Hessian-diagonal
(port of photon_ml_tpu/ops/objective.py).

  value(w) = sum_i weight_i * l(z_i, y_i) + l2/2 * ||w||^2
  z_i      = x_i . w_eff + margin_shift + offset_i,   w_eff = w * factor

Raw data is never normalized in memory. Padding rows carry weight 0 and
contribute an exact 0 to every sum (hard mask, so inf/nan garbage in a
padding row's loss is zeroed too).

A batch is one problem, ``(N,)`` rows of a dense ``(N, D)`` matrix or of
padded-COO ``SparseFeatures`` with ``(D,)`` coefficients, or a stack of lanes (the random effect's entities):
``(E, M)`` rows of a dense ``(E, M, D)`` stack or a ``SparseSlab``, with
``(E, D)`` coefficients; values then come back per lane, ``(E,)``. The rows
and contractions of a stack of lanes are summed through the
fixed-association ``tree_row_sum``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from photon_ml_tpu_torch.ops.features import DenseFeatures
from photon_ml_tpu_torch.ops import fused_sparse
from photon_ml_tpu_torch.ops.fused_sparse import SlabLanes, SparseSlab, tree_row_sum
from photon_ml_tpu_torch.ops.losses import PointwiseLoss
from photon_ml_tpu_torch.ops.normalization import NormalizationContext

Tensor = torch.Tensor


@dataclasses.dataclass
class GLMBatch:
    """Struct-of-arrays batch (data/LabeledPoint.scala:28-62: label,
    features, offset, weight)."""

    features: object  # DenseFeatures, SparseFeatures, SparseSlab or SlabLanes
    labels: Tensor  # (N,) or (E, M)
    offsets: Tensor  # like labels
    weights: Tensor  # like labels — 0 marks padding rows

    @property
    def num_rows(self) -> int:
        return self.labels.shape[0]

    @property
    def dim(self) -> int:
        return self.features.dim

    @property
    def device(self) -> torch.device:
        return self.labels.device

    @staticmethod
    def create(features, labels: Tensor, offsets=None, weights=None) -> "GLMBatch":
        if offsets is None:
            offsets = torch.zeros_like(labels)
        if weights is None:
            weights = torch.ones_like(labels)
        return GLMBatch(features, labels, offsets, weights)


def _wmul(weights: Tensor, x: Tensor) -> Tensor:
    """weights * x with a hard mask: padding rows (weight 0) contribute an
    exact 0 even when x is inf/nan (e.g. exp overflow on garbage padding)."""
    return torch.where(weights > 0.0, weights * x, torch.zeros_like(x))


def _is_lane_stack(features) -> bool:
    """A batch of lanes: a slab, or a dense ``(E, M, D)`` stack."""
    return (isinstance(features, (SparseSlab, SlabLanes))
            or (isinstance(features, DenseFeatures) and features.matrix.dim() == 3))


def _row_sum(features, x: Tensor) -> Tensor:
    """Row reduction per problem: the fixed-association pairwise tree for a
    stack of lanes (every sparse family and the fused kernels' wrappers
    share it, so the scalars agree across families; a lane's sum does not
    follow the lane count), a plain sum for the rows of one problem."""
    if _is_lane_stack(features):
        return tree_row_sum(x)
    return torch.sum(x, dim=-1)


def _l2_term(features, w: Tensor, l2_weight) -> Tensor:
    """l2/2 * ||w||^2 per problem, a stack's lanes summed as ``_row_sum``
    sums them: in the fixed association, which no batch changes."""
    return 0.5 * l2_weight * _row_sum(features, torch.square(w))


@dataclasses.dataclass(frozen=True)
class GLMObjective:
    """Objective bundle for one pointwise loss.

    ``fused_block_rows``: when set (by ``ops.fused_glm.select_fused_block_rows``,
    which does so on the card) and the batch is dense with bf16/f32 storage,
    ``value_and_grad`` runs the fused single-pass pieces — the CUDA kernel on
    a CUDA batch — with normalization and L2 folded around them here exactly
    as on the plain path. f64 storage is never fused.

    A ``SparseSlab`` whose ``kernel`` is ``pallas*`` (and whose values are
    not f64) takes the fused sparse pieces in ``value_and_grad`` and
    ``hessian_vector``: the GEVM and HVP kernels on a CUDA slab.
    Normalization shifts apply to single problems; the random effect's
    lanes run with the identity normalization, as in the JAX package.
    """

    loss: PointwiseLoss
    fused_block_rows: Optional[int] = None

    def margins(self, w: Tensor, batch: GLMBatch, norm: NormalizationContext) -> Tensor:
        w_eff = norm.effective_coefficients(w)
        return batch.features.matvec(w_eff) + norm.margin_shift(w_eff) + batch.offsets

    def value(self, w, batch: GLMBatch, norm: NormalizationContext, l2_weight=0.0) -> Tensor:
        z = self.margins(w, batch, norm)
        total = _row_sum(batch.features, _wmul(batch.weights, self.loss.loss(z, batch.labels)))
        return total + _l2_term(batch.features, w, l2_weight)

    def value_and_grad(self, w, batch: GLMBatch, norm: NormalizationContext,
                       l2_weight=0.0) -> Tuple[Tensor, Tensor]:
        w_eff = norm.effective_coefficients(w)
        if self._use_fused(batch):
            from photon_ml_tpu_torch.ops import fused_glm

            offsets = batch.offsets + norm.margin_shift(w_eff)
            lv, grad_eff, sum_d = fused_glm.fused_value_grad_parts(
                self.loss, batch.features.matrix, batch.labels, batch.weights,
                offsets, w_eff,
            )
            lv, grad_eff, sum_d = lv.to(w.dtype), grad_eff.to(w.dtype), sum_d.to(w.dtype)
            if norm.shifts is not None:
                grad_eff = grad_eff - norm.shifts * sum_d
        elif self._use_sparse_fused(batch):
            offsets = batch.offsets + norm.margin_shift(w_eff)
            lv, grad_eff, sum_d = fused_sparse.fused_value_grad_parts(
                self.loss, batch.features, batch.labels, batch.weights, offsets, w_eff,
            )
            lv, grad_eff, sum_d = lv.to(w.dtype), grad_eff.to(w.dtype), sum_d.to(w.dtype)
            if norm.shifts is not None:
                grad_eff = grad_eff - norm.shifts * sum_d.unsqueeze(-1)
        else:
            z = batch.features.matvec(w_eff) + norm.margin_shift(w_eff) + batch.offsets
            lv = _row_sum(batch.features, _wmul(batch.weights, self.loss.loss(z, batch.labels)))
            d = _wmul(batch.weights, self.loss.d1(z, batch.labels))
            grad_eff = batch.features.rmatvec(d)
            if norm.shifts is not None:
                grad_eff = grad_eff - norm.shifts * _row_sum(batch.features, d).unsqueeze(-1)
        grad = grad_eff * norm.factors if norm.factors is not None else grad_eff
        return lv + _l2_term(batch.features, w, l2_weight), grad + l2_weight * w

    def _use_fused(self, batch: GLMBatch) -> bool:
        """Static dispatch to the fused single-pass pieces."""
        return (
            self.fused_block_rows is not None
            and isinstance(batch.features, DenseFeatures)
            and batch.features.matrix.dtype != torch.float64
        )

    @staticmethod
    def _use_sparse_fused(batch: GLMBatch) -> bool:
        """Dispatch to the fused sparse pieces: the slab's ``kernel`` names
        the family (f64 values are never fused)."""
        return (
            isinstance(batch.features, (SparseSlab, SlabLanes))
            and batch.features.kernel.startswith("pallas")
            and batch.features.val.dtype != torch.float64
        )

    def hessian_vector(self, w, v, batch: GLMBatch, norm: NormalizationContext,
                       l2_weight=0.0) -> Tensor:
        """H(w) @ v (HessianVectorAggregator.scala:90-116 algebra, batched)."""
        w_eff = norm.effective_coefficients(w)
        v_eff = norm.effective_coefficients(v)
        if self._use_sparse_fused(batch):
            # one pass over the slab feeds both contractions and the transpose
            offsets = batch.offsets + norm.margin_shift(w_eff)
            hv_eff, sum_c = fused_sparse.fused_hvp_parts(
                self.loss, batch.features, batch.labels, batch.weights, offsets,
                w_eff, v_eff, norm.margin_shift(v_eff),
            )
            hv_eff = hv_eff.to(w.dtype)
            if norm.shifts is not None:
                hv_eff = hv_eff - norm.shifts * sum_c.to(w.dtype).unsqueeze(-1)
        else:
            z = batch.features.matvec(w_eff) + norm.margin_shift(w_eff) + batch.offsets
            d2 = _wmul(batch.weights, self.loss.d2(z, batch.labels))
            zv = batch.features.matvec(v_eff) + norm.margin_shift(v_eff)
            c = d2 * zv
            hv_eff = batch.features.rmatvec(c)
            if norm.shifts is not None:
                hv_eff = hv_eff - norm.shifts * _row_sum(batch.features, c).unsqueeze(-1)
        hv = hv_eff * norm.factors if norm.factors is not None else hv_eff
        return hv + l2_weight * v

    def hessian_diagonal(self, w, batch: GLMBatch, norm: NormalizationContext,
                         l2_weight=0.0) -> Tensor:
        """diag(H) = factor^2 * [(X^2)^T d2 - 2 shift (X^T d2) + shift^2 sum(d2)]
        + l2 (TwiceDiffFunction.scala:151-162 behavior), expanded so a sparse
        batch never densifies."""
        w_eff = norm.effective_coefficients(w)
        z = batch.features.matvec(w_eff) + norm.margin_shift(w_eff) + batch.offsets
        d2 = _wmul(batch.weights, self.loss.d2(z, batch.labels))
        diag = batch.features.sq_rmatvec(d2)
        if norm.shifts is not None:
            diag = (
                diag
                - 2.0 * norm.shifts * batch.features.rmatvec(d2)
                + torch.square(norm.shifts) * torch.sum(d2)
            )
        if norm.factors is not None:
            diag = diag * torch.square(norm.factors)
        return diag + l2_weight

    def mean_prediction(self, w, batch: GLMBatch, norm: NormalizationContext) -> Tensor:
        return self.loss.mean(self.margins(w, batch, norm))
