"""Dense feature matrix for batched GLM math (port of the ``DenseFeatures``
half of photon_ml_tpu/ops/features.py; the padded-sparse layout is not yet
ported).

Contractions accumulate in ``_acc_dtype``: float32 for bf16/f32 storage,
float64 for f64 storage. ``x_bf16 @ w_bf16`` in torch returns bf16, which
would round every margin to 8 bits; the JAX code asks for
``preferred_element_type=f32``. So both operands are rounded to the storage
type first (the products are then the same) and upcast, and the contraction
runs and returns in the accumulation type.
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


def _acc_dtype(storage_dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if storage_dtype == torch.float64 else torch.float32


def _round_to(v: Tensor, storage: torch.dtype) -> Tensor:
    """``v`` rounded to the storage type, returned in its accumulation type."""
    return v.to(storage).to(_acc_dtype(storage))


@dataclasses.dataclass
class DenseFeatures:
    """Dense (N, D) feature matrix, stored in bf16, f32 or f64."""

    matrix: Tensor  # (N, D)

    @property
    def num_rows(self) -> int:
        return self.matrix.shape[0]

    @property
    def dim(self) -> int:
        return self.matrix.shape[1]

    def to_dense(self) -> Tensor:
        return self.matrix.to(_acc_dtype(self.matrix.dtype))

    def matvec(self, w: Tensor) -> Tensor:
        return self.to_dense() @ _round_to(w, self.matrix.dtype)

    def rmatvec(self, d: Tensor) -> Tensor:
        return _round_to(d, self.matrix.dtype) @ self.to_dense()

    def sq_rmatvec(self, d: Tensor) -> Tensor:
        acc = _acc_dtype(self.matrix.dtype)
        return d.to(acc) @ torch.square(self.to_dense())
