"""Feature matrices for batched GLM math (port of
photon_ml_tpu/ops/features.py).

Two layouts with one protocol (``matvec``, ``rmatvec``, ``sq_rmatvec``,
``row_sq_norms``, ``to_dense``, ``astype``), so the objective is
layout-blind:

  * ``DenseFeatures`` — an ``(N, D)`` matrix (or an ``(E, M, D)`` stack of
    lanes); every contraction is a matmul.
  * ``SparseFeatures`` — padded per-row COO, ``indices``/``values`` of
    shape ``(N, K)``; padding slots carry index 0 and value 0. The margin is
    a gather and a row sum, the transpose a scatter-add into ``(D,)`` in the
    flat ``(n, k)`` order, or, with the sorted transpose of
    ``with_transpose()``, a segment sum over column-sorted entries. Both
    transposes are deterministic on the card under
    ``torch.use_deterministic_algorithms`` (``index_add_`` then sorts;
    ``segment_reduce`` has a fixed association per column).

Contractions accumulate in ``_acc_dtype``: float32 for bf16/f32 storage,
float64 for f64 storage. ``x_bf16 @ w_bf16`` in torch returns bf16, which
would round every margin to 8 bits; the JAX code asks for
``preferred_element_type=f32``. So both operands are rounded to the storage
type first (the products are then the same) and upcast, and the contraction
runs and returns in the accumulation type.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

import numpy as np
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

    matrix: Tensor  # (N, D), or (E, M, D) for E lanes

    @property
    def num_rows(self) -> int:
        return self.matrix.shape[0]

    @property
    def dim(self) -> int:
        return self.matrix.shape[-1]

    def to_dense(self) -> Tensor:
        return self.matrix.to(_acc_dtype(self.matrix.dtype))

    def matvec(self, w: Tensor) -> Tensor:
        return _matvec(self.to_dense(), _round_to(w, self.matrix.dtype))

    def rmatvec(self, d: Tensor) -> Tensor:
        return _rmatvec(self.to_dense(), _round_to(d, self.matrix.dtype))

    def sq_rmatvec(self, d: Tensor) -> Tensor:
        return _rmatvec(torch.square(self.to_dense()), d.to(_acc_dtype(self.matrix.dtype)))


# A stack of lanes, (E, M, D) with (E, D) coefficients, contracts lane by
# lane; a single (N, D) matrix keeps the plain matrix-vector product.
def _matvec(x: Tensor, w: Tensor) -> Tensor:
    return x @ w if x.dim() == 2 else torch.matmul(x, w.unsqueeze(-1)).squeeze(-1)


def _rmatvec(x: Tensor, d: Tensor) -> Tensor:
    return d @ x if x.dim() == 2 else torch.matmul(d.unsqueeze(-2), x).squeeze(-2)


@dataclasses.dataclass
class SparseFeatures:
    """Padded per-row sparse features: ``(N, K)`` ``indices`` into the
    feature axis and ``values`` (bf16, f32 or f64 storage; contractions
    accumulate in ``_acc_dtype``), and the static width ``dim``.

    ``t_idx``/``t_row``/``t_val`` (``with_transpose()``) hold the entries
    stably sorted by column: their column, source row and value.
    ``t_len``, each column's entry count, drives the segment sum; it is
    derived from ``t_idx`` when not given.
    """

    indices: Tensor  # (N, K) int32
    values: Tensor  # (N, K)
    dim: int
    t_idx: Optional[Tensor] = None  # (nnz,) sorted column of each entry
    t_row: Optional[Tensor] = None  # (nnz,) its source row
    t_val: Optional[Tensor] = None  # (nnz,) its value
    t_len: Optional[Tensor] = None  # (dim,) int64 entries per column

    def __post_init__(self):
        if self.t_idx is not None and self.t_len is None:
            self.t_len = torch.bincount(self.t_idx.long(), minlength=self.dim)

    @property
    def num_rows(self) -> int:
        return self.indices.shape[0]

    def with_transpose(self) -> "SparseFeatures":
        """The column-sorted transpose (the analogue of a CSC view), built
        once at ingest by a stable sort on the batch's own device (the same
        permutation as the JAX package's host argsort: a stable sort has
        only one)."""
        idx = self.indices.reshape(-1)
        t_idx, order = torch.sort(idx, stable=True)
        return SparseFeatures(self.indices, self.values, self.dim, t_idx=t_idx,
                              t_row=(order // self.indices.shape[1]).to(torch.int32),
                              t_val=self.values.reshape(-1)[order],
                              t_len=torch.bincount(idx.long(), minlength=self.dim))

    def matvec(self, w: Tensor) -> Tensor:
        acc = _acc_dtype(self.values.dtype)
        prods = w[self.indices.long()].to(acc) * self.values.to(acc)
        return torch.sum(prods, dim=-1)

    def _transpose(self, vals: Tensor, d: Tensor) -> Tensor:
        """``sum_n vals[n, k] * d[n]`` into each column; ``vals`` the entry
        values (or their squares) in the accumulation type."""
        acc = vals.dtype
        if self.t_idx is not None:
            contrib = vals * d.to(acc)[self.t_row.long()]
            return torch.segment_reduce(contrib, "sum", lengths=self.t_len, unsafe=True)
        contrib = vals * d.to(acc)[:, None]
        out = torch.zeros((self.dim,), dtype=acc, device=contrib.device)
        return out.index_add_(0, self.indices.reshape(-1).long(), contrib.reshape(-1))

    def _entry_values(self) -> Tensor:
        v = self.t_val if self.t_idx is not None else self.values
        return v.to(_acc_dtype(self.values.dtype))

    def rmatvec(self, d: Tensor) -> Tensor:
        return self._transpose(self._entry_values(), d)

    def sq_rmatvec(self, d: Tensor) -> Tensor:
        return self._transpose(torch.square(self._entry_values()), d)

    def row_sq_norms(self) -> Tensor:
        return torch.sum(torch.square(self.values.to(_acc_dtype(self.values.dtype))), dim=-1)

    def to_dense(self) -> Tensor:
        acc = _acc_dtype(self.values.dtype)
        n, k = self.indices.shape
        rows = torch.arange(n, device=self.indices.device).repeat_interleave(k)
        out = torch.zeros((n * self.dim,), dtype=acc, device=self.indices.device)
        out.index_add_(0, rows * self.dim + self.indices.reshape(-1).long(),
                       self.values.reshape(-1).to(acc))
        return out.reshape(n, self.dim)

    def astype(self, dtype: torch.dtype) -> "SparseFeatures":
        """Re-store the values in another dtype (bf16 for bandwidth)."""
        return SparseFeatures(
            self.indices, self.values.to(dtype), self.dim, t_idx=self.t_idx, t_row=self.t_row,
            t_val=None if self.t_val is None else self.t_val.to(dtype), t_len=self.t_len,
        )


Features = Union[DenseFeatures, SparseFeatures]


def from_scipy_like(rows, dim: int, dtype=torch.float32, device=None) -> SparseFeatures:
    """SparseFeatures from a list of (indices, values) per row (host)."""
    from photon_ml_tpu_torch.device import resolve_device

    n = len(rows)
    k = max(max((len(ix) for ix, _ in rows), default=1), 1)
    indices = np.zeros((n, k), np.int32)
    values = np.zeros((n, k), np.float32)
    for i, (ix, vs) in enumerate(rows):
        indices[i, : len(ix)] = ix
        values[i, : len(vs)] = vs
    dev = resolve_device(device)
    return SparseFeatures(torch.from_numpy(indices).to(dev),
                          torch.from_numpy(values).to(dev, dtype), dim)


SPARSE_TRANSPOSE_ENV = "PHOTON_ML_TPU_SPARSE_TRANSPOSE"

# The layout rule, set by measurement. The JAX package keeps the scatter
# layout by default: its v5e measurement (BENCH_SELFRUN_r05) read the
# scatter-add at 1.08e6 ex/s against 0.66e6 for the sorted view at
# (N=131072, D=2^20, nnz=64). The H100 reverses the order at every width
# under deterministic algorithms: a deterministic index_add_ sorts every
# entry on each call. At N=131072 and 65 entries a row it took 2.0-2.6 ms
# by graph with uniform columns at D=4097 to 2^20, and 14.68 ms on
# bench.py:59's data at 2^20 (its intercept column holds every row),
# against 0.16-1.31 ms for the sorted view's segment sum, whose one stable
# sort on the device is paid at ingest (NVIDIA H100 80GB HBM3, 700 W;
# chip_smoke.py phase 15; PERF.md). So every sparse batch takes the sorted
# view; PHOTON_ML_TPU_SPARSE_TRANSPOSE=0 keeps the scatter layout for
# comparison, =1 (the JAX package's override) asks for the view, which is
# already the default here.


def sparse_transpose_forced() -> bool:
    """Whether ``PHOTON_ML_TPU_SPARSE_TRANSPOSE`` leaves the sorted view on
    (unset or ``1``) rather than off (``0``)."""
    return os.environ.get(SPARSE_TRANSPOSE_ENV, "1") != "0"


def auto_transpose(feats: SparseFeatures) -> SparseFeatures:
    """Apply the transpose-layout rule above."""
    if feats.t_idx is not None or not sparse_transpose_forced():
        return feats
    return feats.with_transpose()
