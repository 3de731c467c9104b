"""LIBSVM text ingest -> GLM batches on a device (port of
photon_ml_tpu/io/libsvm.py).

Reference spec: io/LibSVMInputDataFormat.scala:31 and GLMSuite's intercept
handling (the intercept is appended as the last column). Parsing is the
pure-Python parser, whose semantics equal the JAX package's native loader
(``native/libsvm_parser.cpp``); loading that library from the port waits for
a later slice. Batches are padded to a multiple of 8 rows with weight 0.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.ops.features import DenseFeatures
from photon_ml_tpu_torch.ops.objective import GLMBatch
from photon_ml_tpu_torch.types import real_dtype


def _np_real():
    return np.float64 if real_dtype() == torch.float64 else np.float32


@dataclasses.dataclass
class HostDataset:
    """Parsed, still-on-host dataset (CSR)."""

    labels: np.ndarray  # (N,)
    indptr: np.ndarray  # (N+1,)
    indices: np.ndarray  # (nnz,)
    values: np.ndarray  # (nnz,)
    dim: int
    offsets: Optional[np.ndarray] = None
    weights: Optional[np.ndarray] = None

    @property
    def num_rows(self) -> int:
        return len(self.labels)


def read_libsvm(path: str, dim: Optional[int] = None, add_intercept: bool = True,
                zero_based: bool = False) -> HostDataset:
    """Parse a LIBSVM file. Labels in {-1, 1} are mapped to {0, 1}."""
    real = _np_real()
    labels: List[float] = []
    indptr = [0]
    indices: List[int] = []
    values: List[float] = []
    max_idx = -1
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            labels.append(float(parts[0]))
            for tok in parts[1:]:
                i_s, v_s = tok.split(":")
                i = int(i_s) - (0 if zero_based else 1)
                indices.append(i)
                values.append(float(v_s))
                max_idx = max(max_idx, i)
            indptr.append(len(indices))
    y = np.asarray(labels, real)
    ptr = np.asarray(indptr, np.int64)
    ind = np.asarray(indices, np.int32)
    val = np.asarray(values, np.float64).astype(real)

    if set(np.unique(y).tolist()) <= {-1.0, 1.0}:
        y = (y > 0).astype(real)
    d = dim if dim is not None else max_idx + 1
    if add_intercept:
        # append the intercept column (index d) to every row
        n = len(y)
        ind = np.insert(ind, ptr[1:], np.full(n, d, np.int32))
        val = np.insert(val, ptr[1:], np.ones(n, real))
        ptr = ptr + np.arange(n + 1, dtype=np.int64)
        d += 1
    return HostDataset(y, ptr, ind, val, d)


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def to_batch(ds: HostDataset, dense: bool = True, pad_rows_to: int = 8,
             device=None) -> GLMBatch:
    """Convert a HostDataset to a padded dense GLMBatch on ``device``
    (default cuda). Padding rows get weight 0."""
    if not dense:
        raise ValueError(
            "the sparse feature layout (D > 4096) is not yet ported to photon_ml_tpu_torch"
        )
    dev = resolve_device(device)
    real = _np_real()
    n, d = ds.num_rows, ds.dim
    n_pad = _round_up(max(n, 1), pad_rows_to)
    labels = np.zeros(n_pad, real)
    labels[:n] = ds.labels
    w = np.zeros(n_pad, real)
    w[:n] = ds.weights if ds.weights is not None else 1.0
    off = np.zeros(n_pad, real)
    if ds.offsets is not None:
        off[:n] = ds.offsets
    row_nnz = np.diff(ds.indptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), row_nnz)
    x = np.zeros((n_pad, d), real)
    x[rows, ds.indices] = ds.values
    put = lambda a: torch.from_numpy(a).to(dev)
    return GLMBatch(DenseFeatures(put(x)), put(labels), put(off), put(w))
