"""LIBSVM text ingest -> GLM batches on a device (port of
photon_ml_tpu/io/libsvm.py).

Reference spec: io/LibSVMInputDataFormat.scala:31 and GLMSuite's intercept
handling (the intercept is appended as the last column). Files parse
through the native C++ loader (``native/libsvm_parser.cpp``, shared with the
JAX package and built by ``native_build.build_host``); the pure-Python
parser of the same semantics runs when ``PHOTON_ML_TPU_NATIVE=0`` asks for
it or when the loader flags a malformed token (the Python parser then raises
the real error). ``parse_counts`` counts the files each parser read. Batches
are padded to a multiple of 8 rows with weight 0, dense ``(N, D)`` or, with
``dense=False``, padded-COO ``SparseFeatures`` (the transpose layout by
``ops.features.auto_transpose``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch import native_build
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.ops.features import DenseFeatures, SparseFeatures, auto_transpose
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


# files parsed since import, by the native loader and by the Python parser
parse_counts = {"native_files": 0, "python_files": 0}


def _load_lsv_native():
    """The parser library, built on first use; None when
    ``PHOTON_ML_TPU_NATIVE=0`` asks for the Python parser."""
    if not native_build.native_enabled():
        return None

    def configure(lib):
        lib.lsv_parse.restype = ctypes.c_void_p
        lib.lsv_parse.argtypes = [ctypes.c_char_p, ctypes.c_int]
        for fn in (lib.lsv_rows, lib.lsv_nnz, lib.lsv_max_index):
            fn.restype = ctypes.c_long
            fn.argtypes = [ctypes.c_void_p]
        lib.lsv_ok.restype = ctypes.c_int
        lib.lsv_ok.argtypes = [ctypes.c_void_p]
        lib.lsv_fill.restype = None
        lib.lsv_fill.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.lsv_free.restype = None
        lib.lsv_free.argtypes = [ctypes.c_void_p]

    return native_build.load_host("libsvm_parser.cpp", configure)


def _parse_libsvm_native(path: str, zero_based: bool):
    """(labels f64, indptr i64, indices i32, values f64, max index), or None
    when native parsing is switched off, the file cannot be opened or a
    token is malformed (the Python parser then raises the real error)."""
    lib = _load_lsv_native()
    if lib is None:
        return None
    h = lib.lsv_parse(path.encode(), 1 if zero_based else 0)
    if not h:
        return None
    try:
        if not lib.lsv_ok(h):
            return None
        n, nnz = lib.lsv_rows(h), lib.lsv_nnz(h)
        labels = np.empty(n, np.float64)
        indptr = np.empty(n + 1, np.int64)
        indices = np.empty(max(nnz, 1), np.int32)
        values = np.empty(max(nnz, 1), np.float64)
        lib.lsv_fill(
            h,
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        return labels, indptr, indices[:nnz], values[:nnz], int(lib.lsv_max_index(h))
    finally:
        lib.lsv_free(h)


def _parse_libsvm_python(path: str, zero_based: bool):
    """The same five arrays from the pure-Python parser."""
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
    return (np.asarray(labels, np.float64), np.asarray(indptr, np.int64),
            np.asarray(indices, np.int32), np.asarray(values, np.float64), max_idx)


def read_libsvm(path: str, dim: Optional[int] = None, add_intercept: bool = True,
                zero_based: bool = False) -> HostDataset:
    """Parse a LIBSVM file. Labels in {-1, 1} are mapped to {0, 1}."""
    real = _np_real()
    parsed = _parse_libsvm_native(path, zero_based)
    if parsed is not None:
        parse_counts["native_files"] += 1
    else:
        parse_counts["python_files"] += 1
        parsed = _parse_libsvm_python(path, zero_based)
    labels, ptr, ind, values, max_idx = parsed
    y = labels.astype(real)
    val = values.astype(real)

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
    """Convert a HostDataset to a padded GLMBatch on ``device`` (default
    cuda), dense or padded-COO. Padding rows get weight 0."""
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
    put = lambda a: torch.from_numpy(a).to(dev)
    if dense:
        x = np.zeros((n_pad, d), real)
        x[rows, ds.indices] = ds.values
        feats = DenseFeatures(put(x))
    else:
        slots = np.arange(len(ds.indices), dtype=np.int64) - np.repeat(ds.indptr[:-1], row_nnz)
        k = int(row_nnz.max()) if n else 1
        idx = np.zeros((n_pad, k), np.int32)
        val = np.zeros((n_pad, k), real)
        idx[rows, slots] = ds.indices
        val[rows, slots] = ds.values
        feats = auto_transpose(SparseFeatures(put(idx), put(val), d))
    return GLMBatch(feats, put(labels), put(off), put(w))
