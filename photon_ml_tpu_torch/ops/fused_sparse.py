"""Sparse per-entity slabs and their fused kernels (port of
photon_ml_tpu/ops/fused_sparse.py, without the per-bucket race).

A random-effect coordinate's per-entity rows live in a padded-COO **slab**:
``idx``/``val`` of shape ``(E, M, K)``, K the largest row non-zero count,
padding slots at column 0 with value 0, each row's entries in ascending
column order. Two formulations compute the same arithmetic on it: margins
gathered per row, transposes applied in flat ``(m, k)`` order, row sums
through the fixed-association ``tree_row_sum``.

  * the plain one (``SparseSlab.matvec`` / ``rmatvec``, and
    ``*_parts_plain``): a gather and one flat ``index_add_``. It serves the
    ``scatter``, ``segment`` and ``flat`` specs, which are three schedules
    of that arithmetic in the JAX package;
  * the fused one, spec ``pallas``: on a CUDA slab the hand-written kernels
    of ``csrc/fused_sparse.cu`` (value + gradient in one pass, and the
    Hessian-vector product in one pass), every lane in one launch; on a CPU
    slab the plain version. A CUDA slab never falls back to the plain
    version: a kernel that fails to build or launch raises.

``PHOTON_SPARSE_KERNEL`` keeps the JAX grammar: ``off`` (default) keeps the
dense path; ``scatter`` | ``segment`` | ``flat`` | ``pallas`` |
``pallas:<rows>`` select a family (``:<rows>`` is a TPU row-block schedule,
accepted and ignored); ``auto`` (the race) is not yet ported and raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import os
import warnings
from typing import Optional, Tuple

import torch

from photon_ml_tpu_torch import native_build
from photon_ml_tpu_torch.ops.losses import PointwiseLoss

Tensor = torch.Tensor

SOURCE = "fused_sparse.cu"
_SPARSE_ENV = "PHOTON_SPARSE_KERNEL"
SPARSE_FAMILIES = ("scatter", "segment", "flat", "pallas")
VAL_DTYPES = (torch.float32, torch.bfloat16)


def _acc_dtype(storage: torch.dtype) -> torch.dtype:
    return torch.float64 if storage == torch.float64 else torch.float32


def tree_row_sum(x: Tensor) -> Tensor:
    """Fixed-association pairwise sum over the last axis: zero-pad to a
    power of two, then add adjacent pairs until one is left. Bitwise the
    JAX package's ``tree_row_sum`` (the same adds in the same order)."""
    n = x.shape[-1]
    p = 1 << (n - 1).bit_length() if n > 1 else 1
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


# ---------------------------------------------------------------------------
# the slab
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SparseSlab:
    """Padded-COO per-entity features: ``idx``/``val`` ``(..., M, K)``.

    With a leading lane axis, ``matvec`` takes ``(..., D)`` coefficients, one
    row per lane, and ``rmatvec`` returns them. ``kernel`` names the family
    the objective dispatches on: ``pallas*`` takes the fused kernels, any
    other the plain formulation.
    """

    idx: Tensor  # (..., M, K) int32
    val: Tensor  # (..., M, K)
    dim: int
    kernel: str = "scatter"
    # (perm, col_start) of the column-owner transpose, built on first use
    _columns: Optional[Tuple[Tensor, Tensor]] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def num_rows(self) -> int:
        return self.idx.shape[-2]

    @property
    def max_nnz(self) -> int:
        return self.idx.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.idx.device

    def _flat_idx(self) -> Tensor:
        """Slot indices into the ravel of ``(..., D)``: lane l's columns
        offset by ``l * D``."""
        lead = tuple(self.idx.shape[:-2])
        base = torch.arange(math.prod(lead), device=self.idx.device, dtype=torch.int64)
        return self.idx.long() + (base * self.dim).reshape(lead + (1, 1))

    def matvec(self, w: Tensor) -> Tensor:
        acc = _acc_dtype(self.val.dtype)
        wv = w.reshape(-1)[self._flat_idx()]
        return torch.sum(wv.to(acc) * self.val.to(acc), dim=-1)

    def _transpose_apply(self, contrib: Tensor) -> Tensor:
        """The transpose action of every family: one flat index_add_ in
        (lane, m, k) order into the raveled ``(..., D)`` output."""
        lead = tuple(self.idx.shape[:-2])
        out = torch.zeros(math.prod(lead) * self.dim, dtype=contrib.dtype,
                          device=contrib.device)
        out.index_add_(0, self._flat_idx().reshape(-1), contrib.reshape(-1))
        return out.reshape(lead + (self.dim,))

    def rmatvec(self, d: Tensor) -> Tensor:
        acc = _acc_dtype(self.val.dtype)
        return self._transpose_apply(self.val.to(acc) * d.to(acc)[..., None])

    def sq_rmatvec(self, d: Tensor) -> Tensor:
        acc = _acc_dtype(self.val.dtype)
        return self._transpose_apply(torch.square(self.val.to(acc)) * d.to(acc)[..., None])

    def row_sq_norms(self) -> Tensor:
        return torch.sum(torch.square(self.val.to(_acc_dtype(self.val.dtype))), dim=-1)

    def to_dense(self) -> Tensor:
        """``(..., M, D)`` dense view (tests and debugging)."""
        acc = _acc_dtype(self.val.dtype)
        lead = tuple(self.idx.shape[:-1])
        out = torch.zeros(math.prod(lead) * self.dim, dtype=acc, device=self.idx.device)
        rows = torch.arange(math.prod(lead), device=self.idx.device).reshape(lead + (1,))
        out.index_add_(0, (self.idx.long() + rows * self.dim).reshape(-1),
                       self.val.to(acc).reshape(-1))
        return out.reshape(lead + (self.dim,))

    def with_kernel(self, kernel: str) -> "SparseSlab":
        return SparseSlab(self.idx, self.val, self.dim, kernel, self._columns)

    def astype(self, dtype: torch.dtype) -> "SparseSlab":
        return SparseSlab(self.idx, self.val.to(dtype), self.dim, self.kernel, self._columns)

    def column_order(self) -> Tuple[Tensor, Tensor]:
        """Per lane, the non-padding slots sorted by column: ``perm (E, M*K)``
        int32 (slot indices, each column's slots in flat (m, k) order, padding
        slots last) and ``col_start (E, D+1)`` int32 (column j owns
        ``perm[col_start[j]:col_start[j+1]]``). The slab is fixed for a whole
        solve, so this is built once and kept."""
        if self._columns is None:
            if self.idx.dim() != 3:
                raise ValueError(f"column_order needs an (E, M, K) slab, got {tuple(self.idx.shape)}")
            e = self.idx.shape[0]
            key = torch.where(self.val != 0, self.idx, self.dim).reshape(e, -1)
            sorted_key, perm = torch.sort(key, dim=-1, stable=True)
            bounds = torch.arange(self.dim + 1, device=key.device, dtype=key.dtype)
            col_start = torch.searchsorted(sorted_key.contiguous(),
                                           bounds.expand(e, -1).contiguous())
            self._columns = (perm.to(torch.int32).contiguous(),
                             col_start.to(torch.int32).contiguous())
        return self._columns


def build_sparse_slab(x, kernel: str = "scatter", dtype: Optional[torch.dtype] = None) -> SparseSlab:
    """Extract the padded-COO slab from a dense ``(..., M, D)`` stack (a
    tensor on any device, or an array). K is the largest row non-zero count
    (at least 1); a stable sort of the zero mask keeps each row's non-zeros
    in ascending column order; padding slots carry column 0 and value 0.
    Byte-equal to the JAX package's build with the shape ladder off."""
    x = torch.as_tensor(x)
    d = x.shape[-1]
    mask = x != 0
    counts = mask.sum(dim=-1)
    k = max(min(max(int(counts.max()) if counts.numel() else 0, 1), d), 1)
    order = torch.sort((~mask).to(torch.uint8), dim=-1, stable=True)[1][..., :k]
    val = torch.gather(x, -1, order)
    pad = torch.arange(k, device=x.device) >= counts[..., None]
    idx = torch.where(pad, 0, order).to(torch.int32)
    val = torch.where(pad, torch.zeros((), dtype=x.dtype, device=x.device), val)
    return SparseSlab(idx, val.to(dtype or x.dtype), d, kernel)


def slab_nnz_stats(slab: SparseSlab) -> dict:
    """Host-side nnz accounting: how much the slab avoids of its dense
    ``(M, D)`` counterpart."""
    nnz = (slab.val != 0).sum(dim=-1)
    rows = nnz.numel()
    dense_elems = rows * slab.dim
    slab_elems = slab.val.numel()
    return {
        "rows": rows,
        "max_nnz": int(nnz.max()) if rows else 0,
        "mean_nnz": round(float(nnz.float().mean()) if rows else 0.0, 2),
        "padded_k": slab.max_nnz,
        "dim": slab.dim,
        "slab_elements": slab_elems,
        "dense_elements": dense_elems,
        "density": round(slab_elems / dense_elems, 4) if dense_elems else 0.0,
    }


# ---------------------------------------------------------------------------
# the fused pieces: plain version and CUDA kernels
# ---------------------------------------------------------------------------


def _masked(weights: Tensor, x: Tensor) -> Tensor:
    return torch.where(weights > 0.0, weights * x, torch.zeros_like(x))


def fused_value_grad_parts_plain(loss, slab, labels, weights, offsets, w):
    """Per lane ``(sum wt*l, X^T d, sum d)`` in the plain formulation."""
    z = slab.matvec(w) + offsets
    wl = _masked(weights, loss.loss(z, labels))
    d = _masked(weights, loss.d1(z, labels))
    return tree_row_sum(wl), slab.rmatvec(d), tree_row_sum(d)


def fused_hvp_parts_plain(loss, slab, labels, weights, offsets, w, v, vshift):
    """Per lane ``(X^T c, sum c)``, ``c = [wt>0] wt l''(z) (X v + vshift)``."""
    z = slab.matvec(w) + offsets
    d2 = _masked(weights, loss.d2(z, labels))
    c = d2 * (slab.matvec(v) + vshift[..., None])
    return slab.rmatvec(c), tree_row_sum(c)


def _configure(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.photon_sparse_gevm.argtypes = [p, p, i, p, p, p, p, p, p, ll, i, i, i, i, p, p, p, p]
    lib.photon_sparse_gevm.restype = ctypes.c_int
    lib.photon_sparse_hvp.argtypes = [p, p, i, p, p, p, p, p, p, p, p, ll, i, i, i, i, p, p, p]
    lib.photon_sparse_hvp.restype = ctypes.c_int


def _library() -> ctypes.CDLL:
    return native_build.load(SOURCE, _configure)


def _check(name: str, t: Tensor, shape, dtypes, device) -> None:
    if t.dtype not in dtypes or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {'/'.join(str(x)[6:] for x in dtypes)} tensor "
            f"of shape {tuple(shape)}, got {t.dtype} {tuple(t.shape)} "
            f"contiguous={t.is_contiguous()}"
        )
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, the slab on {device}")


def _check_slab(slab: SparseSlab, vectors) -> Tuple[int, int, int, int]:
    if not slab.idx.is_cuda:
        raise ValueError("the sparse kernels need a CUDA slab")
    if slab.idx.dim() != 3:
        raise ValueError(f"idx: expected (E, M, K), got {tuple(slab.idx.shape)}")
    e, m, k = slab.idx.shape
    d = slab.dim
    if min(e, m, k, d) < 1 or e >= 2 ** 31 or m * k >= 2 ** 31:
        raise ValueError(f"slab shape (E={e}, M={m}, K={k}, D={d}) out of the kernels' range")
    dev = slab.idx.device
    _check("idx", slab.idx, (e, m, k), (torch.int32,), dev)
    _check("val", slab.val, (e, m, k), VAL_DTYPES, dev)
    for name, t, shape in vectors:
        _check(name, t, {"rows": (e, m), "cols": (e, d), "lanes": (e,)}[shape],
               (torch.float32,), dev)
    return e, m, k, d


def _launch(fn, what: str, args, shape) -> None:
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*[a.data_ptr() if isinstance(a, Tensor) else a for a in args], stream)
    if err != 0:
        raise RuntimeError(f"fused_sparse {what} kernel launch failed: cudaError {err} "
                           f"(E, M, K, D) = {shape}")


def sparse_gevm_kernel(loss: PointwiseLoss, slab: SparseSlab, labels: Tensor,
                       weights: Tensor, offsets: Tensor, w: Tensor
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch the GEVM kernel: ``(row_wl (E, M), grad (E, D), row_d (E, M))``.
    Inputs are contiguous CUDA tensors: the slab ``(E, M, K)`` (int32
    indices, f32/bf16 values), labels/weights/offsets ``(E, M)`` and w
    ``(E, D)`` f32. Raises on anything else."""
    e, m, k, d = _check_slab(slab, (("labels", labels, "rows"), ("weights", weights, "rows"),
                                    ("offsets", offsets, "rows"), ("w", w, "cols")))
    perm, col_start = slab.column_order()
    row_wl = torch.empty((e, m), dtype=torch.float32, device=w.device)
    row_d = torch.empty_like(row_wl)
    grad = torch.empty((e, d), dtype=torch.float32, device=w.device)
    _launch(_library().photon_sparse_gevm, "GEVM",
            (slab.idx, slab.val, int(slab.val.dtype == torch.bfloat16), labels, weights,
             offsets, w, perm, col_start, e, m, k, d, loss.kernel_id, row_wl, row_d, grad),
            (e, m, k, d))
    sparse_gevm_kernel.launches += 1
    return row_wl, grad, row_d


sparse_gevm_kernel.launches = 0


def sparse_hvp_kernel(loss: PointwiseLoss, slab: SparseSlab, labels: Tensor,
                      weights: Tensor, offsets: Tensor, w: Tensor, v: Tensor,
                      vshift: Tensor) -> Tuple[Tensor, Tensor]:
    """Launch the HVP kernel: ``(hvp (E, D), row_c (E, M))``; as the GEVM
    kernel, plus v ``(E, D)`` and vshift ``(E,)`` f32."""
    e, m, k, d = _check_slab(slab, (("labels", labels, "rows"), ("weights", weights, "rows"),
                                    ("offsets", offsets, "rows"), ("w", w, "cols"),
                                    ("v", v, "cols"), ("vshift", vshift, "lanes")))
    perm, col_start = slab.column_order()
    row_c = torch.empty((e, m), dtype=torch.float32, device=w.device)
    hvp = torch.empty((e, d), dtype=torch.float32, device=w.device)
    _launch(_library().photon_sparse_hvp, "HVP",
            (slab.idx, slab.val, int(slab.val.dtype == torch.bfloat16), labels, weights,
             offsets, w, v, vshift, perm, col_start, e, m, k, d, loss.kernel_id, row_c, hvp),
            (e, m, k, d))
    sparse_hvp_kernel.launches += 1
    return hvp, row_c


sparse_hvp_kernel.launches = 0


def _f32(t: Tensor, shape) -> Tensor:
    return torch.broadcast_to(t.to(torch.float32), shape).contiguous()


def fused_value_grad_parts(loss: PointwiseLoss, slab: SparseSlab, labels: Tensor,
                           weights: Tensor, offsets: Tensor, w: Tensor
                           ) -> Tuple[Tensor, Tensor, Tensor]:
    """Per lane ``(sum_m wt*l, X^T d, sum_m d)``: ``(E,)``, ``(E, D)``,
    ``(E,)``. ``offsets`` already fold the normalization margin shift. A
    CUDA slab goes through the GEVM kernel, a CPU slab through the plain
    version; the row sums run through ``tree_row_sum`` either way."""
    if not slab.idx.is_cuda:
        return fused_value_grad_parts_plain(loss, slab, labels, weights, offsets, w)
    rows = tuple(slab.idx.shape[:-1])
    row_wl, grad, row_d = sparse_gevm_kernel(
        loss, slab, _f32(labels, rows), _f32(weights, rows), _f32(offsets, rows),
        _f32(w, rows[:-1] + (slab.dim,)),
    )
    return tree_row_sum(row_wl), grad, tree_row_sum(row_d)


def fused_hvp_parts(loss: PointwiseLoss, slab: SparseSlab, labels: Tensor,
                    weights: Tensor, offsets: Tensor, w: Tensor, v: Tensor,
                    vshift: Tensor) -> Tuple[Tensor, Tensor]:
    """Per lane ``(X^T c, sum_m c)`` with ``c = [wt>0] wt l''(z) (X v +
    vshift)``: ``(E, D)`` and ``(E,)``; vshift is per lane."""
    lanes = tuple(slab.idx.shape[:-2])
    vshift = torch.broadcast_to(torch.as_tensor(vshift, device=w.device), lanes)
    if not slab.idx.is_cuda:
        return fused_hvp_parts_plain(loss, slab, labels, weights, offsets, w, v, vshift)
    rows = tuple(slab.idx.shape[:-1])
    cols = lanes + (slab.dim,)
    hvp, row_c = sparse_hvp_kernel(
        loss, slab, _f32(labels, rows), _f32(weights, rows), _f32(offsets, rows),
        _f32(w, cols), _f32(v, cols), _f32(vshift, lanes),
    )
    return hvp, tree_row_sum(row_c)


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------


def _family_block(kernel: str) -> Tuple[str, int]:
    if ":" in kernel:
        fam, block = kernel.split(":", 1)
        return fam, int(block)
    return kernel, 0


def resolve_sparse_kernel(spec: Optional[str] = None) -> Optional[str]:
    """Effective sparse-kernel spec: an explicit value wins; ``None`` falls
    back to ``PHOTON_SPARSE_KERNEL``. Returns ``None`` (off) or a family
    name; ``auto`` raises (the race is not yet ported)."""
    if spec is None:
        spec = os.environ.get(_SPARSE_ENV)
    if spec is None:
        return None
    text = str(spec).strip().lower()
    if text in ("", "off", "false", "0", "none"):
        return None
    if text in ("on", "auto", "race"):
        raise ValueError(
            f"sparse-kernel spec {spec!r}: the per-bucket race (auto) is not yet "
            "ported to photon_ml_tpu_torch; name a family instead"
        )
    fam, _ = _family_block(text)
    if fam not in SPARSE_FAMILIES or (":" in text and fam != "pallas"):
        raise ValueError(
            f"bad sparse-kernel spec {spec!r} (want off | "
            f"{' | '.join(SPARSE_FAMILIES)} | pallas:<rows>)"
        )
    return text


def build_and_select(x, spec: str, label: str) -> SparseSlab:
    """Slab build for one random-effect dataset with an already-resolved
    family ``spec``. The fused family is never taken for f64 values: it
    warns and runs the plain ``scatter`` family, as the JAX package does."""
    slab = build_sparse_slab(x)
    family = spec
    if _family_block(family)[0] == "pallas" and slab.val.dtype == torch.float64:
        warnings.warn(
            f"{label}: pallas family is ineligible under float64; "
            "running the scatter family instead",
            stacklevel=2,
        )
        family = "scatter"
    return slab.with_kernel(family)
