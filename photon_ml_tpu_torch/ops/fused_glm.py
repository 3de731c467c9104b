"""Fused GLM value+gradient: the training hot loop (port of
photon_ml_tpu/ops/fused_glm.py).

``fused_value_grad_parts`` returns the raw single-pass pieces
``(sum_i wt_i*l_i, X^T d, sum_i d_i)`` with ``d_i = [wt_i>0]*wt_i*l'_i``; the
caller (``GLMObjective.value_and_grad``) folds normalization and L2 around
them. On a CUDA tensor it launches the hand-written kernel of
``csrc/fused_glm.cu`` (one pass over X instead of the two of the plain
version); on a CPU tensor it runs ``fused_value_grad_parts_plain``, the same
arithmetic in two torch contractions. It never falls back from the kernel to
the plain version for a CUDA tensor.

Rounding, as in the JAX kernels and ``DenseFeatures``: w is rounded to the
storage type of X before the margin product, d is rounded to it before the
gradient product, and everything accumulates in f32.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from photon_ml_tpu_torch import native_build
from photon_ml_tpu_torch.ops.losses import PointwiseLoss

Tensor = torch.Tensor

SOURCE = "fused_glm.cu"
MAX_DIM = 4096  # the kernel's column limit: 16 columns for each of 256 threads
# shared-memory budget of one staged row tile (two are double-buffered);
# a tile has at most 64 rows
TILE_BYTES = 16 * 1024
MAX_TILE_ROWS = 64
CTAS_PER_SM = 4  # at most; fewer when shared memory allows fewer
SMEM_PER_SM = 228 * 1024  # H100: shared memory of one SM
SMEM_RESERVED_PER_CTA = 1024 + 64  # the runtime's reserve + the static arrays
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def tile_rows(d: int, dtype: torch.dtype) -> int:
    """Rows of X that one CTA stages in shared memory per tile."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return max(1, min(MAX_TILE_ROWS, TILE_BYTES // (d * itemsize)))


def launch_geometry(n: int, d: int, dtype: torch.dtype,
                    sm_count: int) -> Tuple[int, int, int, int]:
    """(tile_rows, grid, rows_per_cta, dynamic shared-memory bytes) of the
    stage-1 launch: contiguous row ranges of whole tiles, one per CTA, as
    many CTAs as fit on the SMs at once (at most ``CTAS_PER_SM`` each), and
    no CTA left without rows. Shared memory holds w, the tile's d values,
    and two buffers each of the tile's X rows and its y, wt, off (the
    ``Layout`` of csrc/fused_glm.cu, which checks it)."""
    tr = tile_rows(d, dtype)
    itemsize = torch.empty((), dtype=dtype).element_size()
    d_pad = (d + 3) & ~3
    t_pad = (tr + 3) & ~3
    smem = 4 * (d_pad + 7 * t_pad) + 2 * tr * d * itemsize
    per_sm = max(1, min(CTAS_PER_SM, SMEM_PER_SM // (smem + SMEM_RESERVED_PER_CTA)))
    tiles = -(-n // tr)
    tiles_per_cta = -(-tiles // (per_sm * sm_count))
    grid = -(-tiles // tiles_per_cta)
    return tr, grid, tiles_per_cta * tr, smem


def _configure(lib: ctypes.CDLL) -> None:
    fn = lib.photon_fused_glm_value_grad
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, i, p, p, p, p, ll, i, i, i, ll, i, ll, p, p, p]
    fn.restype = ctypes.c_int


def _library() -> ctypes.CDLL:
    return native_build.load(SOURCE, _configure)


def _check_vector(name: str, t: Tensor, n: int, device: torch.device) -> None:
    if t.dtype != torch.float32 or t.shape != (n,) or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous float32 tensor of shape ({n},), got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, X on {device}")


def fused_value_grad_kernel(
    loss: PointwiseLoss, x: Tensor, y: Tensor, weights: Tensor,
    offsets: Tensor, w: Tensor,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch the CUDA kernel on CUDA tensors. X is (N, D) bf16 or f32,
    row-major and contiguous, 1 <= D <= 4096; y, weights, offsets (N,) and
    w (D,) are contiguous f32 on the same card. Raises on anything else."""
    if not x.is_cuda:
        raise ValueError("fused_value_grad_kernel needs CUDA tensors")
    if x.dim() != 2 or x.dtype not in KERNEL_DTYPES or not x.is_contiguous():
        raise ValueError(
            f"X: expected a contiguous 2-D bfloat16/float32 tensor, got "
            f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )
    n, d = x.shape
    if n < 1 or not 1 <= d <= MAX_DIM:
        raise ValueError(f"X shape {(n, d)}: need N >= 1 and 1 <= D <= {MAX_DIM}")
    for name, t in (("y", y), ("weights", weights), ("offsets", offsets)):
        _check_vector(name, t, n, x.device)
    _check_vector("w", w, d, x.device)

    sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
    tr, grid, rows_per_cta, smem = launch_geometry(n, d, x.dtype, sm_count)
    partials = torch.empty((grid, d + 2), dtype=torch.float32, device=x.device)
    out = torch.empty((d + 2,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library().photon_fused_glm_value_grad(
            x.data_ptr(), int(x.dtype == torch.bfloat16), y.data_ptr(),
            weights.data_ptr(), offsets.data_ptr(), w.data_ptr(), n, d,
            loss.kernel_id, tr, rows_per_cta, grid, smem,
            partials.data_ptr(), out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_glm kernel launch failed: cudaError {err} "
            f"(N={n}, D={d}, {x.dtype}, tile_rows={tr}, grid={grid}, smem={smem})"
        )
    fused_value_grad_kernel.launches += 1
    return out[0], out[2:], out[1]


fused_value_grad_kernel.launches = 0


def fused_value_grad_parts_plain(
    loss: PointwiseLoss, x: Tensor, y: Tensor, weights: Tensor,
    offsets: Tensor, w: Tensor,
) -> Tuple[Tensor, Tensor, Tensor]:
    """The kernel's function in plain torch: two contractions (X w, d^T X)
    with the same rounding and accumulation type, the hard weight mask, and
    the sums. The CPU path and the oracle the kernel is held against."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xa = x.to(acc)
    z = xa @ w.to(x.dtype).to(acc) + offsets.to(acc)
    y = y.to(acc)
    weights = weights.to(acc)
    keep = weights > 0.0
    zero = torch.zeros_like(z)
    wl = torch.where(keep, weights * loss.loss(z, y), zero)
    d = torch.where(keep, weights * loss.d1(z, y), zero)
    grad = d.to(x.dtype).to(acc) @ xa
    return torch.sum(wl), grad, torch.sum(d)


def fused_value_grad_parts(
    loss: PointwiseLoss, x: Tensor, y: Tensor, weights: Tensor,
    offsets: Tensor, w: Tensor, block_rows: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Raw single-pass pieces ``(sum w_i*l_i, X^T d, sum d)``.

    A CUDA X (bf16 or f32) goes through the kernel, with the row vectors and
    w marshalled to contiguous f32 as in the JAX wrapper; a CPU X through the
    plain version. ``block_rows`` is taken for the JAX signature and
    ignored: the kernel always stages ``tile_rows(D, dtype)`` rows per tile.
    """
    if not x.is_cuda:
        return fused_value_grad_parts_plain(loss, x, y, weights, offsets, w)
    f32 = lambda t: t.to(torch.float32).contiguous()
    return fused_value_grad_kernel(
        loss, x, f32(y), f32(weights), f32(offsets), f32(w)
    )


def select_fused_block_rows(
    loss: PointwiseLoss, n: int, d: int, dtype: torch.dtype, device
) -> Optional[int]:
    """The kernel's rows per tile when the dense pass of an (N, D) batch on
    ``device`` goes through the kernel, else None: on a CPU, for f64
    storage, or beyond the kernel's column limit.

    Unlike the JAX function of the same name, nothing is raced here: on the
    card the kernel is always taken (the race against the plain path is not
    yet ported).
    """
    if torch.device(device).type != "cuda" or dtype not in KERNEL_DTYPES:
        return None
    if n < 1 or not 1 <= d <= MAX_DIM:
        return None
    return tile_rows(d, dtype)
