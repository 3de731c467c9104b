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
import os
import time
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


_FUSED_ENV = "PHOTON_ML_TPU_FUSED"  # "auto" (default) | "0" (off) | "1" (force)
PROBE_ROWS = 1 << 17  # the race's row cap: throughput no longer moves past it
RACE_PASSES = 8  # value+grad passes per timed run
RACE_REPEATS = 3  # timed runs; the best counts
MATMUL = "matmul"  # the race's baseline: two torch.matmul products

_autotune_cache: dict = {}
_autotune_timings: dict = {}
_autotune_failures: dict = {}
#: every decision of either race in this process, in order: ``("dense" |
#: "sparse", key, winner)``, whether raced or read from the cache. The GAME
#: driver keeps its run's share beside its checkpoints and adopts it when
#: it resumes (``fused_sparse.adopt_race_decisions``), so a resumed run
#: takes the winners the interrupted one took.
race_log: list = []


def fused_mode() -> str:
    """``PHOTON_ML_TPU_FUSED``: ``auto`` (default) races the kernel against
    the two-matmul path on the live card, ``0`` turns the kernel off, ``1``
    takes it without a race."""
    mode = os.environ.get(_FUSED_ENV, "auto").strip().lower()
    if mode not in ("auto", "0", "1"):
        raise ValueError(f"bad {_FUSED_ENV}={mode!r} (want auto | 0 | 1)")
    return mode


def matmul_value_grad(loss: PointwiseLoss, x: Tensor, y: Tensor, weights: Tensor,
                      offsets: Tensor, w: Tensor) -> Tuple[Tensor, Tensor]:
    """The race's baseline: ``(sum wt*l, X^T d)`` in two ``torch.matmul``
    products (each reads X once) and elementwise ops."""
    z = torch.matmul(x, w.to(x.dtype)).to(torch.float32) + offsets
    keep = weights > 0
    val = torch.sum(torch.where(keep, weights * loss.loss(z, y), 0.0))
    d = torch.where(keep, weights * loss.d1(z, y), 0.0)
    return val, torch.matmul(d.to(x.dtype), x).to(torch.float32)


def time_value_and_grad(fn, w0: Tensor, data) -> float:
    """Seconds per ``fn(w, data) -> (value, grad)`` pass: after a warm-up
    pass, ``RACE_REPEATS`` runs of ``RACE_PASSES`` passes, each pass fed the
    previous pass's ``w - 1e-6 g`` (fresh work every time); the best run
    counts. On the card the passes are enqueued back to back between two
    CUDA events; on a CPU the host clock reads them. Both races time this
    way."""
    cuda = w0.is_cuda
    w = w0 - 1e-6 * fn(w0, data)[1]
    best = float("inf")
    for _ in range(RACE_REPEATS):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        else:
            t0 = time.perf_counter()
        for _ in range(RACE_PASSES):
            w = w - 1e-6 * fn(w, data)[1]
        if cuda:
            end.record()
            end.synchronize()
            sec = start.elapsed_time(end) / 1e3
        else:
            sec = time.perf_counter() - t0
        best = min(best, sec / RACE_PASSES)
    return best


def _race_key(loss: PointwiseLoss, n: int, d: int, dtype: torch.dtype, device, mode: str):
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:  # "cuda" and "cuda:0" share a race
        dev = torch.device("cuda", torch.cuda.current_device())
    return (loss.name, min(n, PROBE_ROWS), d, str(dtype).replace("torch.", ""), str(dev), mode)


def _race(loss: PointwiseLoss, key: tuple, rows: int) -> Optional[int]:
    """Time two ``torch.matmul`` products and the kernel on synthetic data
    of the key's rows; return the faster (``rows`` or None). A kernel that
    fails to build or launch is recorded with its reason and raises: only a
    measured loss hands the pass to the matmul path."""
    n_probe, d, device = key[1], key[2], key[4]
    dtype = getattr(torch, key[3])
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((n_probe, d), generator=gen, device=device).to(dtype)
    y = (torch.rand((n_probe,), generator=gen, device=device) < 0.5).to(torch.float32)
    probe = (x, y, torch.ones((n_probe,), device=device), torch.zeros((n_probe,), device=device))
    w0 = torch.zeros((d,), device=device)
    timings = _autotune_timings[key] = {}
    timings[None] = time_value_and_grad(lambda w, data: matmul_value_grad(loss, *data, w),
                                        w0, probe)
    try:
        timings[rows] = time_value_and_grad(
            lambda w, data: fused_value_grad_kernel(loss, *data, w)[:2], w0, probe)
    except Exception as e:
        _autotune_failures[key] = {rows: f"failed: {type(e).__name__}: {e}"[:300]}
        raise
    return min(timings, key=timings.get)


def select_fused_block_rows(
    loss: PointwiseLoss, n: int, d: int, dtype: torch.dtype, device
) -> Optional[int]:
    """The kernel's rows per tile when the dense value+gradient pass of an
    (N, D) batch on ``device`` should go through the kernel, or ``None`` for
    the plain path: always on a CPU, for f64 storage and beyond the kernel's
    column limit; on the card as ``PHOTON_ML_TPU_FUSED`` says (``auto``
    races the kernel against two ``torch.matmul`` products on synthetic
    data of min(N, 2^17) rows and takes the faster, ``1`` takes the kernel
    unraced). Race results are cached per (loss, rows, D, dtype, device,
    mode); a kernel that fails in the race raises after its failure is
    recorded.
    """
    mode = fused_mode()
    if mode == "0" or torch.device(device).type != "cuda" or dtype not in KERNEL_DTYPES:
        return None
    if n < 1 or not 1 <= d <= MAX_DIM:
        return None
    rows = tile_rows(d, dtype)
    if mode == "1":
        return rows
    key = _race_key(loss, n, d, dtype, device, mode)
    if key not in _autotune_cache:
        _autotune_cache[key] = _race(loss, key, rows)
    race_log.append(("dense", key, _autotune_cache[key]))
    return _autotune_cache[key]


def autotune_report(loss: PointwiseLoss, n: int, d: int, dtype: torch.dtype, device) -> dict:
    """Run the race (or read its cache) and return the winner with every
    candidate: ``matmul`` (the two-product baseline, which reads X twice)
    and ``cuda:<tile rows>`` (the kernel), each with sec/pass, examples/s
    and the read rate of one stream of X in GB/s. Under ``1`` the winner is
    the kernel and nothing was raced; a kernel that failed its race reads
    as failed, with its reason."""
    key = _race_key(loss, n, d, dtype, device, fused_mode())
    # a kernel that failed its race is reported, not raced again
    winner = None if key in _autotune_failures else select_fused_block_rows(
        loss, n, d, dtype, device)
    n_probe = key[1]
    x_bytes = n_probe * d * torch.empty((), dtype=dtype).element_size()
    name = lambda cand: MATMUL if cand is None else f"cuda:{cand}"
    candidates = {
        name(cand): {
            "sec_per_pass": round(sec, 6),
            "examples_per_sec": round(n_probe / sec, 1),
            "one_stream_gb_per_sec": round(x_bytes / sec / 1e9, 1),
        }
        for cand, sec in _autotune_timings.get(key, {}).items()
    }
    for cand, reason in _autotune_failures.get(key, {}).items():
        candidates[name(cand)] = {"failed": reason}
    return {"winner": None if winner is None else name(winner), "candidates": candidates}
