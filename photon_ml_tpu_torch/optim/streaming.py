"""Out-of-core fixed-effect training: stream the batch in row chunks (port
of photon_ml_tpu/optim/streaming.py).

Reference analogue: Spark's persistence levels (StorageLevel.scala:22-24),
where every Breeze iteration re-aggregates over possibly disk-backed
partitions. Here the coefficients stay on the device and each evaluation
streams row chunks host -> device, accumulating the (value, gradient)
partials on the device. The aggregator algebra is additive over rows
(ValueAndGradientAggregator.scala:120-139), so chunked accumulation is
exact up to the order of the float sums. The device holds one chunk (two
while the next one's copy is in flight); the host holds memory-mapped
``.npy`` chunk files, so the page cache is the disk tier.

The port's solvers are already host-driven loops over device tensors, so
the streamed solves are :func:`optim.lbfgs.lbfgs_minimize` and
:func:`optim.tron.tron_minimize_` themselves, handed the streamed
value+gradient and Hessian-vector passes: one pass per line-search trial,
and under TRON one more per CG step (TRON.scala:268-281). The per-chunk
arithmetic is the port's plain :class:`GLMObjective`, defined once
(:func:`_vg_chunk_kernels`, :func:`_hvp_chunk_kernel`); the JAX streamed
pass does not take the fused kernel either.

Chunks move through io/pipeline.py: a background thread reads up to
``prefetch_depth`` chunks ahead, and on the card each chunk is copied from
pinned memory on a side stream while the previous chunk's pass runs. The
per-host factories (:func:`make_perhost_value_and_grad`,
:func:`make_perhost_hvp`) run the same chunk arithmetic over a rank's
chunks of a global chunk list and merge the partials exactly across ranks.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.ops.features import DenseFeatures
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMBatch, GLMObjective
from photon_ml_tpu_torch.ops.stats import BasicStatisticalSummary
from photon_ml_tpu_torch.optim.common import OptimizerConfig, OptResult
from photon_ml_tpu_torch.optim.lbfgs import lbfgs_minimize
from photon_ml_tpu_torch.optim.tron import tron_minimize_
from photon_ml_tpu_torch.types import real_dtype

Tensor = torch.Tensor

__all__ = [
    "ChunkedGLMSource",
    "lbfgs_minimize_streaming",
    "make_perhost_hvp",
    "make_perhost_value_and_grad",
    "make_streaming_hvp",
    "make_streaming_value_and_grad",
    "pipelined_device_chunks",
    "streaming_hessian_diagonal",
    "streaming_summarize",
    "tron_minimize_streaming",
    "write_chunk",
    "write_chunk_files",
]


# ---------------------------------------------------------------------------
# chunk sources
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ChunkedGLMSource:
    """Row chunks of a dense GLM batch.

    ``loaders`` return host numpy dicts with keys x (n_c, D), y (n_c,) and
    optional offsets / weights, one chunk at a time. Build with
    :meth:`from_arrays` (an in-memory split) or :meth:`from_chunk_dir`
    (per-stream ``.npy`` files, memory-mapped)."""

    loaders: Sequence[Callable[[], dict]]
    dim: int
    num_rows: int

    @classmethod
    def from_arrays(cls, x: np.ndarray, y: np.ndarray, chunk_rows: int,
                    offsets: Optional[np.ndarray] = None,
                    weights: Optional[np.ndarray] = None) -> "ChunkedGLMSource":
        n = len(y)
        loaders = []
        for lo in range(0, n, chunk_rows):
            hi = min(lo + chunk_rows, n)

            def load(lo=lo, hi=hi):
                out = {"x": x[lo:hi], "y": y[lo:hi]}
                if offsets is not None:
                    out["offsets"] = offsets[lo:hi]
                if weights is not None:
                    out["weights"] = weights[lo:hi]
                return out

            loaders.append(load)
        return cls(loaders=loaders, dim=x.shape[1], num_rows=n)

    @classmethod
    def from_chunk_dir(cls, path: str) -> "ChunkedGLMSource":
        """Chunks as per-stream ``.npy`` files (``chunk-NNNNN.x.npy`` etc.):
        construction reads only headers, a pass only the pages it streams."""
        stems = sorted(f[: -len(".x.npy")] for f in os.listdir(path)
                       if f.startswith("chunk-") and f.endswith(".x.npy"))
        if not stems:
            raise ValueError(f"no chunk-*.x.npy files under {path}")
        dim = None
        num_rows = 0
        for s in stems:
            hdr = np.load(os.path.join(path, s + ".x.npy"), mmap_mode="r")
            dim = int(hdr.shape[1])
            num_rows += int(hdr.shape[0])
        loaders = []
        for s in stems:

            def load(s=s):
                out = {
                    "x": np.load(os.path.join(path, s + ".x.npy"), mmap_mode="r"),
                    "y": np.load(os.path.join(path, s + ".y.npy"), mmap_mode="r"),
                }
                for k in ("offsets", "weights"):
                    f = os.path.join(path, f"{s}.{k}.npy")
                    if os.path.exists(f):
                        out[k] = np.load(f, mmap_mode="r")
                return out

            loaders.append(load)
        return cls(loaders=loaders, dim=dim, num_rows=num_rows)

    def chunks(self) -> Iterator[dict]:
        for load in self.loaders:
            yield load()


def write_chunk(path: str, index: int, payload: dict) -> None:
    """One chunk as per-stream ``.npy`` files (see ``from_chunk_dir``)."""
    for k, v in payload.items():
        np.save(os.path.join(path, f"chunk-{index:05d}.{k}.npy"), v)


def write_chunk_files(path: str, x: np.ndarray, y: np.ndarray, chunk_rows: int,
                      offsets: Optional[np.ndarray] = None,
                      weights: Optional[np.ndarray] = None) -> int:
    """Spill an in-memory batch to chunk files; returns the chunk count."""
    os.makedirs(path, exist_ok=True)
    count = 0
    for i, lo in enumerate(range(0, len(y), chunk_rows)):
        hi = min(lo + chunk_rows, len(y))
        payload = {"x": x[lo:hi], "y": y[lo:hi]}
        if offsets is not None:
            payload["offsets"] = offsets[lo:hi]
        if weights is not None:
            payload["weights"] = weights[lo:hi]
        write_chunk(path, i, payload)
        count += 1
    return count


# ---------------------------------------------------------------------------
# the streamed passes
# ---------------------------------------------------------------------------


def _np_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def pipelined_device_chunks(source: ChunkedGLMSource, dtype=None,
                            prefetch_depth: Optional[int] = None, bucketer=None,
                            device=None) -> Iterator[Tuple[Tensor, Tensor, Tensor, Tensor]]:
    """``(x, y, offsets, weights)`` tensors on ``device`` per chunk, in
    source order, through io/pipeline.py (depth <= 0: the synchronous
    loop). The host stage casts each chunk to ``dtype`` where it differs
    and, with a ``bucketer``, pads its rows up the ladder with weight-0
    rows; on the card a memory-mapped chunk is read once, straight into
    pinned memory on the prefetch thread."""
    from photon_ml_tpu_torch.compile.canonical import pad_glm_chunk, resolve_bucketer
    from photon_ml_tpu_torch.io.pipeline import pipelined_to_device

    dtype = dtype or real_dtype()
    bucketer = resolve_bucketer(bucketer)
    np_dt = _np_dtype(dtype)
    dev = resolve_device(device)

    def to_host(chunk):
        n_c = len(chunk["y"])
        host = tuple(
            np.asarray(a, dtype=np_dt) for a in (
                chunk["x"], chunk["y"],
                chunk.get("offsets", np.zeros(n_c, np.float32)),
                chunk.get("weights", np.ones(n_c, np.float32)))
        )
        return pad_glm_chunk(host, bucketer)

    return pipelined_to_device(source.chunks, to_host, dev, prefetch_depth,
                               name="glm-chunk-prefetch")


def _vg_chunk_kernels(objective: GLMObjective, norm: NormalizationContext):
    """The per-chunk (value, gradient) accumulation and the final L2 add,
    defined once for every streamed pass."""

    def acc_vg(f, g, w, x, y, off, wt):
        fv, gv = objective.value_and_grad(w, GLMBatch(DenseFeatures(x), y, off, wt), norm, 0.0)
        return f + fv, g + gv

    def add_reg(f, g, w, l2):
        return f + 0.5 * l2 * torch.sum(torch.square(w)), g + l2 * w

    return acc_vg, add_reg


def _hvp_chunk_kernel(objective: GLMObjective, norm: NormalizationContext):
    """The per-chunk Hessian-vector accumulation (one definition)."""

    def acc_hvp(hv, w, v, x, y, off, wt):
        return hv + objective.hessian_vector(w, v, GLMBatch(DenseFeatures(x), y, off, wt),
                                             norm, 0.0)

    return acc_hvp


def make_streaming_value_and_grad(source: ChunkedGLMSource, objective: GLMObjective,
                                  norm: NormalizationContext, l2_weight: float = 0.0,
                                  dtype=None, prefetch_depth: Optional[int] = None,
                                  bucketer=None, device=None):
    """``vg(w, l2_weight=...) -> (f, g)`` accumulated over the chunks in
    source order; ``l2_weight`` is an argument so one factory serves a
    whole lambda grid."""
    dtype = dtype or real_dtype()
    acc_vg, add_reg = _vg_chunk_kernels(objective, norm)

    def vg(w: Tensor, l2_weight=l2_weight) -> Tuple[Tensor, Tensor]:
        f = torch.zeros((), dtype=dtype, device=w.device)
        g = torch.zeros((source.dim,), dtype=dtype, device=w.device)
        for x, y, off, wt in pipelined_device_chunks(source, dtype, prefetch_depth, bucketer,
                                                     device or w.device):
            f, g = acc_vg(f, g, w, x, y, off, wt)
        return add_reg(f, g, w, l2_weight)

    return vg


def make_streaming_hvp(source: ChunkedGLMSource, objective: GLMObjective,
                       norm: NormalizationContext, l2_weight: float = 0.0, dtype=None,
                       prefetch_depth: Optional[int] = None, bucketer=None, device=None):
    """``hvp(w, v, l2_weight=...) -> H(w) v`` accumulated over the chunks
    (HessianVectorAggregator.scala:90-116 is additive over rows)."""
    dtype = dtype or real_dtype()
    acc_hvp = _hvp_chunk_kernel(objective, norm)

    def hvp(w: Tensor, v: Tensor, l2_weight=l2_weight) -> Tensor:
        hv = torch.zeros((source.dim,), dtype=dtype, device=w.device)
        for x, y, off, wt in pipelined_device_chunks(source, dtype, prefetch_depth, bucketer,
                                                     device or w.device):
            hv = acc_hvp(hv, w, v, x, y, off, wt)
        return hv + l2_weight * v

    return hvp


# ---------------------------------------------------------------------------
# the per-host streamed passes (each rank owns some chunks of a global chunk
# list; the partials merge exactly across the ranks)
# ---------------------------------------------------------------------------


def make_perhost_value_and_grad(source: ChunkedGLMSource, owned_chunk_ids: Sequence[int],
                                num_chunks_global: int, objective: GLMObjective,
                                norm: NormalizationContext, ctx, num_processes: int = 1,
                                l2_weight: float = 0.0, dtype=None,
                                prefetch_depth: Optional[int] = None, bucketer=None,
                                device=None):
    """:func:`make_streaming_value_and_grad` over a global chunk list of
    which ``source`` holds this rank's chunks (chunk c of the source is
    global chunk ``owned_chunk_ids[c]``). Each owned chunk's (value,
    gradient) partial comes from the single-host pass's chunk arithmetic
    started at zero, the ``(num_chunks, 1 + D)`` partials merge exactly
    across the ranks in one collective, and every rank replays the
    single-host fold in global chunk order: bitwise the single-host pass on
    the same chunk list, for any assignment of chunks to ranks. Rows never
    move after ingest."""
    from photon_ml_tpu_torch.parallel.perhost_streaming import disjoint_fill, merge_disjoint

    dtype = dtype or real_dtype()
    owned = list(owned_chunk_ids)
    acc_vg, add_reg = _vg_chunk_kernels(objective, norm)

    def vg(w: Tensor, l2_weight=l2_weight) -> Tuple[Tensor, Tensor]:
        parts = disjoint_fill((num_chunks_global, 1 + source.dim), dtype, w.device)
        chunks = pipelined_device_chunks(source, dtype, prefetch_depth, bucketer,
                                         device or w.device)
        for cid, (x, y, off, wt) in zip(owned, chunks):
            f_c, g_c = acc_vg(torch.zeros((), dtype=dtype, device=w.device),
                              torch.zeros((source.dim,), dtype=dtype, device=w.device),
                              w, x, y, off, wt)
            parts[cid, 0] = f_c
            parts[cid, 1:] = g_c
        merged = merge_disjoint(parts, ctx, num_processes)
        # the single-host running sum, replayed over global chunk order
        f = torch.zeros((), dtype=dtype, device=w.device)
        g = torch.zeros((source.dim,), dtype=dtype, device=w.device)
        for c in range(num_chunks_global):
            f = f + merged[c, 0]
            g = g + merged[c, 1:]
        return add_reg(f, g, w, l2_weight)

    return vg


def make_perhost_hvp(source: ChunkedGLMSource, owned_chunk_ids: Sequence[int],
                     num_chunks_global: int, objective: GLMObjective,
                     norm: NormalizationContext, ctx, num_processes: int = 1,
                     l2_weight: float = 0.0, dtype=None, prefetch_depth: Optional[int] = None,
                     bucketer=None, device=None):
    """:func:`make_streaming_hvp` with the same exact merge and replayed
    fold as :func:`make_perhost_value_and_grad` (one merge per CG step)."""
    from photon_ml_tpu_torch.parallel.perhost_streaming import disjoint_fill, merge_disjoint

    dtype = dtype or real_dtype()
    owned = list(owned_chunk_ids)
    acc_hvp = _hvp_chunk_kernel(objective, norm)

    def hvp(w: Tensor, v: Tensor, l2_weight=l2_weight) -> Tensor:
        parts = disjoint_fill((num_chunks_global, source.dim), dtype, w.device)
        chunks = pipelined_device_chunks(source, dtype, prefetch_depth, bucketer,
                                         device or w.device)
        for cid, (x, y, off, wt) in zip(owned, chunks):
            parts[cid] = acc_hvp(torch.zeros((source.dim,), dtype=dtype, device=w.device),
                                 w, v, x, y, off, wt)
        merged = merge_disjoint(parts, ctx, num_processes)
        hv = torch.zeros((source.dim,), dtype=dtype, device=w.device)
        for c in range(num_chunks_global):
            hv = hv + merged[c]
        return hv + l2_weight * v

    return hvp


# ---------------------------------------------------------------------------
# the streamed solves
# ---------------------------------------------------------------------------


def lbfgs_minimize_streaming(value_and_grad_fn, w0: Tensor, config: OptimizerConfig,
                             l1_weight: float = 0.0, bounds=None) -> OptResult:
    """LBFGS / OWL-QN over a streamed objective: the port's host-driven
    solver (optim/lbfgs.py), one streamed pass per evaluation."""
    return lbfgs_minimize(value_and_grad_fn, w0, config, l1_weight=l1_weight, bounds=bounds)


def tron_minimize_streaming(value_and_grad_fn, hvp_fn, w0: Tensor, config: OptimizerConfig,
                            bounds=None) -> OptResult:
    """TRON over a streamed objective: the port's host-driven solver
    (optim/tron.py), one streamed pass per evaluation and per CG step."""
    return tron_minimize_(value_and_grad_fn, hvp_fn, w0, config, bounds=bounds)


def streaming_hessian_diagonal(source: ChunkedGLMSource, objective: GLMObjective,
                               norm: NormalizationContext, w: Tensor, l2_weight: float = 0.0,
                               prefetch_depth: Optional[int] = None, bucketer=None) -> Tensor:
    """diag(H) accumulated over the chunks, plus l2 once: the coefficient
    variances of an out-of-core fit."""
    diag = torch.zeros((source.dim,), dtype=w.dtype, device=w.device)
    for x, y, off, wt in pipelined_device_chunks(source, w.dtype, prefetch_depth, bucketer,
                                                 w.device):
        diag = diag + objective.hessian_diagonal(w, GLMBatch(DenseFeatures(x), y, off, wt),
                                                 norm, 0.0)
    return diag + l2_weight


def streaming_summarize(source: ChunkedGLMSource, device=None) -> BasicStatisticalSummary:
    """BasicStatisticalSummary accumulated over the chunks: the colStats
    pass (stat/BasicStatistics.scala:28-45) for out-of-core data. Each
    statistic is a function of per-chunk sums and extrema, combined in
    float64 on the host."""
    dt = real_dtype()
    dev = resolve_device(device)
    d = source.dim
    n = 0.0
    s, sq, nnz, sabs = (np.zeros(d) for _ in range(4))
    mx = np.full(d, -np.inf)
    mn = np.full(d, np.inf)
    for chunk in source.chunks():
        x = torch.from_numpy(np.array(chunk["x"], dtype=_np_dtype(dt), copy=True)).to(dev)
        n_c = x.shape[0]
        wt = torch.from_numpy(np.array(chunk.get("weights", np.ones(n_c, np.float32)),
                                       dtype=_np_dtype(dt), copy=True)).to(dev)
        present = (wt > 0.0).to(x.dtype)[:, None]
        xm = x * present
        inf = torch.full_like(x, float("inf"))
        parts = (torch.sum(present), torch.sum(xm, dim=0), torch.sum(torch.square(xm), dim=0),
                 torch.sum((xm != 0.0).to(x.dtype), dim=0),
                 torch.amax(torch.where(present > 0, x, -inf), dim=0),
                 torch.amin(torch.where(present > 0, x, inf), dim=0),
                 torch.sum(torch.abs(xm), dim=0))
        cn, cs, csq, cnnz, cmx, cmn, csabs = (p.cpu().numpy() for p in parts)
        n += float(cn)
        s += cs
        sq += csq
        nnz += cnnz
        mx = np.maximum(mx, cmx)
        mn = np.minimum(mn, cmn)
        sabs += csabs
    n = max(n, 1.0)
    mean = s / n
    var = np.maximum((sq - n * mean ** 2) / max(n - 1.0, 1.0), 0.0)
    put = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    return BasicStatisticalSummary(
        mean=put(mean), variance=put(var), count=put(n), num_nonzeros=put(nnz),
        max=put(np.where(np.isfinite(mx), mx, 0.0)), min=put(np.where(np.isfinite(mn), mn, 0.0)),
        norm_l1=put(sabs), norm_l2=put(np.sqrt(sq)), mean_abs=put(sabs / n),
    )
