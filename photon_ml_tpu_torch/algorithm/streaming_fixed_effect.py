"""Out-of-core fixed-effect coordinate for GAME coordinate descent (port of
photon_ml_tpu/algorithm/streaming_fixed_effect.py, single host).

The GLM driver's chunk streaming (optim/streaming.py) applied to the GAME
fixed effect: the batch lives in memory-mapped row chunks, every optimizer
evaluation streams them through the chunked value+gradient pass, and
scoring streams margins chunk by chunk. Residual offsets fold in per
chunk: chunk rows are contiguous, so a chunk's residuals are a slice of
the global (N,) vector (Coordinate.scala:43-49, chunked).

A drop-in for ``CoordinateDescent`` (``update`` / ``score`` /
``initial_coefficients`` / ``regularization_term``).
:class:`PerHostStreamingFixedEffectCoordinate` is the per-host variant: each
rank streams the chunks it owns of a global chunk list and the per-chunk
partials merge exactly across the ranks. Both poll a re-plan monitor
(``elastic``, parallel/elastic.py) at update and score entry only: a
streamed evaluation may hold collectives, so a drain inside one could
strand a peer there.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.optim.common import OptResult
from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem, _split_reg_weight
from photon_ml_tpu_torch.optim.streaming import (
    ChunkedGLMSource,
    lbfgs_minimize_streaming,
    make_perhost_hvp,
    make_perhost_value_and_grad,
    make_streaming_hvp,
    make_streaming_value_and_grad,
    pipelined_device_chunks,
    tron_minimize_streaming,
)
from photon_ml_tpu_torch.types import OptimizerType, real_dtype

Tensor = torch.Tensor


def _elastic_entry_drain(monitor, where: str) -> None:
    """The fixed effects' drain hook, at whole-evaluation entries."""
    if monitor is None:
        return
    from photon_ml_tpu_torch.parallel.elastic import drain_if_replan_pending

    drain_if_replan_pending(monitor, where=where)


def _streamed_update(problem: GLMOptimizationProblem, vg, hvp, l1_weight,
                     init_coefficients: Tensor) -> Tuple[Tensor, OptResult]:
    """The streamed-update dispatch (bounds, TRON or LBFGS), defined once."""
    bounds = ((problem.constraints.lower, problem.constraints.upper)
              if problem.constraints is not None else None)
    w0 = init_coefficients.to(real_dtype())
    if hvp is not None:
        res = tron_minimize_streaming(vg, hvp, w0, problem.optimizer_config, bounds=bounds)
    else:
        res = lbfgs_minimize_streaming(vg, w0, problem.optimizer_config, l1_weight=l1_weight,
                                       bounds=bounds)
    return res.coefficients, res


@dataclasses.dataclass
class StreamingFixedEffectCoordinate:
    """Fixed-effect coordinate over a :class:`ChunkedGLMSource`."""

    # every evaluation streams chunks through the host: no fused cycle
    cd_jit = False
    source: ChunkedGLMSource
    problem: GLMOptimizationProblem
    norm: NormalizationContext = dataclasses.field(default_factory=NormalizationContext.identity)
    # io/pipeline depth; None reads PHOTON_PREFETCH_DEPTH (default 2)
    prefetch_depth: Optional[int] = None
    # the chunk rows' ladder (compile.ShapeBucketer or spec; None reads
    # PHOTON_SHAPE_LADDER): weight-0 pad rows give every chunk one shape
    bucketer: Optional[object] = None
    # the resolved compile.plan.ExecutionPlan: fills the ladder and depth when unset
    plan: Optional[object] = None
    device: Optional[object] = None  # where chunks are evaluated (default cuda)
    # the re-plan monitor (parallel/elastic.ElasticMonitor), polled at
    # update and score entry; None = off
    elastic: Optional[object] = None

    def __post_init__(self):
        from photon_ml_tpu_torch.compile.canonical import resolve_bucketer

        if self.plan is not None:
            if self.bucketer is None:
                self.bucketer = self.plan.bucketer or "off"
            if self.prefetch_depth is None:
                self.prefetch_depth = self.plan.prefetch_depth
        self.bucketer = resolve_bucketer(self.bucketer)
        self._device = resolve_device(self.device)
        # chunk sizes are fixed for the source's lifetime (a memory-mapped
        # chunk's length reads only its header)
        self._chunk_sizes = [len(load()["y"]) for load in self.source.loaders]
        # the factories close over this source; update swaps its loaders
        # for the residual view
        self._live_source = ChunkedGLMSource(loaders=list(self.source.loaders),
                                             dim=self.source.dim, num_rows=self.source.num_rows)
        l1, l2 = _split_reg_weight(self.problem.regularization, None)
        self._l1, self._l2 = float(l1), float(l2)
        kw = dict(l2_weight=self._l2, prefetch_depth=self.prefetch_depth, bucketer=self.bucketer,
                  device=self._device)
        self._vg = make_streaming_value_and_grad(self._live_source, self.problem.objective,
                                                 self.norm, **kw)
        # TRON streams one more pass per CG step (TRON.scala:268-281)
        self._hvp = (make_streaming_hvp(self._live_source, self.problem.objective, self.norm, **kw)
                     if self.problem.optimizer == OptimizerType.TRON else None)

    @property
    def dim(self) -> int:
        return self.source.dim

    def initial_coefficients(self) -> Tensor:
        return torch.zeros((self.dim,), dtype=real_dtype(), device=self._device)

    def _residual_loaders(self, residual_offsets) -> list:
        """Chunk loaders with the residuals folded into the offsets."""
        resid = torch.as_tensor(residual_offsets).detach().cpu().numpy()
        loaders, lo = [], 0
        for load, n_here in zip(self.source.loaders, self._chunk_sizes):
            def wrap(load=load, lo=lo, n_c=n_here):
                chunk = dict(load())
                base = np.asarray(chunk.get("offsets", np.zeros(n_c, np.float32)))
                chunk["offsets"] = base + resid[lo: lo + n_c]
                return chunk

            loaders.append(wrap)
            lo += n_here
        return loaders

    def update(self, residual_offsets: Tensor, init_coefficients: Tensor
               ) -> Tuple[Tensor, OptResult]:
        _elastic_entry_drain(self.elastic, "streaming-FE update entry")
        self._live_source.loaders = self._residual_loaders(residual_offsets)
        return _streamed_update(self.problem, self._vg, self._hvp, self._l1, init_coefficients)

    def score(self, coefficients: Tensor) -> Tensor:
        """(N,) raw margins, chunk by chunk through the pipeline (no
        offsets: GAME scores are additive margin contributions). Pad rows
        of ladder-padded chunks are sliced off."""
        _elastic_entry_drain(self.elastic, "streaming-FE score entry")
        w_eff = self.norm.effective_coefficients(coefficients)
        shift = self.norm.margin_shift(w_eff)
        outs = [(x @ w_eff + shift)[:n_here] for (x, _, _, _), n_here in zip(
            pipelined_device_chunks(self.source, real_dtype(), self.prefetch_depth,
                                    self.bucketer, self._device),
            self._chunk_sizes)]
        return (torch.cat(outs) if outs
                else torch.zeros((0,), dtype=real_dtype(), device=self._device))

    def regularization_term(self, coefficients: Tensor) -> Tensor:
        return self.problem.regularization_term_value(coefficients)


@dataclasses.dataclass
class PerHostStreamingFixedEffectCoordinate:
    """Fixed-effect coordinate over a global chunk list of which this rank
    owns some chunks (per-host streaming coordinate descent,
    parallel/perhost_streaming.py): every evaluation streams the owned
    chunks through the single-host coordinate's chunk arithmetic, the
    per-chunk partials merge exactly across the ranks and every rank
    replays the single-host fold, so the LBFGS or TRON trajectory is the
    same on every rank and bitwise the single-host streaming run on the
    same chunk list (optim/streaming.make_perhost_value_and_grad). Scoring
    writes the owned chunks' margins into the global (N,) vector and merges
    the disjoint writes exactly.

    ``chunk_sizes`` is the global per-chunk row count (chunks tile [0, N)
    in order; in the multihost driver a chunk is one input part file, so
    ownership is the per-rank file share); ``owned_loaders`` maps this
    rank's global chunk ids to loaders of {"x", "y", optional "offsets" /
    "weights"} host dicts."""

    cd_jit = False  # streamed and merged across ranks every evaluation

    chunk_sizes: List[int]
    owned_loaders: Dict[int, object]  # chunk id -> () -> host chunk dict
    dim: int
    problem: GLMOptimizationProblem
    ctx: Optional[object] = None  # parallel.mesh.MeshContext
    num_processes: int = 1
    norm: NormalizationContext = dataclasses.field(default_factory=NormalizationContext.identity)
    prefetch_depth: Optional[int] = None
    bucketer: Optional[object] = None
    # the resolved compile.plan.ExecutionPlan: fills the ladder and depth when unset
    plan: Optional[object] = None
    device: Optional[object] = None  # where chunks are evaluated (default cuda)
    # the re-plan monitor, polled at update and score entry only (the
    # chunk evaluations hold collectives)
    elastic: Optional[object] = None

    def __post_init__(self):
        from photon_ml_tpu_torch.compile.canonical import resolve_bucketer

        if self.num_processes > 1 and self.ctx is None:
            raise ValueError("PerHostStreamingFixedEffectCoordinate needs a MeshContext to merge "
                             "chunk partials across processes")
        if self.plan is not None:
            if self.bucketer is None:
                self.bucketer = self.plan.bucketer or "off"
            if self.prefetch_depth is None:
                self.prefetch_depth = self.plan.prefetch_depth
        self.bucketer = resolve_bucketer(self.bucketer)
        self._device = resolve_device(self.device)
        self._owned_ids = sorted(self.owned_loaders)
        self._chunk_starts = np.concatenate([[0], np.cumsum(self.chunk_sizes)]).astype(np.int64)
        self.num_rows = int(self._chunk_starts[-1])
        # the factories close over this source; update swaps its loaders for
        # the residual view
        self._live_source = ChunkedGLMSource(
            loaders=[self.owned_loaders[c] for c in self._owned_ids], dim=self.dim,
            num_rows=sum(int(self.chunk_sizes[c]) for c in self._owned_ids))
        l1, l2 = _split_reg_weight(self.problem.regularization, None)
        self._l1, self._l2 = float(l1), float(l2)
        kw = dict(l2_weight=self._l2, prefetch_depth=self.prefetch_depth, bucketer=self.bucketer,
                  device=self._device)
        args = (self._live_source, self._owned_ids, len(self.chunk_sizes),
                self.problem.objective, self.norm, self.ctx, self.num_processes)
        self._vg = make_perhost_value_and_grad(*args, **kw)
        self._hvp = (make_perhost_hvp(*args, **kw)
                     if self.problem.optimizer == OptimizerType.TRON else None)

    def initial_coefficients(self) -> Tensor:
        return torch.zeros((self.dim,), dtype=real_dtype(), device=self._device)

    def _residual_loaders(self, residual_offsets) -> list:
        """Owned-chunk loaders with the (N,) residuals folded into the
        offsets: each chunk takes its contiguous global row slice."""
        resid = torch.as_tensor(residual_offsets).detach().cpu().numpy()
        loaders = []
        for c in self._owned_ids:
            lo, n_c = int(self._chunk_starts[c]), int(self.chunk_sizes[c])

            def wrap(load=self.owned_loaders[c], lo=lo, n_c=n_c):
                chunk = dict(load())
                base = np.asarray(chunk.get("offsets", np.zeros(n_c, np.float32)))
                chunk["offsets"] = base + resid[lo: lo + n_c]
                return chunk

            loaders.append(wrap)
        return loaders

    def update(self, residual_offsets: Tensor, init_coefficients: Tensor
               ) -> Tuple[Tensor, OptResult]:
        _elastic_entry_drain(self.elastic, "perhost-FE update entry")
        self._live_source.loaders = self._residual_loaders(residual_offsets)
        return _streamed_update(self.problem, self._vg, self._hvp, self._l1, init_coefficients)

    def score(self, coefficients: Tensor) -> Tensor:
        """(N,) raw margins: the owned chunks' margins (the single-host
        coordinate's ``x @ w_eff + shift``, pad rows sliced off) written
        into their global rows, merged exactly across the ranks."""
        from photon_ml_tpu_torch.parallel.perhost_streaming import disjoint_fill, merge_disjoint

        _elastic_entry_drain(self.elastic, "perhost-FE score entry")
        self._live_source.loaders = [self.owned_loaders[c] for c in self._owned_ids]
        w_eff = self.norm.effective_coefficients(coefficients)
        shift = self.norm.margin_shift(w_eff)
        local = disjoint_fill(self.num_rows, real_dtype(), self._device)
        chunks = pipelined_device_chunks(self._live_source, real_dtype(), self.prefetch_depth,
                                         self.bucketer, self._device)
        for c, (x, _, _, _) in zip(self._owned_ids, chunks):
            lo, n_c = int(self._chunk_starts[c]), int(self.chunk_sizes[c])
            local[lo: lo + n_c] = (x @ w_eff + shift)[:n_c]
        return merge_disjoint(local, self.ctx, self.num_processes)

    def regularization_term(self, coefficients: Tensor) -> Tensor:
        return self.problem.regularization_term_value(coefficients)
