"""The distributed fixed-effect solver (port of the fixed-effect half of
photon_ml_tpu/parallel/distributed.py).

The reference broadcasts the coefficients and treeAggregates (loss,
gradient, Hv) every optimizer iteration (DiffFunction.scala:126-143,
TRON.scala:268-281). Here the rows are split over the ranks; every rank
runs the same LBFGS/OWL-QN/TRON loop, and each value+gradient (and Hv) is
the rank's local pass (the fused kernel on the card, or the plain pass)
followed by the mesh's fixed-order sum, so every rank walks one
trajectory. At one rank the solve is the single-process solve, bit for bit.

The JAX module's entity-sharded random-effect and factored solvers split
one process's dataset over its devices. The port runs one process per
device, so entities are sharded where they are ingested instead: the
per-host solvers of parallel/perhost_ingest.py and
parallel/perhost_factored.py, which the multihost driver runs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_tpu_torch.ops.features import DenseFeatures
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMBatch
from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.parallel.mesh import MeshContext

Tensor = torch.Tensor


def _agreed_fused_block_rows(ctx: MeshContext, problem: GLMOptimizationProblem,
                             batch: GLMBatch) -> Optional[int]:
    """Each rank races the fused kernel on its own block; every rank then
    takes rank 0's answer, so all ranks run one formulation."""
    from photon_ml_tpu_torch.ops import losses as losses_mod
    from photon_ml_tpu_torch.ops.fused_glm import select_fused_block_rows

    block = select_fused_block_rows(losses_mod.for_task(problem.task), batch.num_rows,
                                    batch.dim, batch.features.matrix.dtype, batch.device)
    mine = torch.tensor([-1 if block is None else int(block)], dtype=torch.int64)
    agreed = int(ctx.all_gather(mine)[0].item())
    return None if agreed < 0 else agreed


@dataclasses.dataclass
class DistributedFixedEffectSolver:
    """Data-parallel GLM solve: rows split over the ranks, coefficients
    replicated, every objective evaluation summed in rank order."""

    problem: GLMOptimizationProblem
    ctx: MeshContext

    def __post_init__(self):
        self.problem = dataclasses.replace(self.problem, collective=self.ctx.sum)
        self._fused_tuned = False

    def _maybe_autotune_fused(self, batch: GLMBatch) -> None:
        """Race the fused value+gradient kernel on this rank's block (the
        card only; the answer is agreed across ranks)."""
        if self._fused_tuned:
            return
        self._fused_tuned = True
        if self.problem.fused_block_rows is not None or not isinstance(batch.features,
                                                                     DenseFeatures):
            return
        block = _agreed_fused_block_rows(self.ctx, self.problem, batch)
        if block is not None:
            self.problem = dataclasses.replace(self.problem, fused_block_rows=block)

    def run(self, batch: GLMBatch, norm: NormalizationContext,
            init_coefficients: Optional[Tensor] = None, reg_weight: Optional[float] = None):
        """Solve on this rank's rows; returns the replicated (model, result)."""
        self._maybe_autotune_fused(batch)
        return self.problem.run(batch, norm, init_coefficients, reg_weight)
