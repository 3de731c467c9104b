"""Shared optimizer plumbing: configs and results (port of
photon_ml_tpu/optim/common.py).

Reference behavior spec: optimization/Optimizer.scala:29-263 and
AbstractOptimizer.scala:26-132 (convergence criteria :47-61). Per-iteration
(value, |grad|) histories live in fixed-size NaN-padded tensors, mirroring
the reference's OptimizationStatesTracker.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from photon_ml_tpu_torch.types import ConvergenceReason

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Solve configuration. Defaults mirror the reference: LBFGS max 80
    iterations / tol 1e-7 / 10 corrections (LBFGS.scala:136-139). TRON's
    fields are not yet ported."""

    max_iterations: int = 80
    tolerance: float = 1e-7
    num_corrections: int = 10
    max_line_search_steps: int = 25

    @staticmethod
    def lbfgs_default() -> "OptimizerConfig":
        return OptimizerConfig(max_iterations=80, tolerance=1e-7)


class OptResult(NamedTuple):
    """Result of one solve. Fields are tensors; a lane-batched solve gives
    every field a leading lane axis."""

    coefficients: Tensor  # (D,)
    value: Tensor  # () final objective value (incl. the L1 term for OWL-QN)
    grad_norm: Tensor  # () final (pseudo-)gradient norm
    iterations: Tensor  # () int64 — iterations actually performed
    reason: Tensor  # () int64 ConvergenceReason code
    value_history: Tensor  # (max_iter + 1,) — NaN beyond `iterations`
    grad_norm_history: Tensor  # (max_iter + 1,) — NaN beyond `iterations`
    # per-iteration coefficient snapshots (max_iter + 1, D) when the solve
    # tracked them (the ModelTracker analogue); None otherwise
    coefficient_history: Optional[Tensor] = None


def summarize_result(res: OptResult) -> str:
    """Human-readable solve summary (Summarizable.toSummaryString analogue)."""
    reason = ConvergenceReason(int(res.reason)).name
    return (
        f"value={float(res.value):.6g} |grad|={float(res.grad_norm):.3e} "
        f"iters={int(res.iterations)} reason={reason}"
    )
