"""Shared optimizer plumbing: configs and results (port of
photon_ml_tpu/optim/common.py).

Reference behavior spec: optimization/Optimizer.scala:29-263 and
AbstractOptimizer.scala:26-132 (convergence criteria :47-61). Per-iteration
(value, |grad|) histories live in fixed-size NaN-padded tensors, mirroring
the reference's OptimizationStatesTracker.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from photon_ml_tpu_torch.ops.fused_sparse import tree_row_sum
from photon_ml_tpu_torch.types import ConvergenceReason

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Solve configuration. Defaults mirror the reference: LBFGS max 80
    iterations / tol 1e-7 / 10 corrections (LBFGS.scala:136-139); TRON max
    15 / tol 1e-5 / 20 CG iterations (TRON.scala:226-233)."""

    max_iterations: int = 80
    tolerance: float = 1e-7
    # LBFGS
    num_corrections: int = 10
    max_line_search_steps: int = 25
    # TRON
    max_cg_iterations: int = 20
    max_improvement_failures: int = 5

    @staticmethod
    def lbfgs_default() -> "OptimizerConfig":
        return OptimizerConfig(max_iterations=80, tolerance=1e-7)

    @staticmethod
    def tron_default() -> "OptimizerConfig":
        return OptimizerConfig(max_iterations=15, tolerance=1e-5)


class HostReads:
    """Count of the values the solver loops read back from their tensors
    to decide on the host (each is a sync with the card): the solve
    scheduler's ledger charges a solve the reads made while it ran."""

    count = 0

    @classmethod
    def read(cls, t: Tensor):
        """``t.item()``, counted."""
        cls.count += 1
        return t.item()


class FixedTrips:
    """The fused descent cycle's solver mode (``fixed_trip_solves``): while
    ``on``, the one-shot lane solves (``lbfgs_minimize_lanes``,
    ``tron_minimize_lanes`` and their single-problem forms) run their
    fixed-trip-count form, ``max_iterations`` iterations of every
    line-search or CG step with converged lanes masked, and test nothing on
    the host. A masked step is exact, so every lane ends bitwise where the
    host-tested solve leaves it. ``trips`` (when set) runs that many
    iterations instead: the fused cycle's warm-up, which touches every
    operation of the iteration once before it is captured."""

    on = False
    trips: Optional[int] = None

    @classmethod
    def count(cls, config: "OptimizerConfig") -> int:
        return config.max_iterations if cls.trips is None else cls.trips


@contextlib.contextmanager
def fixed_trip_solves(trips: Optional[int] = None):
    """Run the one-shot solves inside the block in their fixed-trip form
    (:class:`FixedTrips`), ``trips`` iterations each when given."""
    before = FixedTrips.on, FixedTrips.trips
    FixedTrips.on, FixedTrips.trips = True, trips
    try:
        yield
    finally:
        FixedTrips.on, FixedTrips.trips = before


class LaneSums(NamedTuple):
    """The reductions a lane solver takes over each lane's coefficients
    (the last axis)."""

    sum: Callable[[Tensor], Tensor]
    dot: Callable[[Tensor, Tensor], Tensor]
    norm: Callable[[Tensor], Tensor]


#: torch's own reductions: what one problem, or lanes that always ride in
#: the same batch, are solved with
LIBRARY_SUMS = LaneSums(
    sum=lambda x: torch.sum(x, dim=-1),
    dot=lambda a, b: torch.sum(a * b, dim=-1),
    norm=lambda a: torch.linalg.vector_norm(a, dim=-1),
)


def _wide_sum(x: Tensor) -> Tensor:
    return tree_row_sum(x.double()).to(x.dtype)


#: each lane's row in the fixed association of ``tree_row_sum``, in float64
#: (a float32 product is exact there) and rounded back: a lane's sums are a
#: function of its own values alone, whatever the batch it rides in, and
#: they stay close to the exact sum, which any other order approximates.
#: torch's reductions may choose their order from the number of rows, so
#: the random-effect lanes, which the solve scheduler moves between
#: batches, are solved with these.
FIXED_SUMS = LaneSums(
    sum=_wide_sum,
    dot=lambda a, b: tree_row_sum(a.double() * b.double()).to(a.dtype),
    norm=lambda a: torch.sqrt(tree_row_sum(torch.square(a.double()))).to(a.dtype),
)


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


def iteration_histogram(iterations) -> str:
    """Power-of-2 histogram of per-lane iteration counts, e.g.
    ``<=4:120 <=8:30 <=32:1``."""
    import numpy as np

    iters = np.asarray(iterations).ravel()
    if iters.size == 0:
        return "(empty)"
    top = int(iters.max())
    parts = []
    lo, hi = -1, 1
    while lo < top:
        n = int(np.sum((iters > lo) & (iters <= hi)))
        if n:
            parts.append(f"<={hi}:{n}")
        lo = hi
        hi *= 2
    return " ".join(parts) if parts else "(empty)"


def summarize_stacked_results(res: OptResult) -> str:
    """Summary of a lane-batched solve: convergence-reason counts and the
    iteration histogram (RandomEffectOptimizationTracker.scala:62-95)."""
    import numpy as np

    reasons = res.reason.detach().cpu().numpy().ravel()
    iters = res.iterations.detach().cpu().numpy().ravel()
    values = res.value.detach().cpu().numpy().ravel()
    counts = {
        ConvergenceReason(int(code)).name: int(n)
        for code, n in zip(*np.unique(reasons, return_counts=True))
        if code != 0
    }
    return (
        f"entities={reasons.size} convergenceReasons={counts} "
        f"iterations(mean={iters.mean():.1f} max={int(iters.max())} "
        f"histogram: {iteration_histogram(iters)}) "
        f"value(mean={values.mean():.6g} max={values.max():.6g})"
    )
