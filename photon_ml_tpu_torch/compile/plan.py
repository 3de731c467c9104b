"""Execution plans: one resolution of the orthogonal policies (port of
photon_ml_tpu/compile/plan.py, the part the solve schedule needs).

:meth:`ExecutionPlan.resolve` resolves the shape ladder, the solve
schedule, the adaptive bucket schedule, the sparse-kernel spec and the
``--vmapped-grid`` setting once, with the JAX package's rules and words:

  * impossible pairs raise :class:`PlanError`: host-side loops (chunk
    pauses, adaptive bucket visits) cannot live inside ``--vmapped-grid
    true``'s one grid cycle;
  * an adaptive schedule without buckets is pinned to always-visit, a
    recorded :class:`PlanDecision`;
  * the ladder binds into the schedule's bucketer, so compacted lane rungs
    and padded bucket shapes share one rung vocabulary.

Streaming random effects (``streaming``) plan like buckets: blocks are the
unit of adaptive visits, ``--bucketed-random-effects`` beside streaming is
subsumed (a recorded decision), and the prefetch depth is resolved once
here (``PHOTON_PREFETCH_DEPTH``). The rest of the JAX plan waits for the
modules it plans: ``--plan`` and the cost model (compile/cost.py),
``--fused-cycle`` and the mesh (``--distributed``) raise "not yet
ported".
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from photon_ml_tpu_torch.compile.canonical import ShapeBucketer, resolve_bucketer

__all__ = ["ExecutionPlan", "PlanDecision", "PlanError"]


class PlanError(ValueError):
    """A policy combination that is impossible by construction (a host
    re-entry inside one compiled grid cycle)."""


@dataclasses.dataclass(frozen=True)
class PlanDecision:
    """One recorded policy adjustment made during resolution (drivers log
    them)."""

    policy: str  # which policy was adjusted ("schedule", "adaptive", ...)
    action: str  # "subsumed" | "pinned" | "composed" | "skipped"
    reason: str

    def describe(self) -> str:
        return f"{self.policy} {self.action}: {self.reason}"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to photon_ml_tpu_torch")


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """The resolved, immutable execution policy of one training run.
    ``schedule`` already carries the plan's ladder."""

    bucketer: Optional[ShapeBucketer] = None
    schedule: Optional[object] = None  # optim.scheduler.SolveSchedule
    adaptive: Optional[object] = None  # optim.convergence.AdaptiveSchedule
    sparse_kernel: Optional[str] = None
    decisions: Tuple[PlanDecision, ...] = ()
    prefetch_depth: Optional[int] = None  # io.pipeline depth, resolved once
    streaming: bool = False

    @classmethod
    def resolve(cls, *, shape_canonicalization: Optional[str] = None,
                solve_compaction: Optional[object] = None,
                adaptive_schedule: Optional[object] = None, bucketed: bool = False,
                vmapped_grid: str = "false", sparse_kernel: Optional[str] = None,
                distributed: bool = False, streaming: bool = False,
                fused_cycle: bool = False, plan: Optional[str] = None,
                prefetch_depth: Optional[int] = None) -> "ExecutionPlan":
        """Resolve every policy once (``PHOTON_SHAPE_LADDER``,
        ``PHOTON_SOLVE_CHUNK``, ``PHOTON_ADAPTIVE_SCHEDULE`` and
        ``PHOTON_SPARSE_KERNEL`` read when unset) and apply the composition
        rules. Raises :class:`PlanError` for the impossible pairs."""
        from photon_ml_tpu_torch.ops.fused_sparse import resolve_sparse_kernel
        from photon_ml_tpu_torch.optim.convergence import resolve_adaptive
        from photon_ml_tpu_torch.optim.scheduler import resolve_schedule

        if plan is not None and str(plan).strip().lower() not in ("", "off", "false", "0",
                                                                 "no", "none"):
            raise _not_ported("--plan (the cost model, compile/cost.py)")
        from photon_ml_tpu_torch.io.pipeline import resolve_depth

        for flag, on in (("--fused-cycle", fused_cycle), ("--distributed (the mesh)", distributed)):
            if on:
                raise _not_ported(flag)
        bucketer = resolve_bucketer(shape_canonicalization)
        schedule = resolve_schedule(solve_compaction)
        adaptive = resolve_adaptive(adaptive_schedule)
        sparse = resolve_sparse_kernel(sparse_kernel)
        prefetch_depth = resolve_depth(prefetch_depth)
        decisions = []

        # ---- impossible pairs (the fences the plan keeps) -----------------
        if vmapped_grid == "true" and schedule is not None:
            raise PlanError(
                "--vmapped-grid true cannot compose with "
                "--solve-compaction: chunk pauses re-enter the host "
                "inside the compiled grid cycle; use --vmapped-grid auto "
                "to fall back to the per-combo grid"
            )
        if vmapped_grid == "true" and adaptive is not None:
            raise PlanError(
                "--vmapped-grid true cannot compose with "
                "--adaptive-schedule: the block-visitation loop is "
                "host-side; use --vmapped-grid auto to fall back to the "
                "per-combo grid"
            )

        # ---- subsumed pairs ----------------------------------------------
        if streaming and bucketed:
            decisions.append(PlanDecision(
                "bucketed", "subsumed",
                "streaming already sorts entities by size into "
                "tightly-padded blocks; --bucketed-random-effects is "
                "redundant and the streaming coordinate serves both",
            ))
            bucketed = False

        # ---- adaptive block scheduling: needs block/bucket granularity ----
        if adaptive is not None and not (streaming or bucketed):
            decisions.append(PlanDecision(
                "adaptive", "pinned",
                "adaptive scheduling needs block/bucket visitation "
                "granularity; in-memory dense coordinates solve all "
                "entities in one vmapped call (lane-level skew is the "
                "compaction schedule's job) — pinned to always-visit",
            ))
            adaptive = None
        elif adaptive is not None:
            decisions.append(PlanDecision(
                "adaptive", "composed",
                "blocks/buckets are visited in descending "
                "convergence-score order; a block under tolerance for "
                f"{adaptive.patience} consecutive epochs is skipped with "
                "a recorded decision (coefficients carried forward "
                "bitwise, frozen-payload reuse)",
            ))

        # the ladder binds into the schedule: compacted lane rungs and
        # padded bucket shapes share one rung vocabulary
        if schedule is not None and bucketer is not None:
            schedule = dataclasses.replace(schedule, bucketer=bucketer)

        return cls(bucketer=bucketer, schedule=schedule, adaptive=adaptive,
                   sparse_kernel=sparse, decisions=tuple(decisions),
                   prefetch_depth=prefetch_depth, streaming=streaming)

    def describe(self) -> str:
        """One log line: every resolved policy, explicit about 'off'."""
        parts = [
            f"ladder={self.bucketer.describe() if self.bucketer else 'off'}",
            (f"schedule={self.schedule.describe()}"
             if self.schedule is not None else "schedule=one-shot"),
            (f"adaptive={self.adaptive.describe()}"
             if self.adaptive is not None else "adaptive=off"),
            "sharding=none",
            f"sparse={self.sparse_kernel or 'off'}",
            f"streaming={'on' if self.streaming else 'off'}",
        ]
        return "execution plan: " + " ".join(parts)

    def describe_decisions(self) -> Tuple[str, ...]:
        return tuple(d.describe() for d in self.decisions)
