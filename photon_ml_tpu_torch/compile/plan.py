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
here (``PHOTON_PREFETCH_DEPTH``).

Under ``plan="auto"`` (``--plan`` / ``PHOTON_PLAN``) the planner pass of
the JAX package chooses the knobs the caller left unset from the cost model
(compile/cost.py): the solve schedule, the ladder, the sparse family (the
race narrowed to ``sparse_candidates``) and the prefetch depth, plus the
recorded blocking and sharding calls. The model is the ``cost-model.json``
sidecar of ``cost_model_dir`` (loaded, or static priors when the sidecar is
missing or torn, each a recorded decision); ``record_realized`` feeds a
run's realized costs back and ``save_cost_model`` writes the sidecar.
``plan="off"`` (the default) resolves bitwise as before. ``--distributed``
resolves ``sharding="mesh"`` (parallel/), and ``"perhost_streaming"`` with
``--streaming-random-effects`` (owner-computes blocks,
parallel/perhost_streaming.py).

``--fused-cycle`` resolves ``cycle_fusion``: ``"full"`` (the whole descent
iteration runs with no host read between updates, one captured CUDA graph
replayed per iteration where it can be captured:
``CoordinateDescent(fused_cycle=True)``), or ``"solve"`` where a host loop
remains (a solve schedule, promoted to the device rung loop of
optim/fused_schedule.py; streaming blocks, one solve each), each a recorded
decision with the JAX reason. ``--adaptive-schedule`` beside it is a
:class:`PlanError`, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from photon_ml_tpu_torch.compile.canonical import ShapeBucketer, resolve_bucketer
from photon_ml_tpu_torch.compile.cost import CostModel, WorkloadProfile
from photon_ml_tpu_torch.compile.overrides import env_read, resolve_overrides

__all__ = ["ExecutionPlan", "PlanDecision", "PlanError"]


class PlanError(ValueError):
    """A policy combination that is impossible by construction (a host
    re-entry inside one compiled grid cycle)."""


@dataclasses.dataclass(frozen=True)
class PlanDecision:
    """One recorded policy adjustment made during resolution (drivers log
    them). Planner-made choices (``--plan auto``) also carry the model's
    ``predicted_cost`` and, once the run executed, the ``realized_cost``
    fed back through :meth:`ExecutionPlan.record_realized`."""

    policy: str  # which policy was adjusted ("schedule", "adaptive", ...)
    action: str  # "subsumed" | "pinned" | "composed" | "skipped" | "planned:<choice>"
    reason: str
    predicted_cost: Optional[float] = None
    realized_cost: Optional[float] = None

    def describe(self) -> str:
        text = f"{self.policy} {self.action}: {self.reason}"
        if self.predicted_cost is not None:
            text += f" [predicted={self.predicted_cost:.0f}"
            if self.realized_cost is not None:
                text += f" realized={self.realized_cost:.0f}"
            text += "]"
        return text

    def planned_choice(self) -> Optional[str]:
        """The planner's chosen action value ("chunk:8", "on", ...) when
        this is a ``planned:`` decision, else None."""
        if self.action.startswith("planned:"):
            return self.action.split(":", 1)[1]
        return None


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
    sharding: str = "none"  # "mesh" under --distributed ("perhost_streaming" streaming)
    fused_cycle: bool = False
    # what --fused-cycle resolved to: "off" (flag unset), "full" (the whole
    # descent iteration, CoordinateDescent's fused branch) or "solve" (a
    # host loop remains: fusion applies per solve). Drivers gate
    # CoordinateDescent(fused_cycle=...) on cycle_fusion == "full".
    cycle_fusion: str = "off"
    # "off": every knob is the flag or env the caller set (bitwise the
    # resolution without a planner); "auto": unset knobs were chosen by
    # the cost model
    plan_mode: str = "off"
    # the model that made (and learns from) the planned decisions; None
    # under plan_mode="off"
    cost_model: Optional[CostModel] = None
    workload: Optional[WorkloadProfile] = None
    # the planner-narrowed sparse race: the predicted family, validated
    # against the dense incumbent only
    sparse_candidates: Optional[Tuple[str, ...]] = None

    @classmethod
    def resolve(cls, *, shape_canonicalization: Optional[str] = None,
                solve_compaction: Optional[object] = None,
                adaptive_schedule: Optional[object] = None, bucketed: bool = False,
                vmapped_grid: str = "false", sparse_kernel: Optional[str] = None,
                distributed: bool = False, streaming: bool = False,
                fused_cycle: bool = False, plan: Optional[str] = None,
                num_processes: int = 1,
                prefetch_depth: Optional[int] = None,
                workload: Optional[WorkloadProfile] = None,
                cost_model_dir: Optional[str] = None,
                block_costs: Optional[Dict[int, float]] = None) -> "ExecutionPlan":
        """Resolve every policy once (``PHOTON_SHAPE_LADDER``,
        ``PHOTON_SOLVE_CHUNK``, ``PHOTON_ADAPTIVE_SCHEDULE``,
        ``PHOTON_SPARSE_KERNEL``, ``PHOTON_PREFETCH_DEPTH`` and
        ``PHOTON_PLAN`` read when unset) and apply the composition rules.
        Raises :class:`PlanError` for the impossible pairs.

        Under ``plan="auto"`` the knobs the caller left unset are chosen by
        the cost model from ``workload`` and the ``cost-model.json`` of
        ``cost_model_dir``; explicit flags and envs always win, and
        ``plan="off"`` is bitwise the resolution without a planner."""
        from photon_ml_tpu_torch.ops.fused_sparse import resolve_sparse_kernel
        from photon_ml_tpu_torch.optim.convergence import resolve_adaptive
        from photon_ml_tpu_torch.optim.scheduler import resolve_schedule
        from photon_ml_tpu_torch.io.pipeline import resolve_depth

        overrides = resolve_overrides(plan)
        # an explicit prefetch depth (argument or env) wins over the
        # planner: probe before resolve_depth folds in its default
        prefetch_explicit = (prefetch_depth is not None
                             or env_read("PHOTON_PREFETCH_DEPTH") is not None)
        bucketer = resolve_bucketer(shape_canonicalization)
        schedule = resolve_schedule(solve_compaction)
        adaptive = resolve_adaptive(adaptive_schedule)
        sparse = resolve_sparse_kernel(sparse_kernel)
        prefetch_depth = resolve_depth(prefetch_depth)
        decisions = []

        # ---- the planner pass (plan_mode="auto" only) ---------------------
        cost_model: Optional[CostModel] = None
        sparse_candidates: Optional[Tuple[str, ...]] = None
        if overrides.plan_mode == "auto":
            profile = workload or WorkloadProfile()
            cost_model, loaded_decision = cls._load_cost_model(cost_model_dir)
            decisions.append(loaded_decision)
            (schedule, bucketer, sparse, sparse_candidates,
             prefetch_depth) = cls._plan_choices(
                cost_model, profile, decisions,
                schedule=schedule, bucketer=bucketer, sparse=sparse,
                prefetch_depth=prefetch_depth, prefetch_explicit=prefetch_explicit,
                fused_cycle=fused_cycle, vmapped_grid=vmapped_grid,
                resolve_schedule=resolve_schedule,
            )
            # the blocking-drift call: realized per-block costs decide when
            # re-blocking beats another pinned day (always recorded)
            action, predicted, reason = cost_model.reblock_recommendation(block_costs)
            decisions.append(PlanDecision("blocking", f"planned:{action}", reason,
                                          predicted_cost=predicted))

        # ---- whole-cycle fusion: promotion, not fences ---------------------
        cycle_fusion = "off"
        if fused_cycle:
            cycle_fusion = "full"
            if schedule is not None:
                schedule = dataclasses.replace(schedule, loop="device")
                cycle_fusion = "solve"
                decisions.append(PlanDecision(
                    "schedule", "composed",
                    "--solve-compaction under --fused-cycle promotes to "
                    "the fused DEVICE loop (optim/fused_schedule.py): the "
                    "whole chunk→compact→resume cycle compiles into one "
                    "XLA program per ladder rung, so no chunk pause "
                    "re-enters the host; cycle fusion applies per solve, "
                    "results bitwise vs the host chunk loop",
                ))
            if streaming:
                cycle_fusion = "solve"
                decisions.append(PlanDecision(
                    "fused-cycle", "composed",
                    "--streaming-random-effects streams blocks through "
                    "the host per evaluation, so the descent cycle cannot "
                    "be ONE program; the block loop hands each block one "
                    "fused solve instead (cycle fusion at solve "
                    "granularity)",
                ))

        # ---- impossible pairs (the fences the plan keeps) -----------------
        if vmapped_grid == "true" and schedule is not None:
            raise PlanError(
                "--vmapped-grid true cannot compose with "
                "--solve-compaction: chunk pauses re-enter the host "
                "inside the compiled grid cycle; use --vmapped-grid auto "
                "to fall back to the per-combo grid"
            )
        if fused_cycle and adaptive is not None:
            raise PlanError(
                "--adaptive-schedule orders and skips block visits on the "
                "host between solves; --fused-cycle (one XLA program per "
                "iteration) cannot compose"
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

        # ---- sharding mode + composition notes ----------------------------
        sharding = "none"
        if distributed:
            sharding = "perhost_streaming" if streaming else "mesh"
        if sharding == "mesh" and schedule is not None:
            decisions.append(PlanDecision(
                "schedule", "composed",
                "compacted solves under --distributed run on the training "
                "driver's one rank as the single-host compacted solve (the "
                "multihost driver compacts only with --streaming-random-effects)",
            ))
        if sharding == "mesh" and sparse is not None:
            decisions.append(PlanDecision(
                "sparse", "composed",
                "each rank keeps the single-host sparse-kernel selection on its "
                "block of the entities (the kernels are bitwise the plain "
                "formulation, so the selection changes no result)",
            ))
        if sharding == "perhost_streaming" and schedule is not None:
            decisions.append(PlanDecision(
                "schedule", "composed",
                "per-host streaming updates are owner-computes (no "
                "collective), so each rank compacts its owned blocks "
                "independently",
            ))

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
        elif adaptive is not None and sharding == "perhost_streaming":
            decisions.append(PlanDecision(
                "adaptive", "composed",
                "per-host streaming visits owned blocks in "
                "descending-gap order and skips persistently-converged "
                "ones; the per-block ledger is keyed by global block id",
            ))
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

        if cost_model is not None:
            # sharding follows the process topology (the planner cannot
            # conjure cards); the predicted cost is kept for the audit
            decisions.append(PlanDecision(
                "sharding", f"planned:{sharding}",
                f"topology {sharding} from --distributed/--streaming at "
                f"num_processes={num_processes}; predicted cost recorded for the "
                "realized-cost audit",
                predicted_cost=cost_model.predict("sharding", sharding,
                                                  workload or WorkloadProfile()),
            ))

        return cls(bucketer=bucketer, schedule=schedule, adaptive=adaptive,
                   sparse_kernel=sparse, decisions=tuple(decisions),
                   prefetch_depth=prefetch_depth, streaming=streaming, sharding=sharding,
                   fused_cycle=fused_cycle, cycle_fusion=cycle_fusion,
                   plan_mode=overrides.plan_mode,
                   cost_model=cost_model, workload=workload,
                   sparse_candidates=sparse_candidates)

    # ------------------------------------------------------------------
    # the planner pass internals
    # ------------------------------------------------------------------

    @staticmethod
    def _load_cost_model(cost_model_dir: Optional[str]) -> Tuple[CostModel, PlanDecision]:
        """The sidecar model when readable; static priors, as a recorded
        decision, when the sidecar is torn, missing, or no location was
        given. The sidecar is never load-bearing."""
        if cost_model_dir is None:
            return CostModel(), PlanDecision(
                "cost-model", "priors",
                "no cost-model sidecar location — planning from static "
                "priors (first run, or caller opted out of feedback)",
            )
        model = CostModel.load(cost_model_dir)
        if model is None:
            return CostModel(), PlanDecision(
                "cost-model", "degraded",
                f"cost-model.json at {cost_model_dir} is missing or torn — "
                "degrading to static priors (predictions lose this fleet's "
                "realized history until the next run re-banks it)",
            )
        n = sum(int(o.get("n", 0)) for o in model.observations.values())
        return model, PlanDecision(
            "cost-model", "loaded",
            f"realized-cost model from {model.source} "
            f"({len(model.observations)} keys, {n} observations)",
        )

    @classmethod
    def _plan_choices(cls, model: CostModel, profile: WorkloadProfile, decisions: list, *,
                      schedule, bucketer, sparse, prefetch_depth, prefetch_explicit,
                      fused_cycle, vmapped_grid, resolve_schedule):
        """Choose every knob the caller left unset; explicit settings are
        never overridden (the planner fills gaps). The candidates and their
        order are the JAX package's: under ``--fused-cycle`` the host chunk
        loop's pauses cannot compose, so the schedule's candidates narrow
        to one-shot and the device loop."""
        from photon_ml_tpu_torch.io.pipeline import DEFAULT_DEPTH

        # solve-chunk size; never into the --vmapped-grid fence
        if schedule is None and vmapped_grid != "true":
            candidates = (
                ("one-shot", "device:8", "device:16") if fused_cycle
                else ("one-shot", "chunk:2", "chunk:4", "chunk:8", "chunk:16", "chunk:32",
                      "device:8", "device:16"))
            action, predicted, reason = model.choose("schedule", candidates, profile)
            if action.startswith("chunk:"):
                schedule = resolve_schedule(action.split(":", 1)[1])
            elif action.startswith("device:"):
                schedule = resolve_schedule(action)
            decisions.append(PlanDecision("schedule", f"planned:{action}", reason,
                                          predicted_cost=predicted))
        elif schedule is not None:
            spelled = (f"device:{schedule.chunk_size}" if schedule.loop == "device"
                       else f"chunk:{schedule.chunk_size}")
            decisions.append(PlanDecision(
                "schedule", "pinned",
                f"--solve-compaction={spelled} set explicitly "
                "— the planner defers to the hand-tuned value",
                predicted_cost=model.predict("schedule", spelled, profile),
            ))

        # shape ladder
        if bucketer is None:
            action, predicted, reason = model.choose("ladder", ("off", "on"), profile)
            if action == "on":
                bucketer = resolve_bucketer("on")
            decisions.append(PlanDecision("ladder", f"planned:{action}", reason,
                                          predicted_cost=predicted))

        # sparse family: the predicted pick, validated per bucket against
        # the dense incumbent only
        sparse_candidates = None
        if sparse is None and 0.0 < profile.density < 1.0:
            action, predicted, reason = model.choose(
                "sparse", ("dense", "segment", "scatter", "flat"), profile)
            if action != "dense":
                sparse = "auto"
                sparse_candidates = (action,)
                reason += (
                    " — validated per bucket against the dense incumbent "
                    "only (race narrowed from every family to the "
                    "predicted one)"
                )
            decisions.append(PlanDecision("sparse", f"planned:{action}", reason,
                                          predicted_cost=predicted))

        # prefetch depth
        if not prefetch_explicit:
            action, predicted, reason = model.choose(
                "prefetch", (str(DEFAULT_DEPTH), "0", "4"), profile)
            prefetch_depth = int(action)
            decisions.append(PlanDecision("prefetch", f"planned:{action}", reason,
                                          predicted_cost=predicted))

        return schedule, bucketer, sparse, sparse_candidates, prefetch_depth

    # ------------------------------------------------------------------
    # realized-cost feedback
    # ------------------------------------------------------------------

    def record_realized(self, policy: str, realized: float) -> None:
        """Attach the realized cost to this plan's ``planned:`` decision for
        ``policy`` and fold it into the cost model's EMA. No-op under
        plan_mode="off" (nothing was planned)."""
        if self.plan_mode != "auto" or self.cost_model is None:
            return
        profile = self.workload or WorkloadProfile()
        updated = []
        hit = False
        for d in self.decisions:
            choice = d.planned_choice()
            if not hit and d.policy == policy and choice is not None:
                updated.append(dataclasses.replace(d, realized_cost=float(realized)))
                self.cost_model.observe(policy, choice, profile, float(realized),
                                        predicted=d.predicted_cost)
                hit = True
            else:
                updated.append(d)
        if hit:
            # decisions belongs to a frozen dataclass: swap the tuple in place
            object.__setattr__(self, "decisions", tuple(updated))

    def save_cost_model(self, directory: str) -> Optional[str]:
        """Write the fed-back model beside the manifest (atomic); None under
        plan_mode="off"."""
        if self.cost_model is None:
            return None
        return self.cost_model.save(directory)

    def describe(self) -> str:
        """One log line: every resolved policy, explicit about 'off'."""
        parts = [
            f"ladder={self.bucketer.describe() if self.bucketer else 'off'}",
            (f"schedule={self.schedule.describe()}"
             if self.schedule is not None else "schedule=one-shot"),
            (f"adaptive={self.adaptive.describe()}"
             if self.adaptive is not None else "adaptive=off"),
            f"sharding={self.sharding}",
            f"sparse={self.sparse_kernel or 'off'}",
            f"streaming={'on' if self.streaming else 'off'}",
        ]
        if self.fused_cycle:
            parts.append(f"fused-cycle={self.cycle_fusion}")
        if self.plan_mode != "off":
            parts.append(f"plan={self.plan_mode}"
                         + (f"[{self.cost_model.source}]" if self.cost_model else ""))
        return "execution plan: " + " ".join(parts)

    def describe_decisions(self) -> Tuple[str, ...]:
        return tuple(d.describe() for d in self.decisions)
