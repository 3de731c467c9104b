"""Coordinate descent over GAME coordinates (port of the per-update path of
photon_ml_tpu/algorithm/coordinate_descent.py).

Reference spec: algorithm/CoordinateDescent.scala:37-212 — for each
iteration and each coordinate: subtract the coordinate's own score from the
total, update it on those residuals, re-score, record the objective (the
training loss of the total scores plus every coordinate's regularization
term) and the validation metrics after the update. Scores are dense (N,)
tensors in global row order.

With a checkpointer the state is saved after every update and a restart
resumes from the last complete step; preemption is polled at every update
boundary (site ``"cycle"``), where the finished steps are made durable
before :class:`~photon_ml_tpu_torch.resilience.preemption.Preempted`
unwinds; a divergence guard gates every update. The fused cycle and the
lambda grid are not yet ported.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from photon_ml_tpu_torch.checkpoint import CheckpointState
from photon_ml_tpu_torch.resilience import faults, preemption
from photon_ml_tpu_torch.resilience.guards import DivergenceGuard, GuardEvent
from photon_ml_tpu_torch.types import real_dtype

Tensor = torch.Tensor


@dataclasses.dataclass
class CoordinateDescentResult:
    """Final per-coordinate parameters and the run's tracking."""

    coefficients: Dict[str, Tensor]  # coordinate -> (D,) or (E, D_loc)
    total_scores: Tensor  # (N,) final summed training scores
    objective_history: List[float]  # after every coordinate update
    validation_history: List[Dict[str, float]]  # per update, per evaluator
    # coordinate -> cumulative update seconds, and "(validation)" -> the
    # validation scoring and metrics, on the host clock
    timings: Dict[str, float]
    # coordinate -> the last update's OptResult (lane axis for random effects)
    trackers: Dict[str, object] = dataclasses.field(default_factory=dict)
    # divergence-guard incidents of this run: every rollback / skipped cycle
    guard_events: List[GuardEvent] = dataclasses.field(default_factory=list)


class CoordinateDescent:
    """Runs coordinates in their update sequence.

    ``coordinates`` is an ordered dict name -> coordinate with
    ``initial_coefficients()``, ``update(residual_offsets, init) -> (params,
    result)``, ``score(params) -> (N,)`` and ``regularization_term(params)``.
    ``training_loss(total_scores)`` gives the loss part of the objective;
    ``validation_scorer(params map) -> (Nv,)`` and ``validation_evaluators``
    (name -> (Evaluator, kwargs of its evaluate)) give the metrics recorded
    after every update. ``divergence_guard`` gates every update: a
    non-finite parameter/score state is rolled back to the coordinate's last
    good state instead of poisoning the shared score vectors.
    """

    def __init__(self, coordinates: Dict[str, object],
                 training_loss: Callable[[Tensor], Tensor],
                 validation_scorer: Optional[Callable[[Dict[str, Tensor]], Tensor]] = None,
                 validation_evaluators: Optional[Dict[str, Tuple[object, dict]]] = None,
                 divergence_guard: Optional[DivergenceGuard] = None):
        self.coordinates = coordinates
        self.training_loss = training_loss
        self.validation_scorer = validation_scorer
        self.validation_evaluators = validation_evaluators or {}
        self.divergence_guard = divergence_guard

    def _objective(self, total: Tensor, params: Dict[str, Tensor]) -> Tensor:
        return self.training_loss(total) + sum(
            self.coordinates[n].regularization_term(params[n]) for n in self.coordinates
        )

    def run(self, num_iterations: int, num_rows: int, checkpointer=None,
            initial_params: Optional[Dict[str, Tensor]] = None) -> CoordinateDescentResult:
        """``checkpointer`` (``checkpoint.CoordinateDescentCheckpointer`` or
        its async wrapper) saves after every update and resumes from the
        last complete step, which takes precedence over ``initial_params``.
        ``initial_params`` warm-starts named coordinates; they contribute
        their scores from step zero."""
        names = list(self.coordinates)
        device = next(iter(self.coordinates.values())).initial_coefficients().device
        params = {
            n: (initial_params[n] if initial_params is not None and n in initial_params
                else self.coordinates[n].initial_coefficients())
            for n in names
        }
        zeros = lambda: torch.zeros((num_rows,), dtype=real_dtype(), device=device)
        scores = {n: zeros() for n in names}
        if initial_params is not None:
            for n in names:
                if n in initial_params:
                    scores[n] = self.coordinates[n].score(params[n])
        total = zeros()
        for n in names:
            total = total + scores[n]

        # device scalars until a save or the end of the run
        objective_dev: List[Tensor] = []
        validation_dev: List[Dict[str, Tensor]] = []
        objective_history: List[float] = []
        validation_history: List[Dict[str, float]] = []
        timings = {n: 0.0 for n in names}
        timings["(validation)"] = 0.0
        trackers: Dict[str, object] = {}

        start_step = 0
        if checkpointer is not None:
            restored = checkpointer.restore(params, scores, total)
            if restored is not None:
                start_step = restored.step
                params, scores, total = restored.params, restored.scores, restored.total_scores
                objective_history = restored.objective_history
                validation_history = restored.validation_history

        def drain() -> None:
            objective_history.extend(float(v) for v in objective_dev)
            validation_history.extend({k: float(v) for k, v in m.items()}
                                      for m in validation_dev)
            objective_dev.clear()
            validation_dev.clear()

        def save(step: int) -> str:
            drain()
            return checkpointer.save(CheckpointState(
                step=step, params=params, scores=scores, total_scores=total,
                objective_history=objective_history, validation_history=validation_history,
            ))

        guard = self.divergence_guard
        guard_events_start = len(guard.events) if guard is not None else 0
        step = 0
        for it in range(num_iterations):
            skip_rest_of_cycle = False
            for name in names:
                step += 1
                if step <= start_step:
                    continue  # completed before the restart
                coord = self.coordinates[name]
                if not skip_rest_of_cycle:
                    partial = total - scores[name]  # the other coordinates' scores
                    t0 = time.perf_counter()
                    new_params, trackers[name] = coord.update(partial, params[name])
                    # chaos hook: a kind="nan" fault here corrupts the update
                    # exactly like a diverged solve
                    new_params = faults.corrupt("optim.step", new_params,
                                                coordinate=name, step=step)
                    new_score = coord.score(new_params)
                    if guard is not None:
                        new_params, new_score, ok = guard.filter_update(
                            name, step, new_params, new_score, params[name], scores[name])
                        if not ok and guard.mode == "skip_cycle":
                            skip_rest_of_cycle = True
                    timings[name] += time.perf_counter() - t0
                    params[name] = new_params
                    scores[name] = new_score
                    total = partial + new_score
                # else the guard abandoned this cycle: the state is unchanged,
                # but histories and checkpoints stay one entry per update
                objective_dev.append(self._objective(total, params))
                if self.validation_scorer is not None:
                    t0 = time.perf_counter()
                    v_scores = self.validation_scorer(params)
                    validation_dev.append({
                        key: ev.evaluate(v_scores, **kw)
                        for key, (ev, kw) in self.validation_evaluators.items()
                    })
                    timings["(validation)"] += time.perf_counter() - t0

                path = save(step) if checkpointer is not None else None
                # every update boundary is a safe drain point: the finished
                # step is saved, so make it durable and unwind (the last
                # update just ends)
                is_last = it == num_iterations - 1 and name == names[-1]
                if not is_last and preemption.check("cycle", step=step):
                    if checkpointer is not None:
                        checkpointer.wait()  # an async commit is durable before exit
                    raise preemption.Preempted(
                        f"preempted at update boundary (step {step}): {preemption.reason()}",
                        site="cycle", checkpoint_path=path,
                    )
        drain()
        return CoordinateDescentResult(
            coefficients=params,
            total_scores=total,
            objective_history=objective_history,
            validation_history=validation_history,
            timings=timings,
            trackers=trackers,
            guard_events=list(guard.events[guard_events_start:]) if guard is not None else [],
        )
