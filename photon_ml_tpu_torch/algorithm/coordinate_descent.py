"""Coordinate descent over GAME coordinates (port of the per-update path of
photon_ml_tpu/algorithm/coordinate_descent.py).

Reference spec: algorithm/CoordinateDescent.scala:37-212 — for each
iteration and each coordinate: subtract the coordinate's own score from the
total, update it on those residuals, re-score, record the objective (the
training loss of the total scores plus every coordinate's regularization
term) and the validation metrics after the update. Scores are dense (N,)
tensors in global row order. The fused cycle, the lambda grid and
checkpoints are not yet ported.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

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


class CoordinateDescent:
    """Runs coordinates in their update sequence.

    ``coordinates`` is an ordered dict name -> coordinate with
    ``initial_coefficients()``, ``update(residual_offsets, init) -> (params,
    result)``, ``score(params) -> (N,)`` and ``regularization_term(params)``.
    ``training_loss(total_scores)`` gives the loss part of the objective;
    ``validation_scorer(params map) -> (Nv,)`` and ``validation_evaluators``
    (name -> (Evaluator, kwargs of its evaluate)) give the metrics recorded
    after every update.
    """

    def __init__(self, coordinates: Dict[str, object],
                 training_loss: Callable[[Tensor], Tensor],
                 validation_scorer: Optional[Callable[[Dict[str, Tensor]], Tensor]] = None,
                 validation_evaluators: Optional[Dict[str, Tuple[object, dict]]] = None):
        self.coordinates = coordinates
        self.training_loss = training_loss
        self.validation_scorer = validation_scorer
        self.validation_evaluators = validation_evaluators or {}

    def _objective(self, total: Tensor, params: Dict[str, Tensor]) -> Tensor:
        return self.training_loss(total) + sum(
            self.coordinates[n].regularization_term(params[n]) for n in self.coordinates
        )

    def run(self, num_iterations: int, num_rows: int,
            initial_params: Optional[Dict[str, Tensor]] = None) -> CoordinateDescentResult:
        """``initial_params`` warm-starts named coordinates; they contribute
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

        objective_dev: List[Tensor] = []
        validation_dev: List[Dict[str, Tensor]] = []
        timings = {n: 0.0 for n in names}
        timings["(validation)"] = 0.0
        trackers: Dict[str, object] = {}
        for _ in range(num_iterations):
            for name in names:
                coord = self.coordinates[name]
                partial = total - scores[name]  # the other coordinates' scores
                t0 = time.perf_counter()
                params[name], trackers[name] = coord.update(partial, params[name])
                scores[name] = coord.score(params[name])
                timings[name] += time.perf_counter() - t0
                total = partial + scores[name]
                objective_dev.append(self._objective(total, params))
                if self.validation_scorer is not None:
                    t0 = time.perf_counter()
                    v_scores = self.validation_scorer(params)
                    validation_dev.append({
                        key: ev.evaluate(v_scores, **kw)
                        for key, (ev, kw) in self.validation_evaluators.items()
                    })
                    timings["(validation)"] += time.perf_counter() - t0
        return CoordinateDescentResult(
            coefficients=params,
            total_scores=total,
            objective_history=[float(v) for v in objective_dev],
            validation_history=[{k: float(v) for k, v in m.items()} for m in validation_dev],
            timings=timings,
            trackers=trackers,
        )
