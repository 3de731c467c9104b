"""Coordinate descent over GAME coordinates (port of the per-update path of
photon_ml_tpu/algorithm/coordinate_descent.py).

Reference spec: algorithm/CoordinateDescent.scala:37-212 — for each
iteration and each coordinate: subtract the coordinate's own score from the
total, update it on those residuals, re-score, record the objective (the
training loss of the total scores plus every coordinate's regularization
term) and the validation metrics after the update. Scores are dense (N,)
tensors in global row order. A coordinate's parameters are a tensor, a
``FactoredState``, or (bucketed random effects) a tuple of per-bucket
stacks.

With a checkpointer the state is saved after every update and a restart
resumes from the last complete step (and inside an interrupted update,
when a scheduled coordinate drained at a chunk, rung or bucket boundary:
its progress rides the checkpoint as ``partial``); preemption is polled at every update
boundary (site ``"cycle"``), where the finished steps are made durable
before :class:`~photon_ml_tpu_torch.resilience.preemption.Preempted`
unwinds; a divergence guard gates every update. ``frozen`` coordinates
(the delta retrain's unchanged ones) carry their warm-started state forward
without solving.

``run_grid`` trains a lambda grid on coordinates built once: combo ``g``
runs the same cycle with every coordinate's total regularization weight
overridden (``reg_weight``), from the same seeded state; it checkpoints per
cycle in the JAX grid's lane layout. The fused cycle is not yet ported.
"""

from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from photon_ml_tpu_torch.checkpoint import CheckpointState
from photon_ml_tpu_torch.device import resolve_device
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

    def _objective(self, total: Tensor, params: Dict[str, Tensor],
                   lam: Optional[Dict[str, float]] = None) -> Tensor:
        return self.training_loss(total) + sum(
            self.coordinates[n].regularization_term(params[n]) if lam is None
            else self.coordinates[n].regularization_term(params[n], lam[n])
            for n in self.coordinates
        )

    def _validation_metrics(self, params) -> Dict[str, Tensor]:
        v_scores = self.validation_scorer(params)
        return {key: ev.evaluate(v_scores, **kw)
                for key, (ev, kw) in self.validation_evaluators.items()}

    def _seeded_state(self, num_rows: int, initial_params=None):
        """(params, scores, total) at step zero: ``initial_params`` warm-starts
        named coordinates, which contribute their scores from the start."""
        names = list(self.coordinates)
        params = {
            n: (initial_params[n] if initial_params is not None and n in initial_params
                else self.coordinates[n].initial_coefficients())
            for n in names
        }
        # the first tensor leaf; when every state is a handle (streaming
        # coordinates), the device the first coordinate solves on
        device = next((t.device for v in params.values() for t in _leaves(v)
                       if isinstance(t, Tensor)), None)
        if device is None:
            device = resolve_device(getattr(next(iter(self.coordinates.values())), "device", None))
        zeros = lambda: torch.zeros((num_rows,), dtype=real_dtype(), device=device)
        scores = {n: zeros() for n in names}
        if initial_params is not None:
            for n in names:
                if n in initial_params:
                    scores[n] = self.coordinates[n].score(params[n])
        total = zeros()
        for n in names:
            total = total + scores[n]
        return params, scores, total

    def _step(self, name: str, step: int, params: Dict[str, Tensor],
              scores: Dict[str, Tensor], total: Tensor, history: "_History",
              timings: Dict[str, float], trackers: Dict[str, object],
              lam: Optional[Dict[str, float]] = None,
              skip: bool = False, resume: Optional[dict] = None) -> Tuple[Tensor, bool]:
        """One update of coordinate ``name``, in place on ``params`` and
        ``scores``: solve on the other coordinates' scores (at ``lam[name]``
        when given), re-score, gate through the divergence guard, then record
        the objective and the validation metrics. ``skip`` records them on
        the unchanged state. ``resume`` hands the coordinate the paused
        progress of an update a preemption interrupted. Returns (total
        scores, whether the guard kept the update)."""
        ok = True
        if not skip:
            coord = self.coordinates[name]
            partial = total - scores[name]  # the other coordinates' scores
            t0 = time.perf_counter()
            kw = {} if lam is None else {"reg_weight": lam[name]}
            if resume is not None:
                kw["resume"] = resume
            new_params, trackers[name] = coord.update(partial, params[name], **kw)
            # chaos hook: a kind="nan" fault here corrupts the update
            # exactly like a diverged solve
            new_params = faults.corrupt("optim.step", new_params, coordinate=name, step=step)
            new_score = coord.score(new_params)
            guard = self.divergence_guard
            if guard is not None:
                new_params, new_score, ok = guard.filter_update(
                    name, step, new_params, new_score, params[name], scores[name])
            timings[name] += time.perf_counter() - t0
            params[name] = new_params
            scores[name] = new_score
            total = partial + new_score
        history.objective_dev.append(self._objective(total, params, lam))
        if self.validation_scorer is not None:
            t0 = time.perf_counter()
            history.validation_dev.append(self._validation_metrics(params))
            timings["(validation)"] += time.perf_counter() - t0
        return total, ok

    def run_grid(self, reg_weights: Dict[str, Sequence[float]], num_iterations: int,
                 num_rows: int, init_params: Optional[Dict[str, Tensor]] = None,
                 checkpointers: Optional[List[Optional[object]]] = None,
                 ) -> List[CoordinateDescentResult]:
        """Train a lambda grid on these coordinates, built once (the
        reference re-runs its driver per combo, Driver.scala:330-337).

        ``reg_weights`` maps every coordinate to its G total regularization
        weights: combo ``g`` updates coordinate ``n`` at
        ``reg_weights[n][g]``, which every coordinate must accept as
        ``reg_weight`` in ``update`` and ``regularization_term``. Combos run
        one after another, each from the same seeded state
        (``init_params`` warm-starts every combo). A combo's updates are
        ``run``'s (``_step``), so at equal weights it gives ``run``'s bits.
        The grid takes no divergence guard.

        ``checkpointers`` (one per combo, or None) save each combo at every
        iteration boundary, with the JAX grid's leading lane axis ``(1, ...)``
        on every leaf; a restart resumes the combo from its last complete
        iteration. Iteration boundaries are the preemption drain points
        (site ``"cycle"``). Each result's ``timings`` is ``{"(grid)": s}``.
        """
        names = list(self.coordinates)
        if self.divergence_guard is not None:
            raise ValueError("run_grid takes no divergence guard: run each combo with run()")
        for name in names:
            coord = self.coordinates[name]
            for method in (coord.update, coord.regularization_term):
                if "reg_weight" not in inspect.signature(method).parameters:
                    raise ValueError(
                        f"coordinate {name!r} ({type(coord).__name__}).{method.__name__} "
                        "does not accept a reg_weight: the lambda grid needs plain "
                        "fixed/random-effect coordinates"
                    )
        if set(reg_weights) != set(names):
            raise ValueError(f"reg_weights keys {sorted(reg_weights)} != coordinates "
                             f"{sorted(names)}")
        lam = {n: [float(x) for x in reg_weights[n]] for n in names}
        sizes = {n: len(lam[n]) for n in names}
        g = sizes[names[0]]
        if any(size != g for size in sizes.values()):
            raise ValueError(f"all reg-weight vectors must have one length, got {sizes}")
        if checkpointers is not None and len(checkpointers) != g:
            raise ValueError(f"checkpointers must match the grid ({g} combos), "
                             f"got {len(checkpointers)}")
        params0, scores0, total0 = self._seeded_state(num_rows, init_params)
        lanes = lambda tree: {n: _map_leaves(lambda t: t.unsqueeze(0), v)
                              for n, v in tree.items()}
        n_coords = len(names)
        out = []
        for i in range(g):
            lam_i = {n: lam[n][i] for n in names}
            ck = checkpointers[i] if checkpointers is not None else None
            params, scores, total = dict(params0), dict(scores0), total0
            history = _History()
            start_iter = 0
            if ck is not None:
                restored = ck.restore(lanes(params0), lanes(scores0), total0.unsqueeze(0))
                if restored is not None:
                    # grid steps land only at iteration boundaries
                    start_iter = restored.step // n_coords
                    params = {n: _map_leaves(lambda t: t[0], v)
                              for n, v in restored.params.items()}
                    scores = {n: t[0] for n, t in restored.scores.items()}
                    total = restored.total_scores[0]
                    history = _History(restored.objective_history,
                                       restored.validation_history)
            timings = {n: 0.0 for n in names}
            timings["(validation)"] = 0.0
            t0 = time.perf_counter()
            for it in range(start_iter, num_iterations):
                for k, name in enumerate(names):
                    total, _ = self._step(name, it * n_coords + k + 1, params, scores, total,
                                          history, timings, {}, lam_i)
                step = (it + 1) * n_coords
                if ck is not None:
                    history.drain()
                    ck.save(CheckpointState(
                        step=step, params=lanes(params), scores=lanes(scores),
                        total_scores=total.unsqueeze(0), objective_history=history.objective,
                        validation_history=history.validation,
                    ))
                if it < num_iterations - 1 and preemption.check("cycle", step=step, combo=i):
                    if ck is not None:
                        ck.wait()  # an async commit is durable before exit
                    raise preemption.Preempted(
                        f"preempted at grid iteration boundary (combo {i}, step {step}): "
                        f"{preemption.reason()}", site="cycle",
                    )
            history.drain()
            out.append(CoordinateDescentResult(
                coefficients=params,
                total_scores=total,
                objective_history=history.objective,
                validation_history=history.validation,
                timings={"(grid)": time.perf_counter() - t0},
            ))
        return out

    def run(self, num_iterations: int, num_rows: int, checkpointer=None,
            initial_params: Optional[Dict[str, Tensor]] = None,
            frozen: Optional[set] = None) -> CoordinateDescentResult:
        """``checkpointer`` (``checkpoint.CoordinateDescentCheckpointer`` or
        its async wrapper) saves after every update and resumes from the
        last complete step, which takes precedence over ``initial_params``.
        ``initial_params`` warm-starts named coordinates; they contribute
        their scores from step zero.

        ``frozen`` (the delta-retrain skip, retrain/) names coordinates whose
        data and configuration are unchanged since the prior run: they carry
        their ``initial_params`` and step-zero scores forward bitwise and
        never solve, while the objective still counts their terms and the
        histories and checkpoints stay one entry per update. Every frozen
        name must be warm-started (freezing an unseeded coordinate would
        freeze zeros)."""
        names = list(self.coordinates)
        frozen = frozenset(frozen or ())
        if frozen:
            unknown = frozen - set(names)
            if unknown:
                raise ValueError(f"frozen coordinates {sorted(unknown)} are "
                                 "not in the updating sequence")
            unseeded = [n for n in frozen if initial_params is None or n not in initial_params]
            if unseeded:
                raise ValueError(
                    f"frozen coordinates {sorted(unseeded)} have no "
                    "initial_params — freezing needs the prior coefficients"
                )
        params, scores, total = self._seeded_state(num_rows, initial_params)
        history = _History()
        timings = {n: 0.0 for n in names}
        timings["(validation)"] = 0.0
        trackers: Dict[str, object] = {}

        start_step = 0
        midstep = None  # an interrupted update's progress, from the checkpoint
        if checkpointer is not None:
            restored = checkpointer.restore(params, scores, total)
            if restored is not None:
                start_step = restored.step
                params, scores, total = restored.params, restored.scores, restored.total_scores
                history = _History(restored.objective_history, restored.validation_history)
                midstep = restored.partial

        guard = self.divergence_guard
        guard_events_start = len(guard.events) if guard is not None else 0
        step = 0
        for it in range(num_iterations):
            skip_rest_of_cycle = False
            for name in names:
                step += 1
                if step <= start_step:
                    continue  # completed before the restart
                resume = None
                if midstep is not None and step == int(midstep["meta"].get("resume_step", -1)):
                    # the emergency checkpoint interrupted this update: the
                    # coordinate finishes it from its paused progress
                    if midstep["meta"].get("coordinate") != name:
                        raise ValueError(
                            f"checkpoint partial targets coordinate "
                            f"{midstep['meta'].get('coordinate')!r} at step {step} but the "
                            f"sequence reaches {name!r} — updating sequence changed; "
                            "refusing to resume")
                    resume, midstep = midstep, None
                # a skipped update (the guard abandoned the cycle, or the
                # coordinate is frozen) leaves the state unchanged, but
                # histories and checkpoints stay one entry per update
                try:
                    total, ok = self._step(name, step, params, scores, total, history,
                                           timings, trackers,
                                           skip=skip_rest_of_cycle or name in frozen,
                                           resume=resume)
                except preemption.Preempted as e:
                    # a drain inside the update: checkpoint the finished
                    # steps with the coordinate's progress, then unwind
                    if e.partial is not None and checkpointer is not None:
                        payload = dict(e.partial)
                        payload["meta"] = dict(payload.get("meta") or {}, coordinate=name,
                                               resume_step=step)
                        history.drain()
                        e.checkpoint_path = checkpointer.save(CheckpointState(
                            step=step - 1, params=params, scores=scores, total_scores=total,
                            objective_history=history.objective,
                            validation_history=history.validation, partial=payload,
                        ))
                        checkpointer.wait()  # durable before the process exits
                    raise
                if not ok and guard.mode == "skip_cycle":
                    skip_rest_of_cycle = True
                path = None
                if checkpointer is not None:
                    history.drain()
                    path = checkpointer.save(CheckpointState(
                        step=step, params=params, scores=scores, total_scores=total,
                        objective_history=history.objective,
                        validation_history=history.validation,
                    ))
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
        history.drain()
        return CoordinateDescentResult(
            coefficients=params,
            total_scores=total,
            objective_history=history.objective,
            validation_history=history.validation,
            timings=timings,
            trackers=trackers,
            guard_events=list(guard.events[guard_events_start:]) if guard is not None else [],
        )


def _leaves(value) -> List[Tensor]:
    """A coordinate's parameters as a list of tensors: a tensor, the
    per-bucket tuple of a bucketed coordinate, or a ``FactoredState``."""
    if hasattr(value, "tree_flatten"):
        return list(value.tree_flatten()[0])
    return list(value) if isinstance(value, tuple) else [value]


def _map_leaves(fn, value):
    """``fn`` applied to a tensor, or to each stack of a bucketed tuple."""
    return tuple(fn(t) for t in value) if isinstance(value, tuple) else fn(value)


@dataclasses.dataclass
class _History:
    """Objective and validation histories: device scalars wait in the
    ``*_dev`` lists until a save or the end of the run drains them."""

    objective: List[float] = dataclasses.field(default_factory=list)
    validation: List[Dict[str, float]] = dataclasses.field(default_factory=list)
    objective_dev: List[Tensor] = dataclasses.field(default_factory=list)
    validation_dev: List[Dict[str, Tensor]] = dataclasses.field(default_factory=list)

    def drain(self) -> None:
        self.objective.extend(float(v) for v in self.objective_dev)
        self.validation.extend({k: float(v) for k, v in m.items()}
                               for m in self.validation_dev)
        self.objective_dev.clear()
        self.validation_dev.clear()
