"""Divergence guards: non-finite detection + coordinate rollback (port of
photon_ml_tpu/resilience/guards.py).

The guard checks each coordinate update's parameters and scores for
non-finite values *before* they enter the shared score vectors, and either
rolls the coordinate back to its last good state (descent continues with the
other coordinates) or marks the rest of the cycle skipped. Outcomes are
recorded as :class:`GuardEvent` rows on
``CoordinateDescentResult.guard_events``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch

__all__ = ["GuardEvent", "DivergenceGuard", "tree_all_finite"]

MAX_GUARD_EVENTS = 8  # non-finite updates tolerated before the guard raises


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def tree_all_finite(tree: Any) -> bool:
    """True iff every floating tensor leaf of ``tree`` (a tensor, or
    dicts/lists/tuples of them) is fully finite. Waits for the device (one
    small scalar transfer per call)."""
    # a by-reference leaf (a streaming coordinate's spilled state) holds no
    # tensor here: its blocks are on disk
    flags = [torch.all(torch.isfinite(t)).reshape(1)
             for t in map(torch.as_tensor, (x for x in _leaves(tree)
                                            if not hasattr(x, "__checkpoint_ref__")))
             if t.is_floating_point()]
    if not flags:
        return True
    return bool(torch.cat([f.to(flags[0].device) for f in flags]).all())


@dataclasses.dataclass(frozen=True)
class GuardEvent:
    """One guarded incident during coordinate descent."""

    coordinate: str
    step: int  # global update counter (iteration * num_coordinates + index)
    action: str  # "rollback" | "skip_cycle"
    detail: str = ""


class DivergenceGuard:
    """Per-update non-finite gate for coordinate descent.

    ``mode="rollback"`` (default) keeps the coordinate's last good
    parameters and scores and lets descent continue; ``mode="skip_cycle"``
    additionally asks the caller to skip the remainder of the current cycle
    (useful when one divergence suggests the whole iteration is suspect).
    ``MAX_GUARD_EVENTS`` bounds how many incidents are tolerated before the
    guard raises — unbounded silent rollback could mask a systematically broken
    objective.
    """

    MODES = ("rollback", "skip_cycle")

    def __init__(self, mode: str = "rollback"):
        if mode not in self.MODES:
            raise ValueError(f"guard mode {mode!r} not in {self.MODES}")
        self.mode = mode
        self.events: List[GuardEvent] = []

    def filter_update(
        self,
        coordinate: str,
        step: int,
        new_params: Any,
        new_score: Any,
        prev_params: Any,
        prev_score: Any,
    ) -> Tuple[Any, Any, bool]:
        """Gate one coordinate update.

        Returns ``(params, score, ok)``: the proposed state when finite,
        else the previous (last good) state with ``ok=False`` and the event
        recorded. Raises :class:`FloatingPointError` when ``MAX_GUARD_EVENTS`` is
        exhausted.
        """
        # one combined check = one device scalar + one host transfer (the
        # per-update cost the CD docstring quotes); checking the two trees
        # separately would double the blocking round-trips
        if tree_all_finite((new_params, new_score)):
            return new_params, new_score, True
        action = "skip_cycle" if self.mode == "skip_cycle" else "rollback"
        event = GuardEvent(
            coordinate=coordinate,
            step=step,
            action=action,
            detail="non-finite parameters or scores; restored last good state",
        )
        self.events.append(event)
        if len(self.events) > MAX_GUARD_EVENTS:
            raise FloatingPointError(
                f"divergence guard exhausted: {len(self.events)} non-finite "
                f"coordinate updates (limit {MAX_GUARD_EVENTS}); last at "
                f"coordinate {coordinate!r} step {step}"
            )
        return prev_params, prev_score, False
