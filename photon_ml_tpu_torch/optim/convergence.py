"""Gap-guided adaptive solve scheduling: the block-level convergence layer
(port of photon_ml_tpu/optim/convergence.py).

The compaction scheduler (optim/scheduler.py) attacks lane-level
convergence skew inside one solve. This module is the level above it: a
block (a bucket of the bucketed coordinate) whose convergence score says
it is done need not be visited again.

  1. :class:`ConvergenceLedger`: per-block scores (the largest per-lane
     final gradient norm of the block's last solve) with visit, skip and
     cost accounting, keyed by block id; the driver writes the best combo's
     into ``retrain.json`` (its JSON is the JAX package's).
  2. :class:`AdaptiveSchedule`: the opt-in policy (``--adaptive-schedule``
     / ``PHOTON_ADAPTIVE_SCHEDULE``): skip a block once its score has been
     under ``tolerance`` for ``patience`` consecutive epochs.
     ``tolerance=0`` never skips, so it changes no block's arithmetic.

Skips are never silent: each is a recorded ``PlanDecision``, and the
``optim.block_skip`` fault site guards the decision (an injected fault
degrades that epoch to visit-everything). Standard library only.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, Iterable, List, Optional

__all__ = [
    "AdaptiveSchedule",
    "ConvergenceLedger",
    "resolve_adaptive",
    "LEDGER_FILENAME",
]

_ADAPTIVE_ENV = "PHOTON_ADAPTIVE_SCHEDULE"
DEFAULT_TOLERANCE = 1e-5
DEFAULT_PATIENCE = 2

#: The ledger sidecar written next to a streaming manifest (or, when the
#: manifest is cache-resident and immutable, under the run's state root).
LEDGER_FILENAME = "convergence-ledger.json"


@dataclasses.dataclass(frozen=True)
class AdaptiveSchedule:
    """Static adaptive-visitation policy for one coordinate's epochs.

    ``tolerance`` — a block whose convergence score (max per-lane final
    gradient norm) stays strictly below it is a skip candidate;
    ``tolerance=0`` never skips (no score is < 0) but still orders
    visitation by descending score — the arithmetic-neutral mode.

    ``patience`` — consecutive under-tolerance epochs required before the
    first skip: one lucky epoch must not freeze a block another
    coordinate's residual shift could reheat next epoch.
    """

    tolerance: float = DEFAULT_TOLERANCE
    patience: int = DEFAULT_PATIENCE

    def __post_init__(self):
        if not (self.tolerance >= 0.0 and math.isfinite(self.tolerance)):
            raise ValueError(
                f"adaptive-schedule tolerance must be finite and >= 0, "
                f"got {self.tolerance}"
            )
        if self.patience < 1:
            raise ValueError(
                f"adaptive-schedule patience must be >= 1, got {self.patience}"
            )

    def describe(self) -> str:
        return f"adaptive(tol={self.tolerance:g}, patience={self.patience})"


def resolve_adaptive(
    spec: "Optional[AdaptiveSchedule | str | bool | float]" = None,
) -> Optional[AdaptiveSchedule]:
    """Effective adaptive schedule: an explicit value wins; ``None`` falls
    back to ``PHOTON_ADAPTIVE_SCHEDULE``. Returns None when off (default).

    Accepted spellings (driver flag and env var share them):
    ``off``/``false``/``0``/``none`` -> None; ``on``/``true`` -> default
    tolerance + patience; ``TOL`` (a float) -> that tolerance;
    ``TOL:K`` -> tolerance TOL with patience K.
    """
    if isinstance(spec, AdaptiveSchedule):
        return spec
    if spec is None:
        raw = os.environ.get(_ADAPTIVE_ENV)
        if raw is None:
            return None
        return resolve_adaptive(raw)
    if isinstance(spec, bool):
        return AdaptiveSchedule() if spec else None
    if isinstance(spec, (int, float)):
        return AdaptiveSchedule(tolerance=float(spec)) if spec > 0 else None
    text = str(spec).strip().lower()
    if text in ("", "off", "false", "none", "0"):
        return None
    # NOTE: an explicit "0.0" (or "0:K") still parses below to the
    # tolerance-0 ORDERING-ONLY mode — descending-score visitation with no
    # skips, the arithmetic-neutral pin the bitwise tests use
    if text in ("on", "true", "default"):
        return AdaptiveSchedule()
    tol_text, sep, pat_text = text.partition(":")
    try:
        tol = float(tol_text)
        patience = int(pat_text) if sep else DEFAULT_PATIENCE
        return AdaptiveSchedule(tolerance=tol, patience=patience)
    except ValueError as e:
        raise ValueError(
            f"bad adaptive-schedule spec {spec!r} (want off | on | TOL | "
            f"TOL:PATIENCE, e.g. 1e-5:2): {e}"
        ) from e


def _fresh_entry() -> dict:
    return {
        "score": None,  # last observed max per-lane gradient norm
        "visits": 0,  # epochs this block was actually solved
        "skips": 0,  # epochs the adaptive policy skipped it
        "streak": 0,  # consecutive under-tolerance epochs (incl. skips)
        "last_epoch": 0,  # epoch of the most recent observe/skip
        "executed": 0,  # cumulative lane-iterations across visits
    }


class ConvergenceLedger:
    """Per-block convergence scores + visit/skip/cost accounting, keyed by
    block id (a bucket's index). Bounded by the block count, never by run
    length. Purely host-side bookkeeping: recording never touches the
    solve's arithmetic, which is why the always-on telemetry mode is
    bitwise-safe.
    """

    def __init__(self, entries: Optional[Dict[int, dict]] = None):
        self._entries: Dict[int, dict] = {
            int(g): dict(e) for g, e in (entries or {}).items()
        }

    # -- recording ----------------------------------------------------------
    def observe(
        self,
        gid: int,
        score: float,
        *,
        executed: int = 0,
        epoch: int = 0,
        under_tolerance: bool = False,
    ) -> None:
        """Record one solved visit: the block's fresh convergence score,
        the lane-iterations it burned, and whether the score was under the
        active tolerance (feeds the skip streak; False when no adaptive
        policy is active — a later opt-in run starts streaks cold, which
        only delays skipping, never skips wrongly)."""
        e = self._entries.setdefault(int(gid), _fresh_entry())
        e["score"] = float(score)
        e["visits"] += 1
        e["streak"] = e["streak"] + 1 if under_tolerance else 0
        e["last_epoch"] = int(epoch)
        e["executed"] += int(executed)

    def record_skip(self, gid: int, *, epoch: int = 0) -> None:
        """Record one adaptive skip: the block's coefficients (and hence
        its score) are unchanged, the streak extends."""
        e = self._entries.setdefault(int(gid), _fresh_entry())
        e["skips"] += 1
        e["streak"] += 1
        e["last_epoch"] = int(epoch)

    # -- the policy queries -------------------------------------------------
    def order(self, gids: Iterable[int]) -> List[int]:
        """The given block ids in descending-score order (spend iterations
        where convergence lives). Never-observed blocks have unknown gaps
        and go FIRST; ties break on ascending id so the order is total and
        deterministic."""
        def key(g: int):
            e = self._entries.get(int(g))
            s = e["score"] if e is not None and e["score"] is not None else None
            return (0 if s is None else 1, -(s if s is not None else 0.0), int(g))

        return sorted((int(g) for g in gids), key=key)

    def should_skip(self, gid: int, schedule: AdaptiveSchedule) -> bool:
        """Whether the policy says to skip this block: its score has been
        under tolerance for at least ``patience`` consecutive epochs."""
        if schedule.tolerance <= 0.0:
            return False
        e = self._entries.get(int(gid))
        if e is None or e["score"] is None:
            return False
        return e["score"] < schedule.tolerance and e["streak"] >= schedule.patience

    # -- views --------------------------------------------------------------
    def entry(self, gid: int) -> Optional[dict]:
        e = self._entries.get(int(gid))
        return dict(e) if e is not None else None

    def __len__(self) -> int:
        return len(self._entries)

    def gids(self) -> List[int]:
        return sorted(self._entries)

    def observed_costs(self) -> Dict[int, float]:
        """Per-block average lane-iterations per visit: the planner's
        blocking-drift signal. Blocks never visited report no cost."""
        out: Dict[int, float] = {}
        for g, e in self._entries.items():
            if e["visits"] > 0 and e["executed"] > 0:
                out[int(g)] = e["executed"] / e["visits"]
        return out

    def merge(self, other: Dict[int, dict]) -> None:
        """Fold another rank's entries in (the elastic re-base,
        parallel/elastic.py). Ownership makes entries disjoint; on a
        conflict the more recent entry wins (``last_epoch``, then
        ``visits``, then the earlier source in the caller's order), so every
        rank computes the same merged ledger."""
        for g, e in sorted((int(g), e) for g, e in other.items()):
            mine = self._entries.get(g)
            if mine is None or ((e.get("last_epoch", 0), e.get("visits", 0))
                                > (mine["last_epoch"], mine["visits"])):
                fresh = _fresh_entry()
                fresh.update(e)
                self._entries[g] = fresh

    # -- persistence (atomic sidecar + retrain.json embedding) --------------
    def to_json(self) -> Dict[str, dict]:
        return {str(g): dict(e) for g, e in sorted(self._entries.items())}

    @classmethod
    def from_json(cls, payload: Optional[Dict[str, dict]]) -> "ConvergenceLedger":
        return cls({int(g): e for g, e in (payload or {}).items()})

    def save(self, dir_path: str) -> str:
        """Atomic sidecar write (tmp + rename, the plan-sidecar
        discipline): a crash mid-write leaves the previous ledger, never a
        torn one."""
        os.makedirs(dir_path, exist_ok=True)
        path = os.path.join(dir_path, LEDGER_FILENAME)
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"format": 1, "blocks": self.to_json()}, f, indent=1,
                      sort_keys=True)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, dir_path: str) -> Optional["ConvergenceLedger"]:
        """The ledger persisted in ``dir_path``, or None (no sidecar / an
        unreadable one degrades to starting cold — skipping is an
        optimization, never load-bearing state)."""
        path = os.path.join(dir_path, LEDGER_FILENAME)
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        if payload.get("format") != 1:
            return None
        return cls.from_json(payload.get("blocks"))
