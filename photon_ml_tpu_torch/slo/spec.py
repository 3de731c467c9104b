"""Declared per-phase SLOs — the contract the day-in-the-life run is
gated on (port of photon_ml_tpu/slo/spec.py).

A :class:`PhaseSLO` declares, per lifecycle phase, the latency bounds,
the error budget (the fraction of requests that may error or drop), the
staleness budget (requests legitimately answered at generation N-1 after
a swap flipped — the pinned-at-submission stragglers), and — centrally —
which DEGRADATION KINDS the phase is allowed to exhibit at all. The
ledger (:mod:`photon_ml_tpu_torch.slo.ledger`) attributes every degradation to
one of :data:`DEGRADATION_KINDS`; a kind that shows up in a phase whose
SLO does not declare it is a violation even at count 1. That is the
"never silent" rule enforced in code: chaos-absorbed retries are fine in
a declared chaos window and a hard failure anywhere else.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Sequence, Tuple

__all__ = ["DEGRADATION_KINDS", "PhaseSLO", "SLOSpec"]

#: Every attribution category the ledger accepts: kind -> what it means.
#: Auto-attributed kinds map 1:1 onto FleetStats counters (see
#: ledger.FLEET_COUNTER_KINDS); the rest are driver-attributed lifecycle
#: events. A kind outside this table is a programming error, not data.
DEGRADATION_KINDS: Dict[str, str] = {
    "cold_entity_zero": (
        "a dead owner's random-effect contribution served as the "
        "cold-entity 0 (FleetStats.degraded_rows)"
    ),
    "hedged_fallback": (
        "a hedge fired for the replicated fixed half after the owner "
        "missed the hedge window (FleetStats.hedges)"
    ),
    "chaos_absorbed_retry": (
        "an injected or real transient fault absorbed by a retry "
        "(FleetStats.routed_retries; elastic/membership retry loops)"
    ),
    "rerouted_fixed": (
        "a row's replicated fixed half rerouted to another live replica "
        "— exact, but attributed (FleetStats.reroutes)"
    ),
    "stale_rescore": (
        "a request that raced a fleet swap re-scored wholesale at the "
        "current generation (FleetStats.stale_rescores)"
    ),
    "dead_replica_skip": (
        "a dispatch skipped a replica with a stale heartbeat or an open "
        "circuit breaker (FleetStats.dead_replica_skips)"
    ),
    "swap_abort_chaos": (
        "a fleet swap aborted at the generation barrier under injected "
        "chaos; the old generation kept serving"
    ),
    "rollout_abort_chaos": (
        "a delta rollout aborted at the rollout entry under injected "
        "chaos; the old generation kept serving"
    ),
    "mixed_dtype_refusal": (
        "a replica-by-replica dtype roll was refused by load_fleet_meta "
        "(MIXED-DTYPE fleet) — the migration must be fleet-wide atomic"
    ),
    "migration_compiles": (
        "a declared dtype migration recompiled the gather executables "
        "(a dtype change is a legitimate roll but never compile-free)"
    ),
    "replica_killed": (
        "an owner replica was killed (SIGKILL) and detected via the "
        "heartbeat deadline; traffic kept flowing degraded"
    ),
    "cold_block_rebuild": (
        "an elastic block transfer failed past retries and degraded to "
        "a recorded cold rebuild"
    ),
}


@dataclasses.dataclass(frozen=True)
class PhaseSLO:
    """One phase's declared service-level objectives."""

    name: str
    p50_ms: float
    p99_ms: float
    #: max fraction of requests that may error or drop (0.0 = none)
    error_budget: float = 0.0
    #: max requests answered at generation N-1 after the flip instant
    staleness_budget: int = 0
    #: degradation kinds this phase may exhibit (DEGRADATION_KINDS keys);
    #: any other kind occurring in the phase is a violation at count 1
    allowed_degradations: Tuple[str, ...] = ()
    #: True marks a DECLARED chaos window: dropped requests are charged
    #: to the error budget instead of failing outright
    chaos_window: bool = False

    def __post_init__(self):
        unknown = [
            k for k in self.allowed_degradations if k not in DEGRADATION_KINDS
        ]
        if unknown:
            raise ValueError(
                f"phase {self.name!r} allows unknown degradation kinds "
                f"{unknown} (known: {sorted(DEGRADATION_KINDS)})"
            )
        if self.p50_ms <= 0 or self.p99_ms < self.p50_ms:
            raise ValueError(
                f"phase {self.name!r} latency SLO must satisfy "
                f"0 < p50 <= p99, got p50={self.p50_ms} p99={self.p99_ms}"
            )
        if not 0.0 <= self.error_budget <= 1.0:
            raise ValueError(
                f"phase {self.name!r} error budget must be a fraction, "
                f"got {self.error_budget}"
            )
        if self.staleness_budget < 0:
            raise ValueError(
                f"phase {self.name!r} staleness budget must be >= 0"
            )

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, payload: dict) -> "PhaseSLO":
        return cls(
            name=str(payload["name"]),
            p50_ms=float(payload["p50_ms"]),
            p99_ms=float(payload["p99_ms"]),
            error_budget=float(payload.get("error_budget", 0.0)),
            staleness_budget=int(payload.get("staleness_budget", 0)),
            allowed_degradations=tuple(
                payload.get("allowed_degradations") or ()
            ),
            chaos_window=bool(payload.get("chaos_window", False)),
        )


class SLOSpec:
    """The ordered set of phase SLOs one day-in-the-life run declares."""

    def __init__(self, phases: Sequence[PhaseSLO]):
        self._phases: Dict[str, PhaseSLO] = {}
        for p in phases:
            if p.name in self._phases:
                raise ValueError(f"duplicate phase SLO {p.name!r}")
            self._phases[p.name] = p

    def phase(self, name: str) -> PhaseSLO:
        try:
            return self._phases[name]
        except KeyError:
            raise KeyError(
                f"phase {name!r} has no declared SLO "
                f"(declared: {self.names()})"
            ) from None

    def names(self) -> List[str]:
        return list(self._phases)

    def __contains__(self, name: str) -> bool:
        return name in self._phases

    def to_json(self) -> list:
        return [p.to_json() for p in self._phases.values()]

    @classmethod
    def from_json(cls, payload: Sequence[dict]) -> "SLOSpec":
        return cls([PhaseSLO.from_json(p) for p in payload])

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)

    @classmethod
    def load(cls, path: str) -> "SLOSpec":
        with open(path) as f:
            return cls.from_json(json.load(f))
