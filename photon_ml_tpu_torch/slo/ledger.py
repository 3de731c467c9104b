"""Phase-attributed SLO ledger — the measured half of the day-in-the-life
harness (port of photon_ml_tpu/slo/ledger.py).

One :class:`SLOLedger` accompanies a run through its lifecycle phases
(morning ramp, chaos peak, retrain window, elasticity event, dtype
migration, night drain). Per phase it accumulates request latencies into
a bounded-memory streaming digest (:mod:`photon_ml_tpu_torch.slo.quantiles`),
error/drop counts against the declared error budget, post-flip staleness,
bytes moved, and — the core discipline — ATTRIBUTED degradations: every
cold-entity zero, hedged fallback, and chaos-absorbed retry lands in a
named bucket, and :meth:`enforce` fails the run loudly if any phase
violates its declared SLO or exhibits a degradation kind its SLO never
declared. "Never silent" is structural, not prose: the FleetStats
degradation counters are snapshotted at ``begin_phase`` and their deltas
auto-attributed at ``end_phase``, so a counter that moved without a
declaration CANNOT escape the gate.

The finalized ledger is JSON (:data:`SLO_LEDGER_FILE` sidecar) — the
shared on-disk contract ``tools/fleetctl.py status --slo`` aggregates
fleet-wide.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from photon_ml_tpu_torch.slo.quantiles import StreamingQuantileDigest
from photon_ml_tpu_torch.slo.spec import DEGRADATION_KINDS, PhaseSLO, SLOSpec

__all__ = [
    "SLO_LEDGER_FILE",
    "SLO_LEDGER_FORMAT",
    "FLEET_COUNTER_KINDS",
    "SLOViolation",
    "SLOLedger",
]

#: sidecar filename the ledger writes and fleetctl reads
SLO_LEDGER_FILE = "slo-ledger.json"
SLO_LEDGER_FORMAT = 1

#: FleetStats counter -> attribution kind: the auto-attribution map that
#: makes router-level degradations impossible to under-report. Counter
#: names are the snapshot() keys of serve/stats.FleetStats.
FLEET_COUNTER_KINDS: Dict[str, str] = {
    "degraded_rows": "cold_entity_zero",
    "hedges": "hedged_fallback",
    "routed_retries": "chaos_absorbed_retry",
    "reroutes": "rerouted_fixed",
    "stale_rescores": "stale_rescore",
    "dead_replica_skips": "dead_replica_skip",
}


class SLOViolation(AssertionError):
    """At least one phase violated its declared SLO; the message lists
    every violation (phase, rule, observed vs declared)."""


class _Phase:
    def __init__(self, slo: PhaseSLO, exact_limit: int):
        self.slo = slo
        self.digest = StreamingQuantileDigest((0.50, 0.99), exact_limit)
        self.requests = 0
        self.rows = 0
        self.errors = 0
        self.drops = 0
        self.stale_answers = 0
        self.mixed_generation = 0
        self.divergent = 0
        self.bytes_moved = 0
        self.degradations: Dict[str, int] = {}
        self.details: List[str] = []
        self.flip_generation: Optional[int] = None
        self.started: float = 0.0
        self.duration_s: float = 0.0
        self.stats_baseline: Optional[Dict[str, float]] = None


class SLOLedger:
    """Thread-safe phase accumulator (traffic threads record while the
    lifecycle driver flips phases)."""

    def __init__(self, spec: SLOSpec, exact_limit: int = 8192):
        self.spec = spec
        self.exact_limit = int(exact_limit)
        self._lock = threading.Lock()
        self._phases: List[_Phase] = []
        self._current: Optional[_Phase] = None
        self._stats = None

    # -- phase lifecycle -----------------------------------------------------
    def begin_phase(self, name: str, stats=None) -> None:
        """Enter phase ``name`` (must have a declared SLO). ``stats`` is
        an optional FleetStats/ServeStats whose degradation counters are
        snapshotted now and delta-attributed at :meth:`end_phase`."""
        with self._lock:
            if self._current is not None:
                raise RuntimeError(
                    f"phase {self._current.slo.name!r} is still open — "
                    "end_phase() first"
                )
            ph = _Phase(self.spec.phase(name), self.exact_limit)
            ph.started = time.monotonic()
            self._stats = stats
            if stats is not None:
                snap = stats.snapshot()
                ph.stats_baseline = {
                    k: float(snap.get(k, 0) or 0) for k in FLEET_COUNTER_KINDS
                }
            self._current = ph

    def end_phase(self) -> dict:
        """Close the open phase: auto-attribute the FleetStats counter
        deltas, stamp the duration, and return the phase record."""
        with self._lock:
            ph = self._require_phase()
            ph.duration_s = time.monotonic() - ph.started
            if self._stats is not None and ph.stats_baseline is not None:
                snap = self._stats.snapshot()
                for counter, kind in FLEET_COUNTER_KINDS.items():
                    delta = int(
                        float(snap.get(counter, 0) or 0)
                        - ph.stats_baseline[counter]
                    )
                    if delta > 0:
                        ph.degradations[kind] = (
                            ph.degradations.get(kind, 0) + delta
                        )
            self._phases.append(ph)
            self._current = None
            self._stats = None
            return self._phase_record(ph)

    def _require_phase(self) -> _Phase:
        if self._current is None:
            raise RuntimeError("no phase open (begin_phase first)")
        return self._current

    @property
    def current_phase(self) -> Optional[str]:
        with self._lock:
            return None if self._current is None else self._current.slo.name

    # -- recording -----------------------------------------------------------
    def record_request(self, latency_s: float, num_rows: int = 1) -> None:
        with self._lock:
            ph = self._require_phase()
            ph.digest.add(latency_s)
            ph.requests += 1
            ph.rows += int(num_rows)

    def record_error(self, n: int = 1) -> None:
        with self._lock:
            self._require_phase().errors += int(n)

    def record_drop(self, n: int = 1) -> None:
        with self._lock:
            self._require_phase().drops += int(n)

    def record_stale_answer(self, n: int = 1) -> None:
        """A request answered at generation N-1 AFTER the flip instant —
        the legitimate pinned-at-submission stragglers, counted against
        the phase's staleness budget."""
        with self._lock:
            self._require_phase().stale_answers += int(n)

    def record_mixed_generation(self, n: int = 1) -> None:
        """A score matching NEITHER adjacent generation's oracle — always
        a violation (the pinning contract forbids it at any count)."""
        with self._lock:
            self._require_phase().mixed_generation += int(n)

    def record_divergence(self, n: int = 1) -> None:
        """A steady-state score that failed the bitwise-vs-oracle gate —
        always a violation."""
        with self._lock:
            self._require_phase().divergent += int(n)

    def record_bytes_moved(self, n: int) -> None:
        with self._lock:
            self._require_phase().bytes_moved += int(n)

    def mark_flip(self, generation: int) -> None:
        """The swap barrier flipped to ``generation`` inside this phase
        (staleness accounting starts at this instant)."""
        with self._lock:
            self._require_phase().flip_generation = int(generation)

    def attribute(self, kind: str, n: int = 1, detail: str = "") -> None:
        """Driver-attributed degradation (lifecycle events the stats
        counters cannot see: swap aborts, dtype refusals, kills)."""
        if kind not in DEGRADATION_KINDS:
            raise ValueError(
                f"unknown degradation kind {kind!r} "
                f"(known: {sorted(DEGRADATION_KINDS)})"
            )
        with self._lock:
            ph = self._require_phase()
            ph.degradations[kind] = ph.degradations.get(kind, 0) + int(n)
            if detail:
                ph.details.append(f"{kind}: {detail}")

    # -- reading / the gate --------------------------------------------------
    def _phase_record(self, ph: _Phase) -> dict:
        slo = ph.slo
        denom = max(ph.requests, 1)
        spend = (ph.errors + ph.drops) / denom
        record = {
            "name": slo.name,
            "duration_s": round(ph.duration_s, 3),
            "requests": ph.requests,
            "rows": ph.rows,
            "qps": (
                round(ph.requests / ph.duration_s, 1)
                if ph.duration_s > 0
                else 0.0
            ),
            "p50_ms": round(ph.digest.quantile(0.50) * 1e3, 3),
            "p99_ms": round(ph.digest.quantile(0.99) * 1e3, 3),
            "errors": ph.errors,
            "drops": ph.drops,
            "error_budget": {
                "budget": slo.error_budget,
                "spend": round(spend, 6),
                "used": (
                    round(spend / slo.error_budget, 4)
                    if slo.error_budget > 0
                    else (0.0 if spend == 0 else float("inf"))
                ),
            },
            "stale_answers": ph.stale_answers,
            "mixed_generation": ph.mixed_generation,
            "divergent": ph.divergent,
            "bytes_moved": ph.bytes_moved,
            "degradations": dict(sorted(ph.degradations.items())),
            "degradation_details": list(ph.details),
            "flip_generation": ph.flip_generation,
            "chaos_window": slo.chaos_window,
            "slo": slo.to_json(),
        }
        record["violations"] = self._violations(record, slo)
        return record

    @staticmethod
    def _violations(record: dict, slo: PhaseSLO) -> List[str]:
        v: List[str] = []
        if record["requests"] and record["p50_ms"] > slo.p50_ms:
            v.append(
                f"p50 {record['p50_ms']}ms > declared {slo.p50_ms}ms"
            )
        if record["requests"] and record["p99_ms"] > slo.p99_ms:
            v.append(
                f"p99 {record['p99_ms']}ms > declared {slo.p99_ms}ms"
            )
        spend = record["error_budget"]["spend"]
        if spend > slo.error_budget:
            v.append(
                f"error-budget spend {spend:.4%} > budget "
                f"{slo.error_budget:.4%} "
                f"({record['errors']} errors, {record['drops']} drops)"
            )
        if record["drops"] and not slo.chaos_window:
            v.append(
                f"{record['drops']} dropped requests outside a declared "
                "chaos window"
            )
        if record["stale_answers"] > slo.staleness_budget:
            v.append(
                f"{record['stale_answers']} generation-(N-1) answers "
                f"after the flip > staleness budget {slo.staleness_budget}"
            )
        if record["mixed_generation"]:
            v.append(
                f"{record['mixed_generation']} mixed-generation scores "
                "(the pinning contract forbids ANY)"
            )
        if record["divergent"]:
            v.append(
                f"{record['divergent']} scores diverged from the "
                "bitwise oracle"
            )
        for kind, count in record["degradations"].items():
            if count and kind not in slo.allowed_degradations:
                v.append(
                    f"undeclared degradation: {count} x {kind!r} "
                    "(not in this phase's allowed_degradations)"
                )
        return v

    def finalize(self) -> dict:
        """The full ledger payload (format-tagged, fleetctl-aggregable)."""
        with self._lock:
            if self._current is not None:
                raise RuntimeError(
                    f"phase {self._current.slo.name!r} is still open"
                )
            phases = [self._phase_record(ph) for ph in self._phases]
        violations = sum(len(p["violations"]) for p in phases)
        return {
            "format": SLO_LEDGER_FORMAT,
            "spec": self.spec.to_json(),
            "phases": phases,
            "totals": {
                "requests": sum(p["requests"] for p in phases),
                "errors": sum(p["errors"] for p in phases),
                "drops": sum(p["drops"] for p in phases),
                "stale_answers": sum(p["stale_answers"] for p in phases),
                "mixed_generation": sum(
                    p["mixed_generation"] for p in phases
                ),
                "bytes_moved": sum(p["bytes_moved"] for p in phases),
                "degradations": _merge_counts(
                    p["degradations"] for p in phases
                ),
            },
            "violations_total": violations,
            "ok": violations == 0,
        }

    def enforce(self) -> dict:
        """THE hard gate: finalize and raise :class:`SLOViolation` listing
        every violation if any phase broke its declared SLO. Returns the
        (clean) payload otherwise."""
        payload = self.finalize()
        problems = [
            f"[{p['name']}] {msg}"
            for p in payload["phases"]
            for msg in p["violations"]
        ]
        if problems:
            raise SLOViolation(
                f"{len(problems)} SLO violation(s):\n  "
                + "\n  ".join(problems)
            )
        return payload

    def write(self, directory: str, payload: Optional[dict] = None) -> str:
        """Write the ledger sidecar (atomic) under ``directory``; returns
        the path. Never enforces — an over-budget ledger is still banked
        so fleetctl can show WHAT went over."""
        payload = payload if payload is not None else self.finalize()
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, SLO_LEDGER_FILE)
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)
        return path


def _merge_counts(dicts) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for d in dicts:
        for k, n in d.items():
            out[k] = out.get(k, 0) + int(n)
    return dict(sorted(out.items()))
