"""The planner's cost model (port of photon_ml_tpu/compile/cost.py, the
same module).

A GAME training run is a query over tensor statistics, and the knobs the
repo grew (ladder growth, solve-chunk size, sparse family, prefetch depth,
blocking, sharding) are access-path choices a planner makes from
statistics. This module holds static priors, corrected by an EMA over the
realized costs fed back after every run.

Cost unit: **lane-iterations** (solver iterations summed over entity
lanes), with traces and host chunk-pauses converted at fixed rates
(:data:`TRACE_COST`, :data:`CHUNK_PAUSE_COST`). The unit is a count, not a
time, so the constants and priors are the JAX package's values and, given
the same inputs, every decision equals the JAX package's.

Persistence: one ``cost-model.json`` sidecar beside ``retrain.json``
(atomic tmp+rename). A torn or missing sidecar degrades to the static
priors as a recorded :class:`~photon_ml_tpu_torch.compile.plan.PlanDecision`;
the sidecar is never load-bearing. Each package reads the other's.

Standard library only.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "CHUNK_PAUSE_COST",
    "COST_MODEL_FILENAME",
    "COST_MODEL_FORMAT",
    "DRIFT_THRESHOLD",
    "TRACE_COST",
    "CostModel",
    "WorkloadProfile",
]

COST_MODEL_FILENAME = "cost-model.json"
COST_MODEL_FORMAT = 1

#: Predicted-vs-realized relative error beyond which a decision is
#: flagged as drifted (the drift audit reads it).
DRIFT_THRESHOLD = 0.5

#: One trace, in lane-iteration units (the JAX package's value, where a
#: trace is an XLA trace and compile). In the port a trace is a CUDA-graph
#: capture, the count ``compile/stats.py`` keeps.
TRACE_COST = 50.0

#: One host re-entry at a compacted-chunk boundary, in lane-iteration
#: units (device sync + compaction gather + re-dispatch).
CHUNK_PAUSE_COST = 150.0

#: Prior iteration needs per lane when no realized data exists: hard
#: lanes (skewed tail) vs easy lanes (converged bulk); the JAX package's
#: values.
PRIOR_HARD_ITERS = 50.0
PRIOR_EASY_ITERS = 6.0

#: EMA weight for a new realized observation against the running value.
EMA_ALPHA = 0.5

#: Block-cost imbalance (max/mean) beyond which re-blocking is predicted
#: to beat another pinned day (the "blocking drift" question from the
#: delta-retrain loop, now a recorded decision).
REBLOCK_IMBALANCE = 1.5

_DRIFT_LOG_CAP = 200


@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    """The statistics a plan choice is conditioned on.

    ``signature()`` buckets workloads coarsely (skewed / uniform /
    unknown) — realized costs learned on one shape never leak onto the
    other, which is the whole point of matching execution structure to
    workload shape (Snap ML's hierarchy argument)."""

    num_lanes: int = 0
    max_rows: int = 0
    median_rows: int = 0
    dim: int = 0
    density: float = 1.0  # nnz fraction of the feature matrix (1 = dense)
    num_blocks: int = 0

    def skew(self) -> float:
        """Row-count skew: how much heavier the heaviest lane is than the
        median one (>= 1; 1 = perfectly uniform)."""
        if self.median_rows <= 0 or self.max_rows <= 0:
            return 1.0
        return self.max_rows / float(self.median_rows)

    def signature(self) -> str:
        if self.num_lanes <= 0:
            return "unknown"
        return "skewed" if self.skew() >= 4.0 else "uniform"


def _obs_key(policy: str, action: str, signature: str) -> str:
    return f"{policy}={action}@{signature}"


class CostModel:
    """Static priors + realized-cost feedback, per (policy, action,
    workload signature).

    ``observations`` maps :func:`_obs_key` to ``{"cost": ema, "n": count}``;
    ``drift_log`` keeps the last predicted-vs-realized pairs so operators
    can audit where the model is lying.
    """

    def __init__(
        self,
        observations: Optional[Dict[str, dict]] = None,
        drift_log: Optional[List[dict]] = None,
        source: str = "static-priors",
    ):
        self.observations: Dict[str, dict] = dict(observations or {})
        self.drift_log: List[dict] = list(drift_log or [])
        #: Where this model came from: "static-priors" or the sidecar path.
        self.source = source

    # -- priors -------------------------------------------------------------

    @staticmethod
    def _iters_needed(profile: WorkloadProfile) -> Tuple[float, float, float]:
        """(easy_iters, hard_iters, hard_fraction) prior for ``profile``."""
        sig = profile.signature()
        if sig == "uniform":
            # everyone needs roughly the same budget: no tail to chase
            mid = (PRIOR_HARD_ITERS + PRIOR_EASY_ITERS) / 2.0
            return mid, mid, 0.0
        # skewed (and unknown, conservatively): a thin hard tail
        lanes = max(profile.num_lanes, 1)
        hard_frac = min(8.0 / lanes, 0.5) if sig == "skewed" else 0.1
        return PRIOR_EASY_ITERS, PRIOR_HARD_ITERS, hard_frac

    def prior(self, policy: str, action: str, profile: WorkloadProfile) -> float:
        """Analytic prior cost (lane-iteration units) for taking
        ``action`` on ``profile``. Unknown actions get +inf so a typo can
        never win a plan."""
        lanes = max(profile.num_lanes, 1)
        easy, hard, hard_frac = self._iters_needed(profile)
        if policy == "schedule":
            if action == "one-shot":
                # the vmapped one-shot runs every lane to the slowest
                # lane's budget — skew is paid in full
                return lanes * hard
            if action.startswith("chunk:") or action.startswith("device:"):
                try:
                    c = max(int(action.split(":", 1)[1]), 1)
                except ValueError:
                    return float("inf")  # junk chunk spec can never win
                per_easy = math.ceil(easy / c) * c
                per_hard = math.ceil(hard / c) * c
                exec_cost = lanes * (
                    (1.0 - hard_frac) * per_easy + hard_frac * per_hard
                )
                # the pause tariff is POLICY-DEPENDENT: the host loop pays
                # one dispatch per chunk of the straggler tail; the fused
                # device loop (optim/fused_schedule.py) pays one per RUNG
                # HOP — bounded by the ladder depth, however long the tail
                pauses = math.ceil(hard / c)
                if action.startswith("device:"):
                    rung_hops = (
                        max(math.ceil(math.log2(max(lanes / 8.0, 1.0))), 0)
                        + 1
                    )
                    pauses = min(pauses, rung_hops)
                return exec_cost + CHUNK_PAUSE_COST * pauses
        elif policy == "ladder":
            # off: ~one trace per distinct lane shape; on: ~log rungs of
            # traces plus padded-lane overhead on the climb
            if action == "off":
                distinct = min(lanes, 32)
                return TRACE_COST * distinct
            if action == "on":
                span = max(profile.max_rows, 8)
                rungs = max(math.log2(span / 8.0), 0.0) + 1.0
                pad_overhead = 0.05 * lanes * easy
                return TRACE_COST * rungs + pad_overhead
        elif policy == "sparse":
            if action == "dense":
                return lanes * easy * max(profile.density, 1e-3) * 10.0
            if action in ("segment", "scatter", "flat", "pallas"):
                # sparse families pay per nnz; only worth it when thin
                return lanes * easy * (0.5 + 4.0 * profile.density)
        elif policy == "prefetch":
            depth = int(action)
            if depth <= 0:
                return lanes * 1.0  # synchronous: every block waits on host IO
            # diminishing returns past double-buffering, plus pinned-memory
            # pressure per queued block
            return lanes * (0.35 + 0.05 * max(depth - 2, 0))
        elif policy == "blocking":
            if action == "keep":
                return float(lanes)
            if action == "reblock":
                # a re-block costs an ingest pass up front
                return float(lanes) * 1.5
        elif policy == "sharding":
            if action in ("none", "mesh", "perhost_streaming"):
                procs = 1 if action == "none" else 2
                return lanes * hard / procs
        return float("inf")

    # -- predict / observe --------------------------------------------------

    def predict(self, policy: str, action: str, profile: WorkloadProfile) -> float:
        """Realized EMA when we have one for this (policy, action,
        signature); the analytic prior otherwise."""
        obs = self.observations.get(_obs_key(policy, action, profile.signature()))
        if obs is not None:
            return float(obs["cost"])
        return self.prior(policy, action, profile)

    def observe(
        self,
        policy: str,
        action: str,
        profile: WorkloadProfile,
        realized: float,
        predicted: Optional[float] = None,
    ) -> None:
        """Fold one realized cost into the EMA and log predicted-vs-
        realized so the drift is auditable."""
        if predicted is None:
            predicted = self.predict(policy, action, profile)
        key = _obs_key(policy, action, profile.signature())
        prev = self.observations.get(key)
        if prev is None:
            self.observations[key] = {"cost": float(realized), "n": 1}
        else:
            ema = EMA_ALPHA * float(realized) + (1.0 - EMA_ALPHA) * float(prev["cost"])
            self.observations[key] = {"cost": ema, "n": int(prev["n"]) + 1}
        self.drift_log.append({
            "policy": policy,
            "action": action,
            "signature": profile.signature(),
            "predicted": float(predicted),
            "realized": float(realized),
        })
        del self.drift_log[:-_DRIFT_LOG_CAP]

    def choose(
        self,
        policy: str,
        candidates: Sequence[str],
        profile: WorkloadProfile,
    ) -> Tuple[str, float, str]:
        """Lowest predicted cost wins; ties keep candidate order (put the
        incumbent default first so the planner never churns on a tie).
        Returns (action, predicted_cost, reason)."""
        if not candidates:
            raise ValueError(f"no candidates for policy {policy!r}")
        scored = [(self.predict(policy, a, profile), i, a) for i, a in enumerate(candidates)]
        best_cost, _, best = min(scored)
        basis = (
            "realized-cost EMA"
            if _obs_key(policy, best, profile.signature()) in self.observations
            else "static prior"
        )
        others = ", ".join(
            f"{a}={cost:.0f}" for cost, _, a in sorted(scored) if a != best
        )
        reason = (
            f"{basis} picked {best} at {best_cost:.0f} lane-iter units on a "
            f"{profile.signature()} workload"
            + (f" (rejected: {others})" if others else "")
        )
        return best, float(best_cost), reason

    def reblock_recommendation(
        self, block_costs: Optional[Dict[int, float]]
    ) -> Tuple[str, float, str]:
        """The blocking-drift call: from realized per-block costs, decide
        whether re-blocking beats another day on the pinned layout.
        Returns (action, predicted_cost, reason)."""
        if not block_costs:
            return (
                "keep", 1.0,
                "no realized per-block costs yet — keeping the pinned "
                "blocking (a cold model never pays an ingest on a guess)",
            )
        costs = [float(c) for c in block_costs.values()]
        mean = sum(costs) / len(costs)
        peak = max(costs)
        imbalance = peak / mean if mean > 0 else 1.0
        if imbalance > REBLOCK_IMBALANCE:
            return (
                "reblock", imbalance,
                f"realized block-cost imbalance {imbalance:.2f} (peak "
                f"{peak:.1f} vs mean {mean:.1f} over {len(costs)} blocks) "
                f"exceeds {REBLOCK_IMBALANCE} — re-blocking beats another "
                "pinned day",
            )
        return (
            "keep", imbalance,
            f"realized block-cost imbalance {imbalance:.2f} within "
            f"{REBLOCK_IMBALANCE} — the pinned blocking still amortizes",
        )

    def drifted(self, threshold: float = DRIFT_THRESHOLD) -> List[dict]:
        """Drift-log entries whose relative predicted-vs-realized error
        exceeds ``threshold`` (the drift-flagging rule)."""
        out = []
        for entry in self.drift_log:
            predicted = float(entry["predicted"])
            realized = float(entry["realized"])
            denom = max(abs(predicted), 1e-9)
            if abs(realized - predicted) / denom > threshold:
                out.append(entry)
        return out

    # -- persistence (the convergence-ledger discipline) --------------------

    def to_json(self) -> dict:
        return {
            "format": COST_MODEL_FORMAT,
            "observations": self.observations,
            "drift_log": self.drift_log,
        }

    @classmethod
    def from_json(cls, raw: dict, source: str = "imported") -> "CostModel":
        if not isinstance(raw, dict):
            raise ValueError(f"cost model payload is {type(raw).__name__}, not a dict")
        if int(raw.get("format", -1)) != COST_MODEL_FORMAT:
            raise ValueError(
                f"cost model format {raw.get('format')!r} != {COST_MODEL_FORMAT}"
            )
        return cls(
            observations=dict(raw.get("observations") or {}),
            drift_log=list(raw.get("drift_log") or []),
            source=source,
        )

    def save(self, directory: str) -> str:
        """Atomic tmp+rename beside the manifest — a preemption mid-write
        leaves the PRIOR sidecar intact, never a torn one."""
        path = os.path.join(directory, COST_MODEL_FILENAME)
        with open(path + ".tmp", "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
        os.replace(path + ".tmp", path)
        return path

    @classmethod
    def load(cls, directory: str) -> Optional["CostModel"]:
        """The sidecar if readable, else None — torn/missing/old-format
        all degrade the same way (caller records the loud decision and
        falls back to static priors; the sidecar is never load-bearing)."""
        path = os.path.join(directory, COST_MODEL_FILENAME)
        try:
            with open(path) as f:
                raw = json.load(f)
            return cls.from_json(raw, source=path)
        except (OSError, json.JSONDecodeError, ValueError, TypeError):
            return None

    def merge(self, other: "CostModel") -> "CostModel":
        """Pool observations from another model (the fleet's aggregation):
        count-weighted mean per key, drift logs concatenated (capped)."""
        merged = dict(self.observations)
        for key, obs in other.observations.items():
            mine = merged.get(key)
            if mine is None:
                merged[key] = dict(obs)
            else:
                n = int(mine["n"]) + int(obs["n"])
                cost = (
                    float(mine["cost"]) * int(mine["n"])
                    + float(obs["cost"]) * int(obs["n"])
                ) / max(n, 1)
                merged[key] = {"cost": cost, "n": n}
        log = (self.drift_log + other.drift_log)[-_DRIFT_LOG_CAP:]
        return CostModel(merged, log, source=f"{self.source}+{other.source}")
