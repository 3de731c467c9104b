"""Thin consistent-hash router over the serving-fleet replicas (port of
photon_ml_tpu/serve/fleet/router.py).

The router owns no model state — just the
:class:`~photon_ml_tpu_torch.serve.fleet.plan.ServeShardPlan` (bucket ->
owner lookup), the coordinate order from ``fleet.json``, and one client per
replica. It runs no torch op and touches no device. Per request:

  1. **route** — each row's entity id maps to its slab-owner replica
     (plan lookup); each row's fixed-effect contribution is computed by
     the row's "home" replica (the fixed vectors are replicated, so any
     live replica can serve them — a dead home just reroutes).
  2. **scatter** — one sub-request per involved replica, asking for the
     per-coordinate contribution arrays it can compute (fault site
     ``serve.replica_scatter``; a failed call is retried once on the same
     replica, then recovered: fixed parts reroute to a live replica,
     random parts degrade to the cold-entity 0 — never a hang).
  3. **gather + pinned-order sum** — contributions assemble into
     ``total = offset + fixed (store order) + random (store order)`` with
     eager f32 numpy adds, the op order the single-store server and the
     batch scoring driver run on the device (each an elementwise f32 add,
     rounded once: no fused multiply-add on either side) — fleet scores
     are bitwise equal to both.

Hedging: with ``hedge_ms`` set, a sub-request whose owner has not replied
within the hedge window fires a backup fixed-only request at another live
replica, bounding tail latency on the replicated half of the work.

Liveness rides the heartbeat machinery: replicas write
``heartbeat-<r>.json`` (:class:`~photon_ml_tpu_torch.parallel.multihost.
MultihostContext`), the router reads the ages and stops dispatching to a
replica whose heartbeat is stale — a killed replica is detected within the
heartbeat deadline and traffic keeps flowing in degraded mode.

Generations: every request is pinned to the router's current generation at
submission (the single server's contract — a swap landing while the
request is queued does not move it) and scored entirely at that one
generation; the fleet swap flips the tag atomically for later submissions
and fences replica retirement on the old generation's drain. A replica
that already retired a generation answers ``stale_generation``, which
re-scores the whole request at the current one — mixed-generation scoring
of a single request is impossible.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor, TimeoutError as FutureTimeout
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from photon_ml_tpu_torch.parallel.multihost import MultihostContext
from photon_ml_tpu_torch.resilience import faults
from photon_ml_tpu_torch.serve.fleet.plan import ServeShardPlan
from photon_ml_tpu_torch.serve.fleet.replica import FIXED_PREFIX, RANDOM_PREFIX
from photon_ml_tpu_torch.serve.fleet.transport import ReplicaUnavailableError
from photon_ml_tpu_torch.serve.stats import FleetStats

logger = logging.getLogger(__name__)


class _StaleGeneration(Exception):
    """A replica already retired the generation this request was scattered
    at — re-score the WHOLE request at the current generation. Carries the
    replica's current epoch so the router can fast-forward."""

    def __init__(self, message: str, epoch: Optional[int] = None):
        super().__init__(message)
        self.epoch = epoch


class NoLiveReplicaError(OSError):
    """Every replica is dead (heartbeats stale / calls failing)."""


class FleetRouter:
    """Scatter/gather scoring over a replica fleet; duck-types the
    :func:`~photon_ml_tpu_torch.serve.server.serve_json_lines` server surface
    (``submit_rows`` / ``drain`` / ``stats`` / ``new_request_compiles``)
    so the serve driver's JSON-lines loop fronts a fleet unchanged."""

    def __init__(
        self,
        fleet_meta: dict,
        clients: Sequence,
        heartbeat_dir: Optional[str] = None,
        heartbeat_deadline_s: float = 5.0,
        request_timeout_s: float = 30.0,
        hedge_ms: Optional[float] = None,
        failure_threshold: int = 2,
        probe_cooldown_s: float = 5.0,
        stats: Optional[FleetStats] = None,
        max_request_workers: int = 8,
    ):
        self.meta = fleet_meta
        self.plan = ServeShardPlan.from_json(fleet_meta["plan"])
        if len(clients) != self.plan.num_replicas:
            raise ValueError(
                f"{len(clients)} clients for a {self.plan.num_replicas}"
                "-replica plan"
            )
        self.clients = list(clients)
        self.num_replicas = self.plan.num_replicas
        self.fixed_names = [e["name"] for e in fleet_meta["fixed"]]
        self.random_coords = [
            (e["name"], e["re_id"]) for e in fleet_meta["random"]
        ]
        self.heartbeat_dir = heartbeat_dir
        self.heartbeat_deadline_s = heartbeat_deadline_s
        self.request_timeout_s = request_timeout_s
        self.hedge_s = hedge_ms / 1e3 if hedge_ms else None
        self.failure_threshold = failure_threshold
        self.probe_cooldown_s = probe_cooldown_s
        self.stats = stats if stats is not None else FleetStats()
        self._ctx = MultihostContext(
            process_id=0, num_processes=self.num_replicas
        )
        self._generation = 0
        self._gen_lock = threading.Lock()
        self._failures: Dict[int, int] = {}
        self._last_failure: Dict[int, float] = {}
        self._state_lock = threading.Lock()
        # two pools: request tasks scatter into the dispatch pool and WAIT
        # on its futures — sharing one pool would deadlock at saturation
        self._request_pool = ThreadPoolExecutor(
            max_workers=max_request_workers,
            thread_name_prefix="photon-fleet-request",
        )
        self._dispatch_pool = ThreadPoolExecutor(
            max_workers=2 * self.num_replicas + 4,
            thread_name_prefix="photon-fleet-scatter",
        )
        # hedged calls get their own pool: a dispatch-pool task must never
        # wait on futures queued into the dispatch pool (deadlock at
        # saturation)
        self._hedge_pool = ThreadPoolExecutor(
            max_workers=2 * self.num_replicas + 4,
            thread_name_prefix="photon-fleet-hedge",
        )
        self._outstanding = 0
        self._idle = threading.Event()
        self._idle.set()
        # per-generation in-flight counts (the single server's pinning,
        # router form):
        # a request is tagged with the CURRENT generation at submission and
        # counted against it until it resolves, so the fleet swapper can
        # fence replica retirement on the old generation's drain instead of
        # pushing every queued request through the stale-rescore path
        self._gen_inflight: Dict[int, int] = {}
        self._gen_cond = threading.Condition(self._state_lock)
        self._closed = False

    # -- generation (the fleet swap flips this) ------------------------------
    @property
    def generation(self) -> int:
        return self._generation

    def flip_generation(self, epoch: int) -> None:
        with self._gen_lock:
            self._generation = epoch

    def _fast_forward(self, epoch: int) -> None:
        with self._gen_lock:
            if epoch > self._generation:
                self._generation = epoch

    def sync_generation(self, timeout: float = 5.0) -> int:
        """Adopt the fleet's current epoch (max over reachable replicas) —
        a freshly started router joining a long-lived fleet must not
        dispatch at generation 0 against replicas that already swapped.
        Best-effort: unreachable replicas are skipped (the stale-rescore
        fast-forward covers any replica this misses)."""
        for r, client in enumerate(self.clients):
            try:
                resp = client.call({"cmd": "ping"}, timeout=timeout)
                if resp.get("ok"):
                    self._fast_forward(int(resp.get("epoch") or 0))
            except (ReplicaUnavailableError, OSError, ValueError):
                continue
        return self._generation

    # -- liveness ------------------------------------------------------------
    def _record_failure(self, r: int) -> None:
        with self._state_lock:
            self._failures[r] = self._failures.get(r, 0) + 1
            self._last_failure[r] = time.monotonic()

    def _record_success(self, r: int) -> None:
        with self._state_lock:
            self._failures[r] = 0

    def live_replicas(self) -> Set[int]:
        """Replicas the router will dispatch to right now: heartbeat fresh
        (when a heartbeat dir is configured) and not circuit-broken by
        consecutive call failures (broken replicas are re-probed after a
        cooldown so a recovered process rejoins without intervention)."""
        now = time.monotonic()
        ages = (
            self._ctx.heartbeat_ages(self.heartbeat_dir)
            if self.heartbeat_dir
            else None
        )
        live: Set[int] = set()
        for r in range(self.num_replicas):
            if ages is not None:
                age = ages.get(r)
                if age is None or age > self.heartbeat_deadline_s:
                    self.stats.record_dead_replica_skip()
                    continue
            with self._state_lock:
                broken = self._failures.get(r, 0) >= self.failure_threshold
                recent = now - self._last_failure.get(r, 0.0)
            if broken and recent < self.probe_cooldown_s:
                self.stats.record_dead_replica_skip()
                continue
            live.add(r)
        return live

    # -- request surface -----------------------------------------------------
    def submit_rows(self, rows: List[dict]) -> Future:
        """Non-blocking fleet scoring; Future of (n,) f32 scores. The
        request is PINNED to the current generation here, at submission
        (the single server pins at featurize time — same contract): a swap
        that lands while this request is still queued does not move it."""
        gen = self._generation
        with self._state_lock:
            if self._closed:
                raise RuntimeError("router is closed")
            self._outstanding += 1
            self._idle.clear()
            self._gen_inflight[gen] = self._gen_inflight.get(gen, 0) + 1
        fut = self._request_pool.submit(self._score, rows, time.monotonic(), gen)
        fut.add_done_callback(lambda f, g=gen: self._on_done(g))
        return fut

    def _on_done(self, gen: int) -> None:
        with self._state_lock:
            self._outstanding -= 1
            if self._outstanding == 0:
                self._idle.set()
            left = self._gen_inflight.get(gen, 1) - 1
            if left <= 0:
                self._gen_inflight.pop(gen, None)
            else:
                self._gen_inflight[gen] = left
            self._gen_cond.notify_all()

    def drain_generation(self, gen: int, timeout: Optional[float] = None) -> bool:
        """Block until no request pinned to ``gen`` is in flight (the
        fleet swapper's fence before replicas retire that epoch)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._gen_cond:
            while self._gen_inflight.get(gen, 0) > 0:
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    return False
                self._gen_cond.wait(remaining)
        return True

    def score_rows(self, rows: List[dict]) -> np.ndarray:
        if not rows:
            return np.zeros(0, np.float32)
        return self.submit_rows(rows).result()

    def drain(self, timeout: Optional[float] = None) -> bool:
        return self._idle.wait(timeout)

    def new_request_compiles(self) -> int:
        """Best-effort sum of the replicas' post-warmup new batch shapes
        (shapes are met on replicas; the router scores nothing itself)."""
        total = 0
        for r in self.live_replicas():
            try:
                resp = self.clients[r].call({"cmd": "stats"}, timeout=5.0)
                total += int(resp.get("new_request_compiles") or 0)
            except (ReplicaUnavailableError, OSError, ValueError):
                continue
        return total

    def close(self) -> None:
        with self._state_lock:
            self._closed = True
        self._request_pool.shutdown(wait=True)
        self._dispatch_pool.shutdown(wait=True)
        self._hedge_pool.shutdown(wait=True)
        for c in self.clients:
            c.close()

    # -- scoring internals ---------------------------------------------------
    def _score(
        self, rows: List[dict], submitted: float,
        pinned_gen: Optional[int] = None,
    ) -> np.ndarray:
        faults.inject("serve.route", rows=len(rows))
        for _attempt in range(3):
            # first attempt honors the submission pin; a stale-generation
            # answer (the replica already retired that epoch) re-pins to
            # the current generation wholesale
            gen = (
                pinned_gen
                if _attempt == 0 and pinned_gen is not None
                else self._generation
            )
            try:
                scores = self._score_at(rows, gen)
                break
            except _StaleGeneration as stale:
                # the fleet swapped under this request (or this router just
                # started against an already-swapped fleet); fast-forward
                # and score wholesale at the current generation
                # (all-or-nothing — the request never mixes generations)
                if stale.epoch is not None:
                    self._fast_forward(stale.epoch)
                self.stats.record_stale_rescore()
        else:
            raise RuntimeError(
                "request kept racing fleet swaps (3 stale generations)"
            )
        self.stats.record_request(time.monotonic() - submitted, len(rows))
        return scores

    def _score_at(self, rows: List[dict], gen: int) -> np.ndarray:
        n = len(rows)
        offsets = np.asarray(
            [float(r.get("offset") or 0.0) for r in rows], np.float32
        )
        owners_by_coord = {
            name: self.plan.owners_of(
                [(r.get("ids") or {}).get(re_id) for r in rows]
            )
            for name, re_id in self.random_coords
        }
        live = self.live_replicas()
        if not live:
            raise NoLiveReplicaError(
                "no live replica (all heartbeats stale or circuit-broken)"
            )
        live_sorted = sorted(live)

        # home replica per row (fixed-effect owner): the first coordinate's
        # slab owner when live (contributions and entity rows then ride ONE
        # sub-request), else any live replica — fixed vectors are replicated
        home = np.full(n, -1, np.int32)
        for name, _re_id in self.random_coords:
            o = owners_by_coord[name]
            home = np.where(home < 0, o, home)
        for i in range(n):
            if home[i] < 0 or int(home[i]) not in live:
                if home[i] >= 0:
                    self.stats.record_reroute()
                home[i] = live_sorted[i % len(live_sorted)]

        # degraded rows: a coordinate whose owner is dead serves the
        # cold-entity fallback (contribution 0) instead of blocking
        degraded = 0
        for name, _re_id in self.random_coords:
            o = owners_by_coord[name]
            degraded += int(np.sum((o >= 0) & ~np.isin(o, live_sorted)))

        # per-replica sub-request: union of rows it serves, one message;
        # owned_counts tracks how many rows each coordinate REALLY owes
        # this replica (degradation accounting must not count home-only
        # rows that never carried a random contribution)
        plans = {}
        for r in live_sorted:
            need = home == r
            wants_random = []
            owned_counts = {}
            for name, _re_id in self.random_coords:
                mask = owners_by_coord[name] == r
                if mask.any():
                    wants_random.append(name)
                    owned_counts[name] = int(mask.sum())
                    need = need | mask
            idxs = np.flatnonzero(need)
            if len(idxs):
                plans[r] = {
                    "idxs": idxs,
                    "fixed": bool(np.any(home[idxs] == r)),
                    "random": wants_random,
                    "owned_counts": owned_counts,
                }
        self.stats.record_scatter(len(plans))

        futures = {
            r: self._dispatch_pool.submit(
                self._gather_replica, r, p, rows, gen, live_sorted
            )
            for r, p in plans.items()
        }
        results = {}
        deadline = time.monotonic() + self.request_timeout_s + 10.0
        for r, fut in futures.items():
            try:
                results[r] = fut.result(max(deadline - time.monotonic(), 0.1))
            except FutureTimeout:
                # a gather that outlives even the recovery budget degrades
                # exactly like a failed one (the task keeps running in the
                # background and is simply ignored) — the request must
                # answer, not hang or hard-fail
                self._record_failure(r)
                results[r] = None

        # per-coordinate degradation accounting: any owed contribution the
        # gather did not deliver (failed call, timeout, or a fixed-only
        # hedge answer) served the cold-entity 0 for its rows
        for r, p in plans.items():
            res = results.get(r)
            for name in p["random"]:
                if res is None or (RANDOM_PREFIX + name) not in res:
                    degraded += p["owned_counts"][name]
        if degraded:
            self.stats.record_degraded_rows(degraded)

        # pinned-order sum: offset, then fixed coordinates in store order,
        # then random coordinates in store order — eager f32 adds, the
        # exact op sequence ScoringServer._score_with / the batch driver
        # run on the device, so fleet scores are bitwise equal to both
        total = offsets
        for name in self.fixed_names:
            contrib = np.zeros(n, np.float32)
            for r, p in plans.items():
                res = results.get(r)
                if res is None or (FIXED_PREFIX + name) not in res:
                    continue
                vals = res[FIXED_PREFIX + name]
                mine = home[p["idxs"]] == r
                contrib[p["idxs"][mine]] = vals[mine]
            total = total + contrib
        for name, _re_id in self.random_coords:
            contrib = np.zeros(n, np.float32)
            o = owners_by_coord[name]
            for r, p in plans.items():
                res = results.get(r)
                if res is None or (RANDOM_PREFIX + name) not in res:
                    continue
                vals = res[RANDOM_PREFIX + name]
                mine = o[p["idxs"]] == r
                contrib[p["idxs"][mine]] = vals[mine]
            total = total + contrib
        return total

    def _dispatch(self, r: int, msg: dict) -> dict:
        faults.inject("serve.replica_scatter", replica=r)
        resp = self.clients[r].call(msg, timeout=self.request_timeout_s)
        if not resp.get("ok"):
            if resp.get("stale_generation"):
                raise _StaleGeneration(
                    resp.get("error", ""), epoch=resp.get("epoch")
                )
            raise ReplicaUnavailableError(
                f"replica {r} refused: {resp.get('error')}"
            )
        return resp

    def _gather_replica(
        self,
        r: int,
        p: dict,
        rows: List[dict],
        gen: int,
        live_sorted: List[int],
    ) -> Optional[Dict[str, np.ndarray]]:
        """One replica's contribution arrays (keyed like the wire, values
        (len(idxs),) f32), or None after full degradation. Never raises
        except :class:`_StaleGeneration` (whole-request re-score)."""
        sub_rows = [rows[i] for i in p["idxs"]]
        msg = {
            "cmd": "contribs",
            "epoch": gen,
            "rows": sub_rows,
            "fixed": p["fixed"],
            "random": p["random"],
        }
        resp = None
        from_primary = True
        try:
            if self.hedge_s is not None and p["fixed"]:
                resp, from_primary = self._call_hedged(
                    r, msg, sub_rows, live_sorted
                )
            else:
                resp = self._dispatch(r, msg)
        except _StaleGeneration:
            raise
        except (ReplicaUnavailableError, OSError, FutureTimeout):
            self._record_failure(r)
            # routed retry: one more attempt on the owner (it may have just
            # restarted or dropped one connection)
            try:
                self.stats.record_routed_retry()
                resp = self._dispatch(r, msg)
            except _StaleGeneration:
                raise
            except (ReplicaUnavailableError, OSError):
                self._record_failure(r)
                resp = None
        if resp is not None:
            if from_primary:
                self._record_success(r)
            else:
                # the owner never answered inside the deadline; the hedge's
                # fixed-only reply served — the slow owner counts as failed
                # (its random contributions degraded; the caller's per-
                # coordinate accounting sees the missing keys)
                self._record_failure(r)
            return {
                k: np.asarray(v, np.float32)
                for k, v in (resp.get("contribs") or {}).items()
            }
        # full degradation: random parts fall back to the cold-entity 0
        # (the caller's per-coordinate accounting records them); fixed
        # parts reroute to any live replica — the fixed vectors are
        # replicated, so the reroute is exact, not degraded
        out: Dict[str, np.ndarray] = {}
        if p["fixed"]:
            backup = next((b for b in live_sorted if b != r), None)
            if backup is not None:
                try:
                    self.stats.record_reroute()
                    bresp = self._dispatch(
                        backup,
                        {
                            "cmd": "contribs",
                            "epoch": gen,
                            "rows": sub_rows,
                            "fixed": True,
                            "random": [],
                        },
                    )
                    out = {
                        k: np.asarray(v, np.float32)
                        for k, v in (bresp.get("contribs") or {}).items()
                    }
                except (ReplicaUnavailableError, OSError):
                    self._record_failure(backup)
        return out or None

    def _call_hedged(
        self, r: int, msg: dict, sub_rows: List[dict],
        live_sorted: List[int],
    ) -> tuple:
        """Primary call with a fixed-only hedge: if the owner has not
        replied within the hedge window, a backup replica computes the
        replicated (fixed) half in parallel; the owner's reply still wins
        when it arrives (it carries the random parts the backup cannot
        compute). Returns ``(response, from_primary)``.

        Both calls run on the DEDICATED hedge pool: the caller is itself a
        dispatch-pool task, and nesting waits into that same pool would
        deadlock it at saturation (every worker blocked on a queued
        child)."""
        primary = self._hedge_pool.submit(self._dispatch, r, msg)
        try:
            return primary.result(self.hedge_s), True
        except FutureTimeout:
            pass
        backup = next((b for b in live_sorted if b != r), None)
        hedge = None
        if backup is not None:
            self.stats.record_hedge()
            hedge = self._hedge_pool.submit(
                self._dispatch,
                backup,
                {
                    "cmd": "contribs",
                    "epoch": msg["epoch"],
                    "rows": sub_rows,
                    "fixed": True,
                    "random": [],
                },
            )
        try:
            return primary.result(self.request_timeout_s), True
        except (ReplicaUnavailableError, OSError, FutureTimeout):
            if hedge is not None:
                try:
                    return (
                        hedge.result(max(self.request_timeout_s / 4, 1.0)),
                        False,
                    )
                except (ReplicaUnavailableError, OSError, FutureTimeout):
                    pass
            raise
