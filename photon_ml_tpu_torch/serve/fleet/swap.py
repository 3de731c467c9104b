"""Fleet-wide atomic model roll: a generation barrier over the single-server
swap (port of photon_ml_tpu/serve/fleet/swap.py).

The single-server swap (serve/swap.py) flips one process's bundle pointer.
A fleet must flip together — if replicas rolled independently, one
request's scatter could gather contributions from two model generations.
The barrier makes that impossible:

  1. **PREPARE (all replicas, in parallel)** — each replica opens the new
     generation's shard store, uploads its slabs to its device, and probes
     a zero batch (watermark-asserted to meet no new batch shape, the
     single-server probe). The old generation keeps serving throughout.
     Any prepare failure aborts the whole swap: every staged bundle is
     abandoned and the fleet keeps serving the old generation — there is
     no partial state.
  2. **BARRIER** — fault site ``serve.fleet_swap_barrier`` fires between
     prepare-all-acked and the flip (a barrier failure aborts exactly like
     a prepare failure).
  3. **FLIP + DRAIN + COMMIT** — the router's dispatch generation flips
     (one atomic int store: every request submitted after this instant
     carries the new tag, every request submitted before it stays pinned
     to the old tag end to end), the router drains the old generation's
     pinned requests, then each replica commits: staged becomes current,
     the old epoch retires. A replica whose commit message is slow keeps
     serving both epochs meanwhile (staged bundles answer reads), so the
     flip is never blocked on a straggler; the next swap re-drives its
     commit.

Zero dropped requests holds by the single server's pinning argument: an
old-generation request is pinned to old-epoch bundles on every replica it
touches, and retirement waits for the pins. A request that loses the race
entirely (scattered at G, arriving after G retired) is re-scored at the
current generation as a whole — degraded to one retry, never to a mix.
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from photon_ml_tpu_torch.checkpoint import CheckpointRefError
from photon_ml_tpu_torch.resilience import faults
from photon_ml_tpu_torch.serve.fleet.plan import (
    ServeShardPlan,
    load_fleet_meta,
    replica_store_dir,
)
from photon_ml_tpu_torch.serve.fleet.router import FleetRouter
from photon_ml_tpu_torch.serve.fleet.transport import ReplicaUnavailableError

logger = logging.getLogger(__name__)


class FleetSwapError(CheckpointRefError):
    """The fleet swap aborted; the old generation is still serving
    everywhere (prepare is all-or-nothing)."""


class FleetSwapper:
    """Serialized fleet-wide rolls for one router."""

    def __init__(self, router: FleetRouter, prepare_timeout_s: float = 120.0):
        self.router = router
        self.prepare_timeout_s = prepare_timeout_s

    def swap(self, fleet_dir: str) -> dict:
        """Roll every replica to the sharded stores under ``fleet_dir``
        (a ``build_fleet_stores`` export) and flip the fleet atomically.

        Returns ``{"generation", "fleet_dir", "new_compiles",
        "dropped_requests", "problems", "commit_failures"}``; raises
        :class:`FleetSwapError` (old generation intact fleet-wide) on an
        incompatible plan, a prepare failure, or a barrier failure.
        """
        meta = load_fleet_meta(fleet_dir)  # refuses a mixed-dtype fleet
        new_plan = ServeShardPlan.from_json(meta["plan"])
        if not self.router.plan.same_assignment(new_plan):
            raise FleetSwapError(
                "refusing fleet swap: the new export's shard plan differs "
                "from the serving plan (slab ownership would diverge from "
                "routing — that is a re-shard, not a swap)"
            )
        cur_dtype = self.router.meta.get("store_dtype") or "f32"
        new_dtype = meta.get("store_dtype") or "f32"
        if cur_dtype != new_dtype:
            # a fleet-wide uniform dtype change is a legitimate roll, but
            # never one free of new shapes: every replica's prepare probe
            # meets the gather on the new slab dtype. Surface it up front
            # (the per-replica validate reports it too).
            logger.warning(
                "fleet swap changes store dtype %s -> %s: the prepare "
                "probes will meet new gather shapes",
                cur_dtype, new_dtype,
            )
        self._redrive_commits()
        epoch = self.router.generation + 1
        n = self.router.num_replicas

        # -- phase 1: prepare everywhere, old generation still serving ------
        prepared: List[int] = []
        problems: List[str] = []
        new_compiles = 0
        with ThreadPoolExecutor(max_workers=n) as pool:
            futs = {
                r: pool.submit(
                    self.router.clients[r].call,
                    {
                        "cmd": "prepare",
                        "store_dir": replica_store_dir(fleet_dir, r),
                        "epoch": epoch,
                    },
                    self.prepare_timeout_s,
                )
                for r in range(n)
            }
            failure: Optional[str] = None
            for r, fut in futs.items():
                try:
                    resp = fut.result(self.prepare_timeout_s + 10.0)
                except Exception as e:  # noqa: BLE001 — swap fence: ANY prepare failure aborts the whole roll below
                    failure = f"replica {r} prepare failed: {e}"
                    continue
                if not resp.get("ok"):
                    failure = f"replica {r} prepare refused: {resp.get('error')}"
                    continue
                prepared.append(r)
                new_compiles += int(resp.get("new_compiles") or 0)
                problems.extend(
                    f"replica {r}: {p}" for p in resp.get("problems") or []
                )
        if failure is None:
            # -- barrier: the chaos injection point between the phases ------
            try:
                faults.inject("serve.fleet_swap_barrier", epoch=epoch)
            except OSError as e:
                failure = f"fleet swap barrier failed: {e}"
        if failure is not None:
            self._abandon(prepared)
            raise FleetSwapError(
                f"fleet swap aborted ({failure}); old generation "
                f"{self.router.generation} still serving on all replicas"
            )

        # -- phase 2: flip the router, drain the old generation's pinned
        # requests (they were tagged at submission; replicas must not
        # retire the old epoch under them), then commit every replica ------
        old_epoch = self.router.generation
        self.router.flip_generation(epoch)
        # the fleet now serves the new export everywhere: adopt its meta
        # wholesale (dtype, per-coordinate quantization budgets, replica
        # store dirs) — the plan is already enforced identical above
        self.router.meta = meta
        if not self.router.drain_generation(old_epoch, self.prepare_timeout_s):
            # stragglers fall back to the stale-rescore safety net (the
            # request re-scores wholesale at the current generation) —
            # degraded to one retry, never to a mixed-generation score
            logger.warning(
                "old generation %d still has pinned requests after %.0fs; "
                "committing anyway (stragglers re-score at generation %d)",
                old_epoch, self.prepare_timeout_s, epoch,
            )
        commit_failures: List[str] = []
        for r in range(n):
            try:
                resp = self.router.clients[r].call(
                    {"cmd": "commit", "epoch": epoch},
                    self.prepare_timeout_s,
                )
                if not resp.get("ok"):
                    commit_failures.append(
                        f"replica {r}: {resp.get('error')}"
                    )
            except (ReplicaUnavailableError, OSError) as e:
                # the staged epoch still serves reads on that replica; the
                # commit (retire-the-old-epoch) can be re-driven later
                commit_failures.append(f"replica {r}: {e}")
        for msg in commit_failures:
            logger.warning("fleet swap commit straggler: %s", msg)
        report = {
            "generation": epoch,
            "fleet_dir": fleet_dir,
            "new_compiles": int(new_compiles),
            "dropped_requests": 0,
            "problems": problems,
            "commit_failures": commit_failures,
        }
        self.router.stats.record_swap(int(new_compiles))
        logger.info(
            "fleet swap -> generation %d (%d replicas, %d new shapes, "
            "%d commit stragglers)",
            epoch, n, new_compiles, len(commit_failures),
        )
        return report

    def rollout_delta(
        self, fleet_dir: str, retrain_dir: Optional[str] = None
    ) -> dict:
        """Roll a DELTA retrain's fleet export through the generation
        barrier as one atomic swap — the last arc of the daily loop
        (retrain → re-shard → export → fleet swap).

        Beyond :meth:`swap`, this validates the provenance seam first:
        ``fleet_dir``'s export must trace back to the retrain run's saved
        model (``retrain_dir``'s committed ``retrain.json``), so a fleet
        cannot atomically adopt an export built from some OTHER model than
        the retrain it claims to roll out. Fault site
        ``serve.fleet_delta_rollout`` fires between validation and the
        swap (the chaos tests' injection point); any failure — injected or
        real — aborts with the old generation intact everywhere, exactly
        like a prepare failure. A mid-swap replica loss inside the
        delegated :meth:`swap` aborts the same way.
        """
        failure: Optional[str] = None
        if retrain_dir is not None:
            from photon_ml_tpu_torch.retrain.manifest import RetrainManifest

            try:
                rman = RetrainManifest.load(retrain_dir)
            except (OSError, ValueError, KeyError) as e:
                failure = (
                    f"retrain dir {retrain_dir} has no committed "
                    f"retrain.json ({e}) — the retrain did not finish; "
                    "nothing to roll out"
                )
            else:
                exported = load_fleet_meta(fleet_dir).get("source_model_dir")
                want = os.path.abspath(rman.model_dir)
                if exported is None or os.path.abspath(exported) != want:
                    failure = (
                        f"fleet export {fleet_dir} was built from "
                        f"{exported}, not the delta retrain's saved model "
                        f"{want} — refusing to roll out a mismatched model"
                    )
        if failure is None:
            try:
                faults.inject(
                    "serve.fleet_delta_rollout",
                    fleet_dir=fleet_dir, retrain_dir=retrain_dir,
                )
            except OSError as e:
                failure = f"delta rollout entry failed: {e}"
        if failure is not None:
            raise FleetSwapError(
                f"delta rollout aborted ({failure}); old generation "
                f"{self.router.generation} still serving on all replicas"
            )
        report = self.swap(fleet_dir)
        report["rollout"] = "delta"
        report["retrain_dir"] = retrain_dir
        return report

    def _redrive_commits(self) -> None:
        """Re-send commit to any replica still behind the router's
        generation (a commit message lost to a transient network blip must
        not wedge every future swap — the straggler's staged bundle is
        still there, serving reads, waiting to be committed)."""
        gen = self.router.generation
        if gen == 0:
            return
        for r, client in enumerate(self.router.clients):
            try:
                resp = client.call({"cmd": "ping"}, 10.0)
                if resp.get("ok") and int(resp.get("epoch") or 0) < gen:
                    logger.warning(
                        "re-driving commit(%d) on lagging replica %d "
                        "(at epoch %s)", gen, r, resp.get("epoch"),
                    )
                    client.call({"cmd": "commit", "epoch": gen}, 30.0)
            except (ReplicaUnavailableError, OSError, ValueError):
                # an unreachable replica fails the upcoming prepare, which
                # aborts the swap with the honest diagnosis
                continue

    def _abandon(self, prepared: List[int]) -> None:
        for r in prepared:
            try:
                self.router.clients[r].call({"cmd": "abandon"}, 30.0)
            except (ReplicaUnavailableError, OSError) as e:
                logger.warning(
                    "abandon after aborted swap failed on replica %d: %s",
                    r, e,
                )
