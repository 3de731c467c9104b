"""One serving-fleet replica: a shard-store scoring engine + fleet hooks
(port of photon_ml_tpu/serve/fleet/replica.py).

A replica is the :class:`~photon_ml_tpu_torch.serve.server.ScoringServer`
opened over its sharded store (its owned random-effect slab rows plus the
replicated fixed-effect vectors and feature maps) with three fleet-facing
extensions:

  * **per-coordinate contributions** (:meth:`ReplicaEngine.contribs`) —
    the router scatters sub-requests asking for exactly the contribution
    arrays this replica can compute (fixed effects: any replica; random
    effects: the slab owner). The math goes through the same torch ops,
    scoring sites and ladder padding as full scoring, so a warmed server
    meets no new batch shape, and per-row results are bitwise what the
    single-store server computes for those rows.
  * **two-phase model roll** (:meth:`prepare` / :meth:`commit` /
    :meth:`abandon`) — the fleet-wide atomic swap splits the single-server
    swap into an epoch-tagged prepare (open + upload + probe the new store,
    watermark-asserted to meet no new batch shape) and a commit (flip,
    retire the old epoch after its pinned requests drain). Between the
    phases both epochs serve, so the router can flip the whole fleet
    atomically. A pinned request holds its bundle, so the old epoch's
    device tensors live until the last such request is answered.
  * **heartbeats** — the :class:`~photon_ml_tpu_torch.parallel.multihost.
    MultihostContext` heartbeat writer runs on a background thread so the
    router (and any operator) can see replica liveness by file age.

``device`` (a server keyword) is where the replica scores: ``cuda`` by
default, which raises without a card; ``cpu`` only when asked.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.compile import compile_stats
from photon_ml_tpu_torch.parallel.multihost import MultihostContext
from photon_ml_tpu_torch.serve.model_store import ModelStore
from photon_ml_tpu_torch.serve.server import ScoringServer, _at_site

logger = logging.getLogger(__name__)

FIXED_PREFIX = "fixed:"
RANDOM_PREFIX = "random:"


class StaleGenerationError(RuntimeError):
    """A sub-request named an epoch this replica has already retired (the
    commit/scatter race). The router re-scores the whole request at the
    current epoch — all-or-nothing, so no request mixes generations."""


class ReplicaEngine(ScoringServer):
    """ScoringServer over a shard store + contribution/epoch/heartbeat
    surface for the fleet router."""

    def __init__(
        self,
        store: ModelStore,
        replica_id: int = 0,
        num_replicas: int = 1,
        heartbeat_dir: Optional[str] = None,
        heartbeat_interval_s: float = 1.0,
        drain_timeout_s: float = 60.0,
        **server_kwargs,
    ):
        super().__init__(store, **server_kwargs)
        self.replica_id = int(replica_id)
        self.num_replicas = int(num_replicas)
        self.drain_timeout_s = drain_timeout_s
        self._epoch = 0
        self._epoch_bundles = {0: self._model}
        self._staged: Optional[tuple] = None  # (epoch, bundle)
        self._epoch_lock = threading.Lock()
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        if heartbeat_dir:
            ctx = MultihostContext(process_id=self.replica_id, num_processes=self.num_replicas)

            def beat() -> None:
                while not self._hb_stop.is_set():
                    try:
                        ctx.write_heartbeat(heartbeat_dir)
                    except OSError as e:
                        logger.warning("replica %d heartbeat failed: %s", self.replica_id, e)
                    self._hb_stop.wait(heartbeat_interval_s)

            self._hb_thread = threading.Thread(
                target=beat, name=f"photon-fleet-heartbeat-{self.replica_id}", daemon=True)
            self._hb_thread.start()

    # -- epoch bookkeeping ---------------------------------------------------
    @property
    def epoch(self) -> int:
        return self._epoch

    def _bundle_for(self, epoch: Optional[int]):
        with self._epoch_lock:
            if epoch is None:
                epoch = self._epoch
            bundle = self._epoch_bundles.get(epoch)
            if bundle is None and self._staged is not None and self._staged[0] == epoch:
                # a prepared-but-not-yet-committed epoch is servable: the
                # router may flip its dispatch generation before this
                # replica's commit message lands
                bundle = self._staged[1]
            if bundle is None:
                raise StaleGenerationError(
                    f"replica {self.replica_id} has no epoch {epoch} (current {self._epoch})")
            return bundle

    # -- contributions (the scatter target) ----------------------------------
    def contribs(
        self,
        rows: List[dict],
        want_fixed: bool,
        want_random: List[str],
        epoch: Optional[int] = None,
    ) -> Dict[str, np.ndarray]:
        """Per-coordinate contribution arrays for ``rows`` against one
        epoch's bundle: ``{"fixed:<name>": (n,) f32, "random:<name>":
        (n,) f32}``. Rows are chunked at ``max_batch_rows`` so every
        device call stays on a warmed ladder rung."""
        bundle = self._bundle_for(epoch)
        while not bundle.begin_request():
            bundle = self._bundle_for(epoch)  # raises once truly retired
        try:
            cap = self.batcher.max_batch_rows
            parts: List[Dict[str, np.ndarray]] = []
            for lo in range(0, len(rows), cap):
                chunk = rows[lo:lo + cap]
                batch = self.featurize(chunk, bundle)
                padded = batch.padded(self.bucketer)
                parts.append(self._contrib_with(bundle, padded, want_fixed, want_random,
                                                len(chunk)))
            if len(parts) == 1:
                return parts[0]
            return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        finally:
            bundle.end_request()

    def _contrib_with(self, bundle, batch, want_fixed: bool, want_random: List[str],
                      n_real: int) -> Dict[str, np.ndarray]:
        """One padded batch -> requested contribution arrays, through the
        same ops and scoring sites (and so the same seen shapes) that
        :meth:`_score_with` runs."""
        if self.device.type == "cuda":
            # the router's dispatch pool and the TCP handlers call in from
            # threads of their own
            torch.cuda.set_device(self.device.index)
        idx_dev = {s: self._put(a) for s, a in batch.shard_idx.items()}
        val_dev = {s: self._put(a) for s, a in batch.shard_val.items()}
        n = batch.num_rows
        out: Dict[str, np.ndarray] = {}
        if want_fixed:
            for name, shard, w in bundle.fixed:
                idx, vals = idx_dev[shard], val_dev[shard]
                c = _at_site("serve.fixed_contrib",
                             (n, idx.shape[1], str(w.dtype), tuple(w.shape)),
                             lambda: self._fixed_contrib(w, idx, vals))
                out[FIXED_PREFIX + name] = c.cpu().numpy()[:n_real]
        if want_random:
            wanted = set(want_random)
            for name, _re_id, shard, slab, scales in bundle.random:
                if name not in wanted:
                    continue
                idx, vals = idx_dev[shard], val_dev[shard]
                ent = self._put(batch.ent_row[name])
                c = _at_site("serve.re_gather",
                             (n, idx.shape[1], str(slab.dtype), tuple(slab.shape)),
                             lambda: self._re_contrib(slab, scales, ent, idx, vals))
                out[RANDOM_PREFIX + name] = c.cpu().numpy()[:n_real]
        return out

    # -- two-phase fleet swap ------------------------------------------------
    def prepare(self, store_dir: str, epoch: int) -> dict:
        """Phase 1: open + upload + probe the new store as ``epoch``.
        Serving continues on the current epoch; the staged bundle also
        serves (the router may flip before commit lands). Raises (and
        leaves nothing staged) on any failure — the fleet swap aborts."""
        from photon_ml_tpu_torch.serve.swap import ModelSwapper

        with self._epoch_lock:
            current = self._epoch
        if epoch <= current:
            # a higher-than-next epoch is accepted (a restarted replica
            # rejoining a long-lived fleet adopts the fleet's sequence);
            # at-or-below-current would roll time backwards
            raise ValueError(
                f"replica {self.replica_id}: prepare epoch {epoch} is not ahead of current "
                f"epoch {current}")
        new_store = ModelStore(store_dir)
        try:
            problems = ModelSwapper(self).validate_compatible(new_store)
            for p in problems:
                logger.warning("replica %d swap shape change: %s", self.replica_id, p)
            bundle = self._build_bundle(new_store)
            wm = compile_stats.watermark()
            self._probe_bundle(bundle)
            new_compiles = wm.new_traces()
        except BaseException:  # noqa: BLE001 — close-and-reraise: the staged store's mmaps must not leak on ANY prepare failure (incl. KeyboardInterrupt)
            new_store.close()
            raise
        with self._epoch_lock:
            if self._staged is not None:
                self._staged[1].store.close()
            self._staged = (epoch, bundle)
        return {"epoch": epoch, "new_compiles": int(new_compiles), "problems": problems}

    def _probe_bundle(self, bundle) -> None:
        n = self._ladder_rungs(1, 1)[0] if self.bucketer else 1
        k = self.bucketer.canon(1) if self.bucketer else 1
        self._score_with(bundle, self._zero_batch(bundle, n, k))

    def commit(self, epoch: int) -> dict:
        """Phase 2: make the staged epoch current and retire the previous
        one once its pinned requests drain."""
        with self._epoch_lock:
            if self._staged is None or self._staged[0] != epoch:
                raise ValueError(f"replica {self.replica_id}: no staged epoch {epoch} to commit")
            _, bundle = self._staged
            self._staged = None
            with self._swap_lock:
                old, self._model = self._model, bundle
            old_epoch = self._epoch
            self._epoch = epoch
            self._epoch_bundles[epoch] = bundle
        # gauges flip with the install (prepare must NOT record them — an
        # aborted swap's staged store never serves)
        self.stats.record_store_footprint(**bundle.store.footprint())
        self._retire(old_epoch, old)
        return {"epoch": epoch}

    def abandon(self) -> dict:
        """Drop a staged epoch (fleet swap aborted); current keeps serving."""
        with self._epoch_lock:
            staged, self._staged = self._staged, None
        if staged is not None:
            staged[1].store.close()
        return {"abandoned": staged[0] if staged is not None else None}

    def _retire(self, epoch: int, bundle) -> None:
        """Per-generation drain->retire fence (the single-server swapper's
        loop): once retire_if_idle returns True no new pin can land, so the
        old store's mmaps close safely."""
        deadline = time.monotonic() + self.drain_timeout_s
        retired = False
        while not retired:
            remaining = deadline - time.monotonic()
            if not bundle.drain(max(remaining, 0.0)):
                break
            retired = bundle.retire_if_idle()
        if retired:
            bundle.store.close()
            with self._epoch_lock:
                self._epoch_bundles.pop(epoch, None)
        else:
            logger.warning(
                "replica %d epoch %d still has in-flight requests after %.0fs; leaving its "
                "store open", self.replica_id, epoch, self.drain_timeout_s)

    # ------------------------------------------------------------------
    def describe(self) -> str:
        return (f"replica {self.replica_id}/{self.num_replicas} epoch {self._epoch} on "
                f"{self.device}: {self.store.describe()}")

    def close(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5.0)
        with self._epoch_lock:
            staged, self._staged = self._staged, None
        if staged is not None:
            staged[1].store.close()
        super().close()
