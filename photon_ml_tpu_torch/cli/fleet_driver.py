"""Sharded serving fleet driver (port of photon_ml_tpu/cli/fleet_driver.py;
photon_ml_tpu_torch.serve.fleet).

One CLI, three modes (the deployment wires them together — typically N
replica processes plus one router process per serving cell):

**build** (``--build-fleet-stores true``): shard-export a saved GAME model
into ``--fleet-dir`` (one ``replica-<r>/`` store per replica, owned
random-effect slab rows only, replicated fixed effects + feature maps,
``fleet.json`` plan), then exit.

**replica** (``--replica-id R``): open ``replica-R``'s shard store on
``--device`` (``cuda`` by default: a replica that finds no card raises),
warm the ladder, start heartbeats, and serve the fleet protocol over TCP
until a ``shutdown`` message. Prints ``READY <host:port>`` on stdout so a
supervisor (or a test harness) can discover an ephemeral port. Replica
processes may share one card; each opens its own CUDA context.

**router** (default): connect to ``--replica-addresses``, serve JSON-lines
scoring requests on stdin/stdout through the consistent-hash
scatter/gather path — the same wire format as ``serve_driver``, swap
command included (``{"cmd": "swap", "store_dir": <new fleet dir>}`` rolls
the whole fleet atomically). The router touches no device.

Usage (2-replica cell)::

    python -m photon_ml_tpu_torch.cli.fleet_driver --fleet-dir /models/fleet \\
        --game-model-input-dir /models/best --num-fleet-replicas 2 \\
        --build-fleet-stores true
    python -m photon_ml_tpu_torch.cli.fleet_driver --fleet-dir /models/fleet \\
        --replica-id 0 --num-fleet-replicas 2 --port 7001 \\
        --heartbeat-dir /models/fleet/hb &
    python -m photon_ml_tpu_torch.cli.fleet_driver --fleet-dir /models/fleet \\
        --replica-id 1 --num-fleet-replicas 2 --port 7002 \\
        --heartbeat-dir /models/fleet/hb &
    python -m photon_ml_tpu_torch.cli.fleet_driver --fleet-dir /models/fleet \\
        --num-fleet-replicas 2 \\
        --replica-addresses 127.0.0.1:7001,127.0.0.1:7002 \\
        --heartbeat-dir /models/fleet/hb < requests.jsonl
"""

from __future__ import annotations

import sys
from typing import List, Optional

from photon_ml_tpu_torch import native_build
from photon_ml_tpu_torch.cli.game_params import GameFleetParams, parse_fleet_params
from photon_ml_tpu_torch.device import enable_determinism
from photon_ml_tpu_torch.utils.logging import PhotonLogger


class GameFleetDriver:
    """Dispatches one of the three fleet modes."""

    def __init__(self, params: GameFleetParams, logger: Optional[PhotonLogger] = None):
        params.validate()
        self.params = params
        self._own_logger = logger is None
        self.logger = logger or PhotonLogger(params.log_path)
        self.fleet_meta: Optional[dict] = None
        self.router = None
        self.engine = None
        self.handled = 0
        # a replica's builds and new batch shapes against --persistent-cache
        self.cache_report: Optional[dict] = None

    # -- build mode ----------------------------------------------------------
    def build_stores(self) -> dict:
        from photon_ml_tpu_torch.compile import resolve_bucketer
        from photon_ml_tpu_torch.serve.fleet import build_fleet_stores

        p = self.params
        self.logger.info(f"shard-exporting {p.game_model_input_dir} -> "
                         f"{p.num_fleet_replicas}-replica fleet {p.fleet_dir}")
        self.fleet_meta = build_fleet_stores(
            p.game_model_input_dir, p.fleet_dir, num_replicas=p.num_fleet_replicas,
            num_buckets=p.num_buckets, bucketer=resolve_bucketer(p.shape_canonicalization),
            store_dtype=p.store_dtype)
        for rep in self.fleet_meta["replicas"]:
            self.logger.info(f"replica {rep['replica']}: entities {rep['entities']}")
        return self.fleet_meta

    # -- replica mode --------------------------------------------------------
    def run_replica(self, out_stream=None) -> None:
        with native_build.use_persistent_cache(self.params.persistent_cache_dir,
                                               self.logger) as cache_mark:
            self._serve_replica(out_stream, cache_mark)

    def _serve_replica(self, out_stream, cache_mark) -> None:
        from photon_ml_tpu_torch.compile import compile_stats
        from photon_ml_tpu_torch.serve import ModelStore
        from photon_ml_tpu_torch.serve.fleet import (
            ReplicaEngine,
            ReplicaServer,
            load_fleet_meta,
            replica_store_dir,
        )

        p = self.params
        out = out_stream if out_stream is not None else sys.stdout
        # fleet.json BEFORE the store open: load_fleet_meta raises on a
        # mixed-dtype fleet, and an already-open store would leak its mmaps
        # on that raise
        fleet_dtype = load_fleet_meta(p.fleet_dir).get("store_dtype") or "f32"
        store = ModelStore(replica_store_dir(p.fleet_dir, p.replica_id))
        if store.store_dtype != fleet_dtype:
            # the replica-side half of the mixed-dtype refusal, for stores
            # load_fleet_meta could not read from the router's host
            store.close()
            raise RuntimeError(
                f"replica {p.replica_id}'s store is {store.store_dtype} but fleet.json pins "
                f"store_dtype {fleet_dtype}; refusing to serve a mixed-dtype fleet — "
                "re-export the whole fleet")
        fp = store.footprint()
        self.logger.info(f"replica store footprint: dtype {fp['store_dtype']}, "
                         f"{fp['slab_bytes_disk']} slab bytes on disk, "
                         f"{fp['mapped_bytes']} bytes mapped")
        try:
            self.engine = ReplicaEngine(
                store, replica_id=p.replica_id, num_replicas=p.num_fleet_replicas,
                heartbeat_dir=p.heartbeat_dir, shard_sections=p.feature_shard_sections,
                bucketer=p.shape_canonicalization, max_batch_rows=p.max_batch_rows,
                max_wait_ms=p.max_wait_ms, device=p.device)
        except BaseException:  # noqa: BLE001 — close-and-reraise: no card (or any failed start) must not leak the store's mmaps
            store.close()
            raise
        self.logger.info(self.engine.describe())
        if p.warmup:
            report = self.engine.warmup(warm_nnz=p.warm_nnz)
            self.logger.info(f"replica warmup: {report['warm_batches']} batches, "
                             f"{report['new_traces']} new batch shapes")
        self.logger.info(compile_stats.summary())
        if cache_mark is not None and p.warmup:
            self.cache_report = self.engine.check_persistent_cache(p.persistent_cache_dir,
                                                                  cache_mark)
        if p.assert_warm and not self.engine.fully_warm():
            self.engine.close()
            raise RuntimeError(
                f"--assert-warm: replica startup built {self.cache_report['builds']} "
                f"native libraries and warmed {self.cache_report['new_shapes']} batch "
                "shapes the persistent cache had not seen (persistent cache cold or "
                "ladder changed)")
        server = ReplicaServer(self.engine, host=p.host, port=p.port)
        out.write(f"READY {server.address}\n")
        out.flush()
        self.logger.info(f"replica {p.replica_id} serving on {server.address}")
        try:
            server.serve_until_shutdown()
        finally:
            self.logger.info(self.engine.stats.summary())
            self.engine.close()

    # -- router mode ---------------------------------------------------------
    def run_router(self, in_stream=None, out_stream=None) -> None:
        from photon_ml_tpu_torch.serve import serve_json_lines
        from photon_ml_tpu_torch.serve.fleet import (
            FleetRouter,
            FleetSwapper,
            TcpReplicaClient,
            load_fleet_meta,
        )
        from photon_ml_tpu_torch.serve.stats import FleetStats

        p = self.params
        self.fleet_meta = load_fleet_meta(p.fleet_dir)
        clients = [TcpReplicaClient(addr) for addr in p.replica_addresses]
        self.router = FleetRouter(
            self.fleet_meta, clients, heartbeat_dir=p.heartbeat_dir,
            heartbeat_deadline_s=p.heartbeat_deadline_s, request_timeout_s=p.request_timeout_s,
            hedge_ms=p.hedge_ms, stats=FleetStats())
        swapper = FleetSwapper(self.router)
        self.router.sync_generation()
        self.logger.info(
            f"fleet router up: {self.router.num_replicas} replicas, generation "
            f"{self.router.generation}, live {sorted(self.router.live_replicas())}, store dtype "
            f"{self.fleet_meta.get('store_dtype') or 'f32'}")
        try:
            self.handled = serve_json_lines(
                self.router, in_stream if in_stream is not None else sys.stdin,
                out_stream if out_stream is not None else sys.stdout, swapper=swapper)
        finally:
            self.logger.info(self.router.stats.summary())
            self.router.close()

    # ------------------------------------------------------------------
    def run(self, in_stream=None, out_stream=None) -> None:
        try:
            mode = self.params.mode()
            if mode == "build":
                self.build_stores()
            elif mode == "replica":
                self.run_replica(out_stream=out_stream)
            else:
                self.run_router(in_stream=in_stream, out_stream=out_stream)
        finally:
            if self._own_logger:
                self.logger.close()


def main(argv: Optional[List[str]] = None) -> GameFleetDriver:
    params = parse_fleet_params(argv)
    if params.mode() == "replica":
        # the build and router modes run nothing on a device
        enable_determinism()
    driver = GameFleetDriver(params)
    driver.run()
    return driver


if __name__ == "__main__":
    main()
