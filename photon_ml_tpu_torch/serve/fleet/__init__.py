"""Sharded serving fleet: GAME models too large for one replica behind a
thin consistent-hash router (port of photon_ml_tpu/serve/fleet/).

The fleet partitions the model the way per-host training partitions it
(deterministic balanced entity blocking) and serves it owner-computes:

  * :mod:`.plan` — :class:`ServeShardPlan` (stable entity hash -> bucket
    -> balanced owner replica; the explicit placement object) and
    :func:`build_fleet_stores` (one sharded store per replica: owned
    random-effect slab rows + replicated fixed effects and feature maps).
  * :mod:`.replica` — :class:`ReplicaEngine`, the ScoringServer over a
    shard store plus per-coordinate contribution scoring, the two-phase
    (prepare/commit) epoch roll, and heartbeats.
  * :mod:`.transport` — JSON-lines protocol shared by the in-process
    client and the threaded TCP server/client of replica processes.
  * :mod:`.router` — :class:`FleetRouter`: consistent-hash scatter,
    hedged sub-requests, heartbeat liveness, degradation instead of
    hangs, and the pinned-order gather-sum that keeps fleet scores
    bitwise equal to the single-store server and the batch driver.
  * :mod:`.swap` — :class:`FleetSwapper`: the fleet-wide atomic
    generation barrier (prepare-all -> flip -> commit; no mixed
    generations, no new batch shapes, zero dropped requests).

Driver: ``photon_ml_tpu_torch.cli.fleet_driver`` (build-stores / replica /
router modes).
"""

from __future__ import annotations

from photon_ml_tpu_torch.serve.fleet.plan import (
    DEFAULT_NUM_BUCKETS,
    ServeShardPlan,
    build_fleet_stores,
    is_fleet_dir,
    load_fleet_meta,
    replica_store_dir,
)
from photon_ml_tpu_torch.serve.fleet.replica import ReplicaEngine, StaleGenerationError
from photon_ml_tpu_torch.serve.fleet.router import FleetRouter, NoLiveReplicaError
from photon_ml_tpu_torch.serve.fleet.swap import FleetSwapError, FleetSwapper
from photon_ml_tpu_torch.serve.fleet.transport import (
    LocalReplicaClient,
    ReplicaServer,
    ReplicaUnavailableError,
    TcpReplicaClient,
)

__all__ = [
    "DEFAULT_NUM_BUCKETS",
    "FleetRouter",
    "FleetSwapError",
    "FleetSwapper",
    "LocalReplicaClient",
    "NoLiveReplicaError",
    "ReplicaEngine",
    "ReplicaServer",
    "ReplicaUnavailableError",
    "ServeShardPlan",
    "StaleGenerationError",
    "TcpReplicaClient",
    "build_fleet_stores",
    "is_fleet_dir",
    "load_fleet_meta",
    "replica_store_dir",
]
