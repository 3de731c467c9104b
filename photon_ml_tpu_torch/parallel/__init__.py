"""Distributed execution layer: the process-group mesh, its collectives, the
collective shuffle, per-host ingest, the distributed fixed-effect solver
and the per-host random-effect solvers (port of photon_ml_tpu/parallel/).

The reference's Spark substrate (SURVEY.md §5.8) maps onto a
``torch.distributed`` process group with one rank per device:

  treeAggregate       -> a fixed-order sum of per-rank partials (mesh.py)
  broadcast           -> coefficients replicated on every rank
  partitionBy/join    -> balanced entity -> rank owners agreed at ingest
  groupByKey shuffle  -> one all_to_all of fixed-width records (shuffle.py)
  driver / executors  -> SPMD per-host ingest (perhost_ingest.py)
  spill to disk       -> per-host streaming entity blocks (perhost_streaming.py)

The JAX package's single-process entity-sharded solvers
(``DistributedRandomEffectSolver``,
``DistributedFactoredRandomEffectCoordinate``, the coordinates'
``mesh_ctx``) split one process's dataset over its devices; the port runs
one process per device, and their work is the per-host solvers'.

Not yet ported: ``elastic`` (membership changes, relaunch re-plans, the
fleet), which re-plans the ``EntityShardPlan`` and the plan sidecars that
``perhost_streaming`` writes.
"""

from photon_ml_tpu_torch.parallel import multihost, shuffle
from photon_ml_tpu_torch.parallel.distributed import DistributedFixedEffectSolver
from photon_ml_tpu_torch.parallel.mesh import MeshContext, data_mesh, pad_leading, pad_rows
from photon_ml_tpu_torch.parallel.perhost_ingest import (
    BucketedShardedREData,
    HostRows,
    PerHostBucketedRandomEffectSolver,
    PerHostRandomEffectSolver,
    REBucketSlabs,
    ShardedREData,
    densify_row_ids,
    local_shards,
    per_host_re_dataset,
)
from photon_ml_tpu_torch.parallel.perhost_streaming import (
    EntityShardPlan,
    PerHostSpilledREState,
    PerHostStreamingManifest,
    PerHostStreamingRandomEffectCoordinate,
    build_perhost_streaming_manifest,
    merge_disjoint,
    merge_disjoint_devices,
)

__all__ = [
    "MeshContext",
    "data_mesh",
    "pad_rows",
    "pad_leading",
    "multihost",
    "shuffle",
    "DistributedFixedEffectSolver",
    "BucketedShardedREData",
    "HostRows",
    "PerHostBucketedRandomEffectSolver",
    "PerHostRandomEffectSolver",
    "REBucketSlabs",
    "ShardedREData",
    "densify_row_ids",
    "local_shards",
    "per_host_re_dataset",
    "EntityShardPlan",
    "PerHostSpilledREState",
    "PerHostStreamingManifest",
    "PerHostStreamingRandomEffectCoordinate",
    "build_perhost_streaming_manifest",
    "merge_disjoint",
    "merge_disjoint_devices",
]
