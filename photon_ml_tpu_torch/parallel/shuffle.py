"""The collective shuffle: per-host ingest without a replicated build (port
of photon_ml_tpu/parallel/shuffle.py).

Spark's multi-host ingest decodes each executor's own partitions, then
``partitionBy``/``groupByKey`` SHUFFLES rows so each entity's samples land
on the partition that owns the entity (RandomEffectDataSet.scala:219-307,
balanced by RandomEffectIdPartitioner.scala:29-97). Here the same three
steps are

  1. **count exchange** — each rank bucket-hashes only ITS entity ids and
     one collective sum merges the ``(B,)`` bucket-count vectors;
  2. **balanced assignment** — every rank runs the same greedy min-heap
     packing over the identical global counts, so the entity -> rank owner
     map is agreed without any rank seeing another's rows;
  3. **row exchange** — rows are packed into fixed-width records and moved
     with one ``all_to_all`` over the process group.

Keys, priorities, buckets and owner maps are the JAX package's values, and
the records keep its layout, so each rank receives the rows the JAX
package's device of the same index receives. A collective that fails
raises (``mesh.CollectiveError``): there is no process-local fallback.
"""

from __future__ import annotations

import dataclasses
import hashlib
import heapq
from typing import List, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.parallel.mesh import MeshContext

# sentinel record id marking padding records in exchange buffers
_PAD = -1


# ---------------------------------------------------------------------------
# stable hashing (must agree across processes; python's hash() does not)
# ---------------------------------------------------------------------------


def stable_entity_key(raw_id: str) -> int:
    """64-bit stable key for a raw entity id: blake2b truncated to 8 bytes
    (process-stable, genuinely 64-bit; colliding entities would be merged
    by the grouping, so a 32-bit key would be a correctness hazard)."""
    return int.from_bytes(hashlib.blake2b(raw_id.encode("utf-8"), digest_size=8).digest(),
                          "big")


def stable_entity_keys(raw_ids: Sequence[str]) -> np.ndarray:
    """(n,) uint64 stable keys."""
    return np.fromiter((stable_entity_key(r) for r in raw_ids), np.uint64, count=len(raw_ids))


def stable_row_priority(keys: np.ndarray, row_index: np.ndarray) -> np.ndarray:
    """Partitioning-invariant pseudo-random priority per row, for the
    active-set reservoir cap (RandomEffectDataSet.scala:246-307): the kept
    set depends only on (entity, global row), never on which host ingested
    the row or in what order."""
    mix = (keys.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) ^ (
        row_index.astype(np.uint64) * np.uint64(0xC2B2AE3D27D4EB4F))
    mix ^= mix >> np.uint64(33)
    mix *= np.uint64(0xFF51AFD7ED558CCD)
    mix ^= mix >> np.uint64(33)
    return mix


def bucket_of(keys: np.ndarray, num_buckets: int) -> np.ndarray:
    """(n,) int64 bucket per key (num_buckets should be a power of two)."""
    return (keys & np.uint64(num_buckets - 1)).astype(np.int64)


# ---------------------------------------------------------------------------
# small collective reductions of host-side vectors
# ---------------------------------------------------------------------------


def collective_sum(vec, ctx: MeshContext, num_processes: int) -> np.ndarray:
    """Sum a per-host vector across hosts (the fixed-order sum; exact for
    integers). Single-process, the local vector IS the reduction."""
    vec = np.asarray(vec)
    if num_processes <= 1:
        return vec.copy()
    return ctx.sum_np(vec)


def collective_max(vec, ctx: MeshContext, num_processes: int) -> np.ndarray:
    """Elementwise max of a per-host vector across hosts (exact)."""
    vec = np.asarray(vec)
    if num_processes <= 1:
        return vec.copy()
    return ctx.max_np(vec)


# ---------------------------------------------------------------------------
# balanced bucket -> device assignment (RandomEffectIdPartitioner analogue)
# ---------------------------------------------------------------------------


def balanced_bucket_owners(global_counts: np.ndarray, num_devices: int) -> np.ndarray:
    """(B,) int32 owner device per bucket: greedy min-heap packing of
    buckets (heaviest first) onto the least-loaded device
    (RandomEffectIdPartitioner.scala:64-97 at bucket granularity).
    Deterministic from the identical summed counts."""
    owners = np.zeros(len(global_counts), np.int32)
    heap = [(0, d) for d in range(num_devices)]
    heapq.heapify(heap)
    for b in np.argsort(-global_counts, kind="stable"):
        load, d = heapq.heappop(heap)
        owners[b] = d
        heapq.heappush(heap, (load + int(global_counts[b]), d))
    return owners


def balanced_owners_over_hosts(costs: np.ndarray, hosts: Sequence[int]) -> np.ndarray:
    """(B,) int32 owner host id per block over an explicit host-id set: the
    same packing as :func:`balanced_bucket_owners` onto the sorted ids."""
    host_ids = np.asarray(sorted(int(h) for h in hosts), np.int32)
    if len(host_ids) == 0:
        raise ValueError("cannot assign block owners over an empty host set")
    return host_ids[balanced_bucket_owners(np.asarray(costs), len(host_ids))]


# ---------------------------------------------------------------------------
# the row exchange (all_to_all over the process group)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ExchangeResult:
    """Rows received by THIS host's devices after the shuffle: one
    ``(r, Wi)`` int32 and one ``(r, Wf)`` float32 block per local device
    (one device per process, so one of each)."""

    int_rows: List[np.ndarray]
    float_rows: List[np.ndarray]


def exchange_rows(dest_device: np.ndarray, int_payload: np.ndarray,
                  float_payload: np.ndarray, ctx: MeshContext, num_processes: int,
                  process_id: int) -> ExchangeResult:
    """Move each packed row to its destination rank with one all_to_all.

    ``int_payload[:, 0]`` must be a non-negative record id (it doubles as
    the padding sentinel). Send blocks are padded to the global max per
    (sender, dest) cell, agreed with one collective max, so every block of
    the all_to_all has one shape. Received rows come sender by sender, in
    each sender's order."""
    n = dest_device.shape[0]
    n_dev = ctx.num_devices
    wi, wf = int_payload.shape[1], float_payload.shape[1]
    if int_payload.shape[0] != n or float_payload.shape[0] != n:
        raise ValueError(f"{n} destinations for {int_payload.shape[0]} int and "
                         f"{float_payload.shape[0]} float records")
    dest = dest_device.astype(np.int64)
    # rank of each row within its destination's rows, in ingest order
    order = np.argsort(dest, kind="stable")
    rank_in_dest = np.empty(n, np.int64)
    starts = np.searchsorted(dest[order], np.arange(n_dev), side="left")
    rank_in_dest[order] = np.arange(n) - starts[dest[order]]
    counts = np.bincount(dest, minlength=n_dev).astype(np.int64)
    m = max(int(collective_max(counts, ctx, num_processes).max()), 1)

    ints = np.full((n_dev, m, wi), _PAD, np.int32)
    flts = np.zeros((n_dev, m, wf), np.float32)
    ints[dest, rank_in_dest] = int_payload.astype(np.int32)
    flts[dest, rank_in_dest] = float_payload.astype(np.float32)
    got_i = ctx.all_to_all(torch.from_numpy(ints)).numpy()
    got_f = ctx.all_to_all(torch.from_numpy(flts)).numpy()
    keep = got_i[:, :, 0] != _PAD
    return ExchangeResult(int_rows=[got_i[keep]], float_rows=[got_f[keep]])


def route_rows_to_hosts(dest_host: np.ndarray, int_payload: np.ndarray,
                        float_payload: np.ndarray, ctx: MeshContext, num_processes: int,
                        process_id: int) -> Tuple[np.ndarray, np.ndarray]:
    """Move packed rows to their owner host with the same exchange (one
    device per host, so the owner host IS the destination rank). Fault site
    ``multihost.entity_route`` fires before the collective, also
    single-process. Row order of the result is unspecified: callers sort by
    their record id."""
    from photon_ml_tpu_torch.resilience import faults

    faults.inject("multihost.entity_route", process=process_id, rows=int(len(dest_host)))
    if num_processes <= 1:
        return int_payload.astype(np.int32), float_payload.astype(np.float32)
    ex = exchange_rows(dest_host, int_payload, float_payload, ctx, num_processes, process_id)
    return ex.int_rows[0], ex.float_rows[0]
