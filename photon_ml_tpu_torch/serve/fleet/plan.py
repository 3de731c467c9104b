"""Serving shard plan: which fleet replica owns which entities (port of
photon_ml_tpu/serve/fleet/plan.py).

The training side already solved deterministic entity partitioning
(:mod:`photon_ml_tpu_torch.parallel.perhost_streaming`): hash entities into
stable buckets, cost the buckets, and bin-pack buckets onto owners with the
greedy balanced partitioner — every participant derives the identical
assignment from the same inputs with no coordination. The serving fleet
reuses exactly that machinery
(:func:`~photon_ml_tpu_torch.parallel.shuffle.stable_entity_keys` /
:func:`~photon_ml_tpu_torch.parallel.shuffle.bucket_of` /
:func:`~photon_ml_tpu_torch.parallel.shuffle.balanced_bucket_owners`) so:

  * the router maps a request's raw entity id -> bucket -> owner replica
    with two array lookups and zero model state (a thin router — it never
    opens a slab or a feature map);
  * the export side (:func:`build_fleet_stores`) filters each replica's
    store to exactly the entities the router will send it;
  * the plan is a small explicit placement object that travels in
    ``fleet.json`` and is validated on swap — a new model generation must
    carry the identical plan, or routing and slab ownership would silently
    diverge.

The stores and ``fleet.json`` are the JAX package's bytes, so each package
opens the other's fleet. Ownership is per bucket, not per replica modulo,
so a re-shard moves only the buckets whose owner changed.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np

from photon_ml_tpu_torch.parallel.shuffle import (
    balanced_bucket_owners,
    bucket_of,
    stable_entity_keys,
)

#: default bucket count: plenty of granularity for balanced packing at
#: small fleet sizes while keeping the plan object tiny
DEFAULT_NUM_BUCKETS = 64

FLEET_META_FILE = "fleet.json"
FLEET_FORMAT = "game-serve-fleet"
FLEET_VERSION = 1
REPLICA_DIR_FMT = "replica-{r}"


@dataclasses.dataclass(frozen=True)
class ServeShardPlan:
    """bucket -> owner replica, derived deterministically from the model's
    entity population (counts per bucket) alone."""

    num_replicas: int
    num_buckets: int
    owners: np.ndarray  # (num_buckets,) int32 owner replica per bucket

    @classmethod
    def build(
        cls,
        entity_ids: List[str],
        num_replicas: int,
        num_buckets: int = DEFAULT_NUM_BUCKETS,
    ) -> "ServeShardPlan":
        """Plan from the model's entity ids (union across coordinates):
        bucket-count the population, then balanced bin-packing of buckets
        onto replicas — identical on every builder for identical inputs."""
        if num_replicas < 1:
            raise ValueError(f"num_replicas must be >= 1, got {num_replicas}")
        if num_buckets < num_replicas:
            raise ValueError(
                f"num_buckets ({num_buckets}) must be >= num_replicas "
                f"({num_replicas})"
            )
        counts = np.zeros(num_buckets, np.int64)
        if entity_ids:
            buckets = bucket_of(stable_entity_keys(entity_ids), num_buckets)
            counts += np.bincount(buckets, minlength=num_buckets)
        owners = balanced_bucket_owners(counts, num_replicas)
        return cls(
            num_replicas=num_replicas,
            num_buckets=num_buckets,
            owners=owners.astype(np.int32),
        )

    # -- routing -------------------------------------------------------------
    def bucket_of_raw(self, raw_id: str) -> int:
        return int(bucket_of(stable_entity_keys([str(raw_id)]), self.num_buckets)[0])

    def owner_of(self, raw_id: Optional[str]) -> int:
        """Owner replica of an entity id; -1 for a row with no id (its
        random-effect contribution is 0 wherever it is computed)."""
        if raw_id is None:
            return -1
        return int(self.owners[self.bucket_of_raw(raw_id)])

    def owners_of(self, raw_ids: List[Optional[str]]) -> np.ndarray:
        """(n,) int32 owner per raw id (-1 for None) — the vectorized form
        the router uses per request batch."""
        out = np.full(len(raw_ids), -1, np.int32)
        present = [i for i, r in enumerate(raw_ids) if r is not None]
        if present:
            ids = [str(raw_ids[i]) for i in present]
            owned = self.owners[bucket_of(stable_entity_keys(ids), self.num_buckets)]
            out[np.asarray(present)] = owned
        return out

    # -- (de)serialization ---------------------------------------------------
    def to_json(self) -> dict:
        return {
            "num_replicas": self.num_replicas,
            "num_buckets": self.num_buckets,
            "owners": [int(o) for o in self.owners],
        }

    @classmethod
    def from_json(cls, obj: dict) -> "ServeShardPlan":
        owners = np.asarray(obj["owners"], np.int32)
        if len(owners) != int(obj["num_buckets"]):
            raise ValueError(
                f"plan owners length {len(owners)} != num_buckets "
                f"{obj['num_buckets']}"
            )
        return cls(
            num_replicas=int(obj["num_replicas"]),
            num_buckets=int(obj["num_buckets"]),
            owners=owners,
        )

    def same_assignment(self, other: "ServeShardPlan") -> bool:
        """True when routing under ``self`` and ``other`` is identical —
        the fleet-swap compatibility requirement (a plan change means slabs
        moved; that is a re-shard, not a swap)."""
        return (
            self.num_replicas == other.num_replicas
            and self.num_buckets == other.num_buckets
            and bool(np.array_equal(self.owners, other.owners))
        )


def replica_store_dir(fleet_dir: str, replica: int) -> str:
    return os.path.join(fleet_dir, REPLICA_DIR_FMT.format(r=replica))


def build_fleet_stores(
    model_dir: str,
    fleet_dir: str,
    num_replicas: int,
    num_buckets: int = DEFAULT_NUM_BUCKETS,
    bucketer=None,
    num_partitions: int = 1,
    force_python: bool = False,
    store_dtype: str = "f32",
) -> dict:
    """Export one saved GAME model into ``num_replicas`` sharded serving
    stores plus a ``fleet.json`` plan.

    The model is read once; each replica store is the bytes
    ``build_model_store(..., entity_filter=)`` writes for its entities.

    Replica r's store (``<fleet_dir>/replica-r/``) carries the FULL feature
    index and fixed-effect vectors (replicated — any replica can compute a
    fixed contribution) and only the random-effect slab rows of the
    entities the plan assigns to r. The union of the replica slabs is
    exactly the single-store export, partitioned disjointly.

    ``store_dtype`` applies to EVERY replica store (the one dial for the
    whole fleet, recorded in ``fleet.json``): a mixed-dtype fleet would
    give requests different error characteristics depending on which
    replica owns their entity, so :func:`load_fleet_meta` refuses one
    loudly.
    """
    from photon_ml_tpu_torch.serve.model_store import build_model_stores

    plans = []

    def replica_filters(all_ids):
        # the plan costs buckets over the entity population (union across
        # RE coordinates); ONE vectorized ownership pass, then the
        # per-replica filter is a set probe per record
        plan = ServeShardPlan.build(all_ids, num_replicas, num_buckets)
        plans.append(plan)
        owners = plan.owners_of(all_ids)
        return {replica_store_dir(fleet_dir, r):
                frozenset(i for i, o in zip(all_ids, owners) if o == r).__contains__
                for r in range(num_replicas)}

    metas = build_model_stores(model_dir, replica_filters, num_partitions, bucketer,
                               force_python, store_dtype)
    plan = plans[0]
    os.makedirs(fleet_dir, exist_ok=True)
    replica_meta: List[dict] = []
    # fleet-wide pinned quantization budget per coordinate: the MAX of the
    # replica slabs' realized/budget errors (a request's entity lives on
    # exactly one replica, so the worst replica bounds every score)
    fleet_quant: Dict[str, dict] = {}
    for r, meta in enumerate(metas.values()):
        for e in meta["random"]:
            q = e.get("quantization") or {}
            agg = fleet_quant.setdefault(
                e["name"],
                {"realized_max_abs_coeff_err": 0.0, "coeff_err_budget": 0.0},
            )
            for k in agg:
                agg[k] = max(agg[k], float(q.get(k) or 0.0))
        replica_meta.append(
            {
                "replica": r,
                "store_dir": os.path.abspath(replica_store_dir(fleet_dir, r)),
                "entities": {e["name"]: e["entities"] for e in meta["random"]},
            }
        )
    # coordinate order comes from the LAST store meta — every replica store
    # lists the same coordinates in the same order (same source model)
    fleet_meta = {
        "format": FLEET_FORMAT,
        "version": FLEET_VERSION,
        "source_model_dir": os.path.abspath(model_dir),
        "store_dtype": store_dtype,
        "task": meta["task"],
        "plan": plan.to_json(),
        "fixed": meta["fixed"],
        "random": [
            {
                "name": e["name"],
                "re_id": e["re_id"],
                "shard": e["shard"],
                "quantization": fleet_quant[e["name"]],
            }
            for e in meta["random"]
        ],
        "replicas": replica_meta,
    }
    tmp = os.path.join(fleet_dir, FLEET_META_FILE + ".tmp")
    with open(tmp, "w") as f:
        json.dump(fleet_meta, f, indent=1)
    os.replace(tmp, os.path.join(fleet_dir, FLEET_META_FILE))
    return fleet_meta


def is_fleet_dir(path: str) -> bool:
    try:
        with open(os.path.join(path, FLEET_META_FILE)) as f:
            return json.load(f).get("format") == FLEET_FORMAT
    except (OSError, ValueError):
        return False


def load_fleet_meta(fleet_dir: str) -> dict:
    """Read + validate ``fleet.json``. A mixed-dtype fleet (replica store
    metas disagreeing with the fleet's ``store_dtype``) is refused HERE,
    loudly — per-request error characteristics must not depend on which
    replica owns the entity. Replica stores whose meta is unreadable from
    this host are skipped (the replica process re-validates its own store
    against this value at startup)."""
    with open(os.path.join(fleet_dir, FLEET_META_FILE)) as f:
        meta = json.load(f)
    if meta.get("format") != FLEET_FORMAT:
        raise IOError(f"{fleet_dir} is not a {FLEET_FORMAT} directory")
    fleet_dtype = meta.get("store_dtype") or "f32"
    mixed = []
    for rep in meta.get("replicas") or []:
        try:
            with open(os.path.join(rep["store_dir"], "meta.json")) as rf:
                rep_dtype = json.load(rf).get("store_dtype") or "f32"
        except (OSError, ValueError, KeyError):
            continue  # remote/missing replica store: its process validates
        if rep_dtype != fleet_dtype:
            mixed.append(f"replica {rep.get('replica')}: {rep_dtype}")
    if mixed:
        raise IOError(
            f"{fleet_dir} is a MIXED-DTYPE fleet (fleet.json says "
            f"{fleet_dtype!r} but {'; '.join(mixed)}); refusing to route — "
            "re-export the whole fleet at one store_dtype"
        )
    return meta
