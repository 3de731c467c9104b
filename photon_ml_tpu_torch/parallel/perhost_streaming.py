"""Per-host streaming coordinate descent (port of
photon_ml_tpu/parallel/perhost_streaming.py).

The single-host streaming coordinate (algorithm/streaming_random_effect.py)
holds one entity block resident at a time; the in-memory multihost path
(perhost_ingest.py) splits entities over ranks. This module joins them with
**owner-computes random-effect solves over a globally agreed entity
blocking**:

  1. every rank derives the same entity blocking from the merged
     per-entity counts (:func:`plan_entity_blocks`, the exact single-host
     blocking, so a block's entities do not depend on the rank count);
  2. whole blocks go to ranks by the deterministic balanced packing
     (``shuffle.balanced_owners_over_hosts`` over the blocks' costs);
  3. each rank's rows move once to their block's owner with one
     ``all_to_all`` (``shuffle.route_rows_to_hosts``), never again;
  4. the owner builds only its blocks through the single-host block
     pipeline (:func:`build_block_payload`, byte-identical block files) and
     streams them every update;
  5. scores stay with the rows' owners and merge with one exact reduction
     (:func:`merge_disjoint`), as the fixed effect's per-chunk partials do
     (optim/streaming.make_perhost_value_and_grad).

Every merge is exact: each element is written by one rank and every other
rank contributes ``-0.0``, the one float that adds to every ``x`` (``-0.0``
included) as ``x``, and ``MeshContext.sum`` adds the ranks' buffers in rank
order. Block composition, block bytes, the block solves and every merge
being exact, an N-rank run is bitwise the single-host streaming run on the
same chunk list and the same blocking (tests/test_torch_perhost_streaming.py).

The plan's re-plan methods (:meth:`EntityShardPlan.replan`,
:meth:`EntityShardPlan.moved_blocks`) are here as numpy functions of the
plan; the elastic session that calls them (``parallel/elastic.py``) is not
yet ported. A ``membership`` argument is any object with ``hosts``,
``binding`` and ``physical_owners`` (the JAX package's
``FleetMembership``); ``None`` is the identity over the ranks.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import types
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from photon_ml_tpu_torch.algorithm.streaming_random_effect import (
    SpilledREState,
    StreamingREManifest,
    StreamingRandomEffectCoordinate,
    build_block_payload,
    plan_entity_blocks,
    write_block_file,
)
from photon_ml_tpu_torch.data.game import GameData, HostFeatures, RandomEffectDataConfig
from photon_ml_tpu_torch.parallel.mesh import MeshContext
from photon_ml_tpu_torch.parallel.perhost_ingest import HostRows, _pad_to
from photon_ml_tpu_torch.parallel.shuffle import (
    balanced_owners_over_hosts,
    collective_max,
    collective_sum,
    route_rows_to_hosts,
)
from photon_ml_tpu_torch.types import real_dtype

Tensor = torch.Tensor

logger = logging.getLogger(__name__)

# fixed-width UTF-8 raw entity ids for the vocabulary agreement collective
# (the ingest exchange's format and limit)
RAW_ID_BYTES = 48

#: the fill of the entries a rank does not own in a disjoint merge
DISJOINT_FILL = -0.0


# ---------------------------------------------------------------------------
# exact cross-rank merges
# ---------------------------------------------------------------------------


def _enter_reduce(shape, processes: int, **extra) -> None:
    """The ``multihost.streaming_reduce`` fault site, fired before the
    collective (also at one rank) and retried under the I/O policy; the
    collective itself is never retried."""
    from photon_ml_tpu_torch import resilience
    from photon_ml_tpu_torch.resilience import faults

    resilience.call_with_retry(
        lambda: faults.inject("multihost.streaming_reduce", shape=tuple(shape),
                              processes=processes, **extra),
        resilience.current_config().io_policy, describe="streaming reduce")


def disjoint_fill(shape, dtype=None, device=None) -> Tensor:
    """A rank's buffer for a disjoint merge: every entry ``-0.0`` until the
    rank writes the entries it owns."""
    return torch.full(tuple(shape) if not isinstance(shape, int) else (shape,), DISJOINT_FILL,
                      dtype=dtype or real_dtype(), device=device)


def merge_disjoint(arr: Union[np.ndarray, Tensor], ctx: Optional[MeshContext],
                   num_processes: int) -> Union[np.ndarray, Tensor]:
    """Exact cross-rank sum of an array whose every element is written by
    at most one rank (``-0.0`` elsewhere): the fixed-order sum adds each
    value to ``-0.0``s, so the result is that value's bits at any rank
    count. A tensor comes back a tensor on its device, a numpy array a
    numpy array of its dtype (the float64 regularization terms keep their
    bits). Fault site ``multihost.streaming_reduce`` fires first."""
    _enter_reduce(arr.shape, num_processes)
    if isinstance(arr, Tensor):
        if num_processes <= 1:
            return arr.clone()
        return ctx.sum(arr)
    a = np.asarray(arr)
    if num_processes <= 1:
        return a.copy()
    return ctx.sum_np(a)


def merge_disjoint_devices(shards, ctx: MeshContext) -> np.ndarray:
    """The device form of :func:`merge_disjoint`. The JAX package merges
    per-device partials of one process over its local device mesh; the
    port runs one rank per device, so ``shards`` is ``(world, ...)``, rank
    ``r`` contributes ``shards[r]`` of its own copy, and the ranks' rows
    merge with the same fixed-order sum (bitwise the host fold of the same
    disjoint partials). A wrong leading shape raises; a world of one is the
    identity."""
    a = np.asarray(shards)
    n = ctx.num_devices
    if a.ndim < 1 or a.shape[0] != n:
        raise ValueError(f"merge_disjoint_devices wants one leading shard per mesh device: "
                         f"got shape {a.shape} on a {n}-device mesh")
    _enter_reduce(a.shape, n, path="device")
    if n == 1:
        return a[0].copy()
    return ctx.sum_np(np.ascontiguousarray(a[ctx.rank]))


def agree_entity_counts(raw_ids: Sequence[str], ctx: Optional[MeshContext],
                        num_processes: int = 1) -> Tuple[List[str], np.ndarray]:
    """The globally agreed ``(vocab, counts)``: the sorted union of every
    rank's raw entity ids (the ``sorted(set(...))`` vocabulary a
    single-host decode of all the data gives) and the merged (V,) int64
    per-entity row counts, the same on every rank. One all-gather of the
    unique ids and their counts, once a run."""
    uniq, counts = np.unique(np.asarray(list(raw_ids), dtype=object), return_counts=True)
    if num_processes <= 1:
        return [str(u) for u in uniq], counts.astype(np.int64)
    n_local = len(uniq)
    rows_max = max(int(collective_max(np.asarray([n_local], np.int64), ctx,
                                      num_processes)[0]), 1)
    raw_bytes = np.zeros((rows_max, RAW_ID_BYTES), np.uint8)
    cnt_pad = np.zeros((rows_max,), np.int32)
    for i, rid in enumerate(uniq):
        b = str(rid).encode("utf-8")
        if len(b) > RAW_ID_BYTES:
            raise ValueError(f"entity id {rid!r} exceeds {RAW_ID_BYTES} UTF-8 bytes")
        raw_bytes[i, : len(b)] = np.frombuffer(b, np.uint8)
    cnt_pad[:n_local] = counts.astype(np.int32)
    g_raw = ctx.concat(torch.from_numpy(raw_bytes.view(np.int32))).numpy()
    g_cnt = ctx.concat(torch.from_numpy(cnt_pad)).numpy()
    keep = g_cnt > 0
    all_ids = [bytes(row).rstrip(b"\x00").decode("utf-8")
               for row in np.ascontiguousarray(g_raw[keep]).view(np.uint8)]
    merged, inv = np.unique(np.asarray(all_ids, dtype=object), return_inverse=True)
    g_counts = np.bincount(inv, weights=g_cnt[keep].astype(np.float64),
                           minlength=len(merged)).astype(np.int64)
    return [str(u) for u in merged], g_counts


# ---------------------------------------------------------------------------
# the global plan (blocking + block -> owner rank)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _IdentityMembership:
    """One logical owner per rank, bound to itself (the JAX package's
    ``FleetMembership.initial``): what the plan sidecars record."""

    hosts: List[int]
    binding: Dict[int, int]

    @classmethod
    def initial(cls, num_hosts: int) -> "_IdentityMembership":
        return cls(list(range(num_hosts)), {h: h for h in range(num_hosts)})


@dataclasses.dataclass
class EntityShardPlan:
    """The agreed entity blocking and block -> owner assignment: a function
    of (counts, config, owner set) alone, so every rank derives the same
    plan with no collective. ``owners`` holds logical owner ids
    (``hosts=None``: the identity over ``range(num_processes)``); the
    blocking never depends on them, so :meth:`replan` keeps the blocks and
    re-runs only the owner packing."""

    blocks: List[np.ndarray]  # per block: sorted dense entity ids
    owners: np.ndarray  # (n_blocks,) int32 owner (logical) per block
    block_of_vocab: np.ndarray  # (V,) int32 owning block per entity, -1 absent
    num_entities: int  # present entities across all blocks
    num_processes: int
    version: int = 1
    hosts: Optional[List[int]] = None  # logical owner ids; None = identity
    block_costs: Optional[np.ndarray] = None  # (n_blocks,) int64 solve cost
    # fixed-effect chunk ownership (chunk c is input file c), versioned
    # with the plan; None on a plan that never attached chunks
    fe_chunk_owners: Optional[np.ndarray] = None  # (n_chunks,) int32 logical
    fe_chunk_costs: Optional[np.ndarray] = None  # (n_chunks,) int64 row cost

    @classmethod
    def build(cls, counts: np.ndarray, num_processes: int, *, global_dim: int,
              active_upper_bound: Optional[int] = None, block_entities: Optional[int] = None,
              memory_budget_bytes: Optional[int] = None, hosts: Optional[Sequence[int]] = None,
              version: int = 1, blocks: Optional[List[np.ndarray]] = None
              ) -> "EntityShardPlan":
        """``blocks`` (a delta retrain's pinned blocking,
        :func:`pin_prior_blocking`) replaces the counts' fresh blocking."""
        counts = np.asarray(counts)
        if blocks is None:
            blocks = plan_entity_blocks(counts, global_dim=global_dim,
                                        active_upper_bound=active_upper_bound,
                                        block_entities=block_entities,
                                        memory_budget_bytes=memory_budget_bytes)
        cap = active_upper_bound or (int(counts.max()) if counts.sum() else 1)
        # a block's cost is the active rows it solves; the min-heap packing
        # is RandomEffectIdPartitioner's at block granularity
        costs = np.asarray([int(np.minimum(counts[b], cap).sum()) for b in blocks], np.int64)
        host_list = (sorted(int(h) for h in hosts) if hosts is not None
                     else list(range(max(num_processes, 1))))
        owners = balanced_owners_over_hosts(costs, host_list)
        block_of = np.full(len(counts), -1, np.int32)
        for gi, ents in enumerate(blocks):
            block_of[ents] = gi
        return cls(blocks=blocks, owners=owners.astype(np.int32), block_of_vocab=block_of,
                   num_entities=int((counts > 0).sum()), num_processes=max(num_processes, 1),
                   version=int(version), hosts=host_list, block_costs=costs)

    def host_list(self) -> List[int]:
        return list(self.hosts) if self.hosts is not None else list(range(self.num_processes))

    def with_fe_chunks(self, chunk_costs: Sequence[int],
                       owners: Optional[Sequence[int]] = None) -> "EntityShardPlan":
        """Attach fixed-effect chunk ownership: the blocks' balanced packing
        over the per-chunk row counts, or the explicit ``owners`` a fresh
        run's decode used."""
        costs = np.asarray([int(c) for c in chunk_costs], np.int64)
        if owners is None:
            fe_owners = balanced_owners_over_hosts(costs, self.host_list())
        else:
            fe_owners = np.asarray([int(o) for o in owners], np.int32)
            if len(fe_owners) != len(costs):
                raise ValueError(f"FE chunk owners ({len(fe_owners)}) and costs ({len(costs)}) "
                                 "disagree on the chunk count")
        return dataclasses.replace(self, fe_chunk_owners=fe_owners.astype(np.int32),
                                   fe_chunk_costs=costs)

    def owned_fe_chunks(self, process_id: int, membership=None) -> List[int]:
        """The global FE chunk ids rank ``process_id`` holds under the plan.
        Raises for a plan without chunk ownership."""
        if self.fe_chunk_owners is None:
            raise ValueError("plan carries no FE chunk ownership (pre-FE-ownership sidecar) "
                             "— fall back to the physical host_file_share")
        phys = (self.fe_chunk_owners if membership is None
                else membership.physical_owners(self.fe_chunk_owners))
        return [c for c in range(len(phys)) if int(phys[c]) == process_id]

    def replan(self, hosts: Sequence[int], version: Optional[int] = None,
               observed_costs: Optional[Dict[int, float]] = None) -> "EntityShardPlan":
        """The same blocking over a new owner set: only the balanced owner
        packing re-runs. ``observed_costs`` (block id -> realized cost)
        replaces the row-count proxy for the blocks it covers."""
        if self.block_costs is None:
            raise ValueError("plan carries no block costs (pre-versioned sidecar) — cannot "
                             "re-plan; rebuild the manifest instead")
        host_list = sorted(int(h) for h in hosts)
        block_costs = self.block_costs
        if observed_costs:
            eff = np.asarray(block_costs, np.int64).copy()
            for g, c in observed_costs.items():
                g = int(g)
                if 0 <= g < len(eff) and c > 0:
                    # ceil: a small but hot block never rounds to 0
                    eff[g] = max(int(np.ceil(float(c))), 1)
            block_costs = eff
        owners = balanced_owners_over_hosts(block_costs, host_list)
        fe_owners = self.fe_chunk_owners
        if self.fe_chunk_costs is not None:
            fe_owners = balanced_owners_over_hosts(self.fe_chunk_costs,
                                                   host_list).astype(np.int32)
        return dataclasses.replace(
            self, owners=owners.astype(np.int32), hosts=host_list,
            version=self.version + 1 if version is None else int(version),
            block_costs=block_costs, fe_chunk_owners=fe_owners)

    def moved_blocks(self, new_plan: "EntityShardPlan", old_membership,
                     new_membership) -> List[Tuple[int, int, int]]:
        """``(block id, old physical owner, new physical owner)`` for every
        block whose process changes between two plan versions."""
        old_phys = old_membership.physical_owners(self.owners)
        new_phys = new_membership.physical_owners(new_plan.owners)
        return [(gi, int(old_phys[gi]), int(new_phys[gi])) for gi in range(len(self.owners))
                if old_phys[gi] != new_phys[gi]]

    @classmethod
    def from_sidecars(cls, dir_path: str) -> Optional["EntityShardPlan"]:
        """The whole plan from a manifest dir's sidecars (each block's
        sorted entity ids fall out of ``block_of_vocab``); None without a
        ``plan.json``."""
        meta, owners, block_of = load_plan_sidecars(dir_path)
        if meta is None:
            return None
        n_blocks = len(owners)
        present = np.nonzero(block_of >= 0)[0]
        order = present[np.argsort(block_of[present], kind="stable")]
        bounds = np.searchsorted(block_of[order], np.arange(n_blocks + 1))
        blocks = [np.sort(order[bounds[g]:bounds[g + 1]]).astype(np.int64)
                  for g in range(n_blocks)]
        fe_owners, fe_costs = meta.get("fe_chunk_owners"), meta.get("fe_chunk_costs")
        return cls(blocks=blocks, owners=owners.astype(np.int32),
                   block_of_vocab=block_of.astype(np.int32),
                   num_entities=int(meta["num_entities"]),
                   num_processes=int(meta.get("num_processes", 1)),
                   version=int(meta["version"]), hosts=[int(h) for h in meta["hosts"]],
                   block_costs=np.asarray(meta["block_costs"], np.int64),
                   fe_chunk_owners=(None if fe_owners is None
                                    else np.asarray(fe_owners, np.int32)),
                   fe_chunk_costs=(None if fe_costs is None
                                   else np.asarray(fe_costs, np.int64)))

    def owned_block_ids(self, process_id: int, membership=None) -> List[int]:
        phys = self.owners if membership is None else membership.physical_owners(self.owners)
        return [gi for gi in range(len(self.blocks)) if int(phys[gi]) == process_id]


def pin_prior_blocking(prior_plan: EntityShardPlan, prior_vocab: Sequence[str],
                       prior_rows: np.ndarray, vocab: Sequence[str], counts: np.ndarray,
                       dirty_raw, *, global_dim: int, active_upper_bound: Optional[int] = None,
                       block_entities: Optional[int] = None,
                       memory_budget_bytes: Optional[int] = None
                       ) -> Tuple[List[np.ndarray], List[str]]:
    """A delta retrain's blocking for a per-host streaming run: the prior
    plan's blocks pinned by ``retrain.delta.pin_prior_blocks``, the rule of
    the single-process delta build, with ``prior_rows`` the prior run's
    (V,) uncapped row counts by prior vocab id (:func:`load_plan_entity_rows`).
    A dirty pin that the fresh blocking would split outgrew its sizing and
    is re-blocked in its place (the single-process build re-blocks on the
    built slab's budget error, which a rank cannot see before the routing);
    the entities no pin holds are blocked afresh after the pins. Every rank
    gets the same blocking from the agreed counts. Returns (blocks, the
    statuses ``unchanged`` / ``dirty`` / ``new`` by block)."""
    from photon_ml_tpu_torch.retrain.delta import NEW, UNCHANGED, pin_prior_blocks

    counts = np.asarray(counts)
    prior_rows = np.asarray(prior_rows)
    fresh_kw = dict(global_dim=global_dim, active_upper_bound=active_upper_bound,
                    block_entities=block_entities, memory_budget_bytes=memory_budget_bytes)
    pinned, assigned, _ = pin_prior_blocks(
        [([prior_vocab[int(v)] for v in ents], int(prior_rows[ents].sum()))
         for ents in prior_plan.blocks], list(vocab), counts, dirty_raw)
    blocks: List[np.ndarray] = []
    statuses: List[str] = []
    for ent, status, _, _ in pinned:
        split = [ent]
        if status != UNCHANGED:
            sub = np.zeros_like(counts)
            sub[ent] = counts[ent]
            split = plan_entity_blocks(sub, **fresh_kw)
        blocks += split
        statuses += [status] * len(split)
    leftover = np.where(assigned, 0, counts)
    if leftover.any():
        fresh = plan_entity_blocks(leftover, **fresh_kw)
        blocks += fresh
        statuses += [NEW] * len(fresh)
    return blocks, statuses


# ---------------------------------------------------------------------------
# the plan sidecars (the JAX package's bytes: a relaunch reads them)
# ---------------------------------------------------------------------------


_PLAN_BLOCK_OF = "plan-block-of.npy"
_PLAN_OWNERS = "plan-owners.npy"
_PLAN_META = "plan.json"
# the agreed (V,) uncapped row counts: a delta retrain's unchanged-block
# test reads them (the plan's block costs are capped); not a JAX sidecar
_PLAN_ENTITY_ROWS = "plan-entity-rows.npy"


def _plan_array_sha(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(np.asarray(arr, np.int32)).tobytes()).hexdigest()


def write_plan_sidecars(dir_path: str, owners: np.ndarray, block_of: np.ndarray, *,
                        version: int, hosts: Sequence[int], binding: Dict[int, int],
                        block_costs: np.ndarray, num_entities: int, num_processes: int = 1,
                        fe_chunk_owners: Optional[np.ndarray] = None,
                        fe_chunk_costs: Optional[np.ndarray] = None) -> None:
    """The plan beside its blocks: the two routing arrays, then
    ``plan.json`` (version, owner set, binding, block costs and, when
    attached, the FE chunk ownership). Each file lands by tmp + rename;
    ``plan.json`` goes last and records the arrays' digests, so a crash
    between the renames reads as a torn plan, not a mixed one."""
    block_of = np.asarray(block_of, np.int32)
    owners = np.asarray(owners, np.int32)
    for name, arr in ((_PLAN_BLOCK_OF, block_of), (_PLAN_OWNERS, owners)):
        tmp_npy = os.path.join(dir_path, name + ".tmp.npy")
        np.save(tmp_npy, arr)
        os.replace(tmp_npy, os.path.join(dir_path, name))
    meta = {
        "version": int(version),
        "hosts": [int(h) for h in hosts],
        "binding": {str(h): int(p) for h, p in binding.items()},
        "block_costs": [int(c) for c in np.asarray(block_costs)],
        "num_entities": int(num_entities),
        "num_processes": int(num_processes),
        "owners_sha": _plan_array_sha(owners),
        "block_of_sha": _plan_array_sha(block_of),
    }
    if fe_chunk_owners is not None:
        meta["fe_chunk_owners"] = [int(o) for o in np.asarray(fe_chunk_owners)]
        meta["fe_chunk_costs"] = [int(c) for c in np.asarray(
            fe_chunk_costs if fe_chunk_costs is not None
            else np.zeros(len(meta["fe_chunk_owners"]), np.int64))]
    tmp = os.path.join(dir_path, _PLAN_META + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(dir_path, _PLAN_META))


def load_plan_sidecars(dir_path: str) -> Tuple[Optional[dict], np.ndarray, np.ndarray]:
    """(plan meta or None for a pre-versioned layout, owners, block_of); a
    torn commit (digests that disagree with the arrays) raises."""
    owners = np.load(os.path.join(dir_path, _PLAN_OWNERS))
    block_of = np.load(os.path.join(dir_path, _PLAN_BLOCK_OF))
    meta_path = os.path.join(dir_path, _PLAN_META)
    meta = None
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        want = meta.get("owners_sha")
        if want is not None and (want != _plan_array_sha(owners)
                                 or meta.get("block_of_sha") != _plan_array_sha(block_of)):
            raise ValueError(
                f"plan sidecars in {dir_path} are torn (array digests do not match "
                "plan.json) — a re-base crashed mid-commit; rebuild this host's manifest "
                "(supervised relaunch re-ingests)")
    return meta, owners, block_of


def attach_fe_chunks_to_sidecars(dir_path: str, fe_chunk_owners: Sequence[int],
                                 fe_chunk_costs: Sequence[int]) -> None:
    """Record fixed-effect chunk ownership into committed plan sidecars (a
    re-commit through :func:`write_plan_sidecars`): the manifest build
    commits the plan before the per-file row counts exist."""
    meta, owners, block_of = load_plan_sidecars(dir_path)
    if meta is None:
        raise ValueError(f"{dir_path} has pre-versioned plan sidecars (no plan.json) — FE "
                         "chunk ownership needs a versioned plan to ride in")
    write_plan_sidecars(
        dir_path, owners, block_of, version=int(meta["version"]),
        hosts=[int(h) for h in meta["hosts"]],
        binding={int(h): int(p) for h, p in meta["binding"].items()},
        block_costs=np.asarray(meta["block_costs"], np.int64),
        num_entities=int(meta["num_entities"]),
        num_processes=int(meta.get("num_processes", 1)),
        fe_chunk_owners=np.asarray([int(o) for o in fe_chunk_owners], np.int32),
        fe_chunk_costs=np.asarray([int(c) for c in fe_chunk_costs], np.int64))


# ---------------------------------------------------------------------------
# the per-host manifest (owned blocks of a global blocking)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PerHostStreamingManifest(StreamingREManifest):
    """A rank's slice of the global streaming layout: ``blocks`` lists only
    the blocks this rank owns (files named by global block index), while
    ``num_rows``, ``vocab`` and the plan sidecars describe the whole run.
    The streaming coordinate's block loop runs over it unchanged."""

    global_block_ids: List[int] = dataclasses.field(default_factory=list)
    num_blocks_total: int = 0
    num_entities_global: int = 0
    process_index: int = 0
    num_processes: int = 1
    plan_version: int = 1

    def plan_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(block_of_vocab, owners): the sidecars' logical owners."""
        return (np.load(os.path.join(self.dir, _PLAN_BLOCK_OF)),
                np.load(os.path.join(self.dir, _PLAN_OWNERS)))

    def physical_plan_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(block_of_vocab, owner process per block), the logical owners
        resolved through the sidecar's binding."""
        meta, owners, block_of = load_plan_sidecars(self.dir)
        if meta is None:
            return block_of, owners
        binding = {int(h): int(p) for h, p in meta["binding"].items()}
        table = np.full(max(binding) + 1, -1, np.int32)
        for h, p in binding.items():
            table[h] = p
        return block_of, table[owners.astype(np.int64)]


def write_plan_entity_rows(dir_path: str, counts: np.ndarray) -> None:
    """The run's agreed per-entity row counts beside the plan (tmp + rename)."""
    tmp_npy = os.path.join(dir_path, _PLAN_ENTITY_ROWS + ".tmp.npy")
    np.save(tmp_npy, np.asarray(counts, np.int64))
    os.replace(tmp_npy, os.path.join(dir_path, _PLAN_ENTITY_ROWS))


def load_plan_entity_rows(dir_path: str) -> Optional[np.ndarray]:
    """The counts :func:`write_plan_entity_rows` wrote; None when absent."""
    try:
        return np.load(os.path.join(dir_path, _PLAN_ENTITY_ROWS))
    except FileNotFoundError:
        return None


def commit_perhost_manifest(dir_path: str, metas: List[dict], base, *, owned_gids: Sequence[int],
                            owners: np.ndarray, block_of: np.ndarray, plan_version: int,
                            membership, block_costs: np.ndarray,
                            fe_chunk_owners: Optional[np.ndarray] = None,
                            fe_chunk_costs: Optional[np.ndarray] = None) -> None:
    """(Re)write a rank's ``manifest.json`` and plan sidecars atomically;
    ``base`` carries the run-wide fields (num_rows, vocab, ...)."""
    write_plan_sidecars(dir_path, owners, block_of, version=plan_version,
                        hosts=membership.hosts, binding=membership.binding,
                        block_costs=block_costs, num_entities=int(base.num_entities_global),
                        num_processes=int(base.num_processes), fe_chunk_owners=fe_chunk_owners,
                        fe_chunk_costs=fe_chunk_costs)
    manifest = dict(
        blocks=list(metas),
        num_rows=int(base.num_rows),
        global_dim=int(base.global_dim),
        vocab=list(base.vocab),
        random_effect_id=base.random_effect_id,
        feature_shard_id=base.feature_shard_id,
        ladder=base.ladder,
        global_block_ids=[int(g) for g in owned_gids],
        num_blocks_total=int(len(owners)),
        num_entities_global=int(base.num_entities_global),
        process_index=int(base.process_index),
        num_processes=int(base.num_processes),
        plan_version=int(plan_version),
    )
    with open(os.path.join(dir_path, "manifest.json.tmp"), "w") as f:
        json.dump(manifest, f)
    os.replace(os.path.join(dir_path, "manifest.json.tmp"),
               os.path.join(dir_path, "manifest.json"))


def build_perhost_streaming_manifest(
        rows: HostRows, config: RandomEffectDataConfig, out_dir: str,
        ctx: Optional[MeshContext] = None, num_processes: int = 1, process_id: int = 0,
        block_entities: Optional[int] = None, memory_budget_bytes: Optional[int] = None,
        bucketer=None, shared_vocab: Optional[List[str]] = None, tensor_cache=None,
        cache_key: Optional[str] = None, pin=None) -> PerHostStreamingManifest:
    """The per-host streaming ingest, collective: agree the vocabulary and
    counts, derive the plan, route this rank's rows to their block's owner
    and build only the owned blocks (atomic writes through the retry
    policy; fault site ``io.perhost_block_write``).

    ``rows.row_index`` must be dense global [0, N) ids. ``shared_vocab``
    skips the raw-id agreement when the dense entity space is already
    global. With a ``tensor_cache`` + ``cache_key`` (a key that carries the
    rank's shard scope) the owned-block directory is reused on a hit, agreed
    collectively: the routing below is a collective, so every rank rebuilds
    unless every rank hits. ``pin(vocab, counts)``
    (a delta retrain's :func:`pin_prior_blocking`, the same on every rank)
    gives the blocking in place of the counts' fresh one. The owners are the
    identity over the ranks: the elastic membership (and its per-block
    cache entries) is not yet ported."""
    from photon_ml_tpu_torch.compile import resolve_bucketer

    bucketer = resolve_bucketer(bucketer)
    if config.projector == "RANDOM":
        raise ValueError(
            "streaming random effects support INDEX_MAP/IDENTITY projectors (a shared RANDOM "
            "projection matrix would have to be replicated into every block; use the "
            "in-memory coordinate)")
    if tensor_cache is not None and cache_key is not None:
        hit = tensor_cache.get_dir(cache_key)
        miss_flags = collective_sum(np.asarray([0 if hit is not None else 1], np.int64), ctx,
                                    num_processes)
        if int(miss_flags[0]) == 0:
            return PerHostStreamingManifest.load(hit)
        if hit is not None:
            # a peer missed, so every rank rebuilds; this rank's entry holds
            # rows routed from the peers' old inputs: evict it first
            import shutil

            shutil.rmtree(hit, ignore_errors=True)

    # ---- agree the vocabulary and counts ---------------------------------
    if shared_vocab is not None:
        vocab = list(shared_vocab)
        varr = np.asarray(vocab, dtype=object)
        raw = np.asarray(rows.entity_raw_ids, dtype=object)
        dense = np.searchsorted(varr, raw)
        dense_c = np.clip(dense, 0, max(len(vocab) - 1, 0))
        if rows.num_rows and not (varr[dense_c] == raw).all():
            raise ValueError("shared_vocab does not cover this host's entity ids (the "
                             "vocabulary must be the sorted global id set)")
        dense = dense_c.astype(np.int64)
        local_counts = np.bincount(dense, minlength=len(vocab)).astype(np.int64)
        counts = collective_sum(local_counts, ctx, num_processes)
    else:
        vocab, counts = agree_entity_counts(rows.entity_raw_ids, ctx, num_processes)
        dense = np.searchsorted(np.asarray(vocab, dtype=object),
                                np.asarray(rows.entity_raw_ids, dtype=object)).astype(np.int64)

    # ---- the global row space (the scatter / gather contract) ------------
    local_meta = np.asarray([int(rows.row_index.max()) if rows.num_rows else -1], np.int64)
    g_max_row = int(collective_max(local_meta, ctx, num_processes)[0])
    n_global = int(collective_sum(np.asarray([rows.num_rows], np.int64), ctx,
                                  num_processes)[0])
    if g_max_row != n_global - 1:
        raise ValueError(f"row ids are not dense [0, N): max id {g_max_row} vs {n_global} "
                         "global rows — use global_row_layout / densify_row_ids first")
    i32_max = np.iinfo(np.int32).max
    if n_global > i32_max or len(vocab) > i32_max:
        # the exchange records narrow ids to int32: a wrapped id would read
        # as padding and drop its row
        raise ValueError(f"{n_global} rows / {len(vocab)} entities exceed the int32 id space "
                         "of the routing exchange; shard the input into multiple coordinates "
                         "or widen the exchange record format")

    # ---- the agreed plan --------------------------------------------------
    plan = EntityShardPlan.build(
        counts, num_processes, global_dim=rows.global_dim,
        active_upper_bound=config.active_upper_bound, block_entities=block_entities,
        memory_budget_bytes=memory_budget_bytes,
        blocks=pin(vocab, counts) if pin is not None else None)

    # ---- route rows to their block's owner --------------------------------
    host_data, row_to_global = _route_and_assemble(rows, dense, vocab, plan, plan.owners, config,
                                                   ctx, num_processes, process_id)

    def build(dir_path: str) -> None:
        _write_owned_blocks(dir_path, host_data, row_to_global, config, plan, vocab, counts,
                            bucketer, memory_budget_bytes, n_global, process_id)

    if tensor_cache is not None and cache_key is not None:
        from photon_ml_tpu_torch.resilience import RetryError

        try:
            return PerHostStreamingManifest.load(tensor_cache.build_dir(cache_key, build))
        except RetryError:
            pass  # the cache is unusable: the plain build below
    os.makedirs(out_dir, exist_ok=True)
    build(out_dir)
    return PerHostStreamingManifest.load(out_dir)


def _agree_padded_features(rows: HostRows, ctx: Optional[MeshContext],
                           num_processes: int) -> Tuple[np.ndarray, np.ndarray]:
    """This rank's (feat_idx, feat_val) padded to the collectively agreed
    record width: every rank packs the same width before an exchange."""
    k = int(collective_max(np.asarray([rows.feat_idx.shape[1] if rows.num_rows else 1],
                                      np.int64), ctx, num_processes)[0])
    k = max(k, 1)
    fi = (_pad_to(rows.feat_idx.astype(np.int32).T, k, -1).T
          if rows.feat_idx.shape[1] != k else rows.feat_idx.astype(np.int32))
    fv = (_pad_to(rows.feat_val.astype(np.float32).T, k, 0.0).T
          if rows.feat_val.shape[1] != k else rows.feat_val.astype(np.float32))
    return fi, fv


def _route_and_assemble(rows: HostRows, dense: np.ndarray, vocab: List[str],
                        plan: EntityShardPlan, phys_owners: np.ndarray,
                        config: RandomEffectDataConfig, ctx: Optional[MeshContext],
                        num_processes: int, process_id: int) -> Tuple[GameData, np.ndarray]:
    """Route this rank's rows to their entity's block owner and reassemble
    the received rows sorted by global row id, so the owner's data is the
    single-host dataset restricted to its entities (the same block bytes).
    Returns (rank-local GameData in the global dense entity space, local
    row -> global row id)."""
    dest_host = np.asarray(phys_owners)[plan.block_of_vocab[dense]].astype(np.int64)
    fi, fv = _agree_padded_features(rows, ctx, num_processes)
    int_payload = np.concatenate([rows.row_index.astype(np.int32)[:, None],
                                  dense.astype(np.int32)[:, None], fi], axis=1)
    flt_payload = np.concatenate([rows.labels.astype(np.float32)[:, None],
                                  rows.weights.astype(np.float32)[:, None],
                                  rows.offsets.astype(np.float32)[:, None], fv], axis=1)
    bi, bf = route_rows_to_hosts(dest_host, int_payload, flt_payload, ctx, num_processes,
                                 process_id)
    order = np.argsort(bi[:, 0], kind="stable")
    bi, bf = bi[order], bf[order]
    row_to_global = bi[:, 0].astype(np.int64)
    ofi, ofv = bi[:, 2:], bf[:, 3:]
    valid = ofi >= 0
    lens = valid.sum(axis=1).astype(np.int64)
    indptr = np.zeros(len(bi) + 1, np.int64)
    np.cumsum(lens, out=indptr[1:])
    feats = HostFeatures(indptr=indptr, indices=ofi[valid].astype(np.int32),
                         values=ofv[valid].astype(np.float32), dim=rows.global_dim)
    host_data = GameData(response=bf[:, 0].astype(np.float32),
                         offset=bf[:, 2].astype(np.float32),
                         weight=bf[:, 1].astype(np.float32),
                         ids={config.random_effect_id: bi[:, 1].astype(np.int32)},
                         id_vocabs={config.random_effect_id: list(vocab)},
                         shards={config.feature_shard_id: feats})
    return host_data, row_to_global


def _write_owned_blocks(dir_path: str, host_data: GameData, row_to_global: np.ndarray,
                        config: RandomEffectDataConfig, plan: EntityShardPlan, vocab: List[str],
                        counts: np.ndarray, bucketer, memory_budget_bytes: Optional[int],
                        n_global: int, process_id: int) -> None:
    from photon_ml_tpu_torch import resilience
    from photon_ml_tpu_torch.resilience import faults

    owned = plan.owned_block_ids(process_id)
    metas = []
    for gi in owned:
        payload = build_block_payload(host_data, config, plan.blocks[gi], bucketer=bucketer,
                                      memory_budget_bytes=memory_budget_bytes,
                                      label=f"block {gi}", row_to_global=row_to_global)

        def write_once(gi=gi, payload=payload):
            faults.inject("io.perhost_block_write", block=gi, process=process_id)
            return write_block_file(dir_path, f"block-{gi:05d}.npz", payload)

        metas.append(resilience.call_with_retry(
            write_once, resilience.current_config().io_policy,
            describe=f"per-host block {gi} write"))
        del payload
    write_plan_entity_rows(dir_path, counts)
    mem = _IdentityMembership.initial(plan.num_processes)
    base = types.SimpleNamespace(
        num_rows=int(n_global), global_dim=int(host_data.shards[config.feature_shard_id].dim),
        vocab=list(vocab), random_effect_id=config.random_effect_id,
        feature_shard_id=config.feature_shard_id,
        ladder=(f"{bucketer.base}:{bucketer.growth:g}" if bucketer else None),
        num_entities_global=int(plan.num_entities), process_index=int(process_id),
        num_processes=int(plan.num_processes))
    commit_perhost_manifest(
        dir_path, metas, base, owned_gids=owned, owners=plan.owners,
        block_of=plan.block_of_vocab, plan_version=plan.version, membership=mem,
        block_costs=(plan.block_costs if plan.block_costs is not None
                     else np.zeros(len(plan.blocks), np.int64)))


# ---------------------------------------------------------------------------
# per-host spilled state: files keyed by global block id
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PerHostSpilledREState(SpilledREState):
    """Per-host spilled coordinate state whose files are named by global
    block id (``coefs-g<gid>.npy``), and whose checkpoint reference carries
    the shapes by global id and the blocks written: a restore checks every
    owned block's shape and that every recorded file is still there."""

    global_ids: List[int] = dataclasses.field(default_factory=list)
    plan_version: int = 1

    def _path(self, i: int) -> str:
        return os.path.join(self.dir, f"coefs-g{int(self.global_ids[i]):05d}.npy")

    def __checkpoint_ref__(self) -> dict:
        return {
            "kind": "perhost_spilled_re_state",
            "dir": self.dir,
            "plan_version": int(self.plan_version),
            "shapes_by_gid": {str(int(g)): [int(x) for x in s]
                              for g, s in zip(self.global_ids, self.shapes)},
            "written_gids": [int(g) for i, g in enumerate(self.global_ids)
                             if os.path.exists(self._path(i))],
            "written": os.path.isdir(self.dir),
        }

    def __checkpoint_from_ref__(self, ref: dict) -> "PerHostSpilledREState":
        from photon_ml_tpu_torch.checkpoint import CheckpointRefError

        if ref.get("kind") == "spilled_re_state":
            raise CheckpointRefError(
                "checkpoint holds a positional (single-host) spill ref; per-host states are "
                "keyed by global block id — falling back to an older step or a fresh epoch")
        if ref.get("kind") != "perhost_spilled_re_state":
            raise CheckpointRefError(
                f"checkpoint ref kind {ref.get('kind')!r} is not a per-host spilled streaming "
                "state — coordinate types changed since the save")
        if int(ref.get("plan_version", 1)) != int(self.plan_version):
            logger.info("restoring per-host spilled state across a plan change (saved v%s, "
                        "restoring under v%s) — shapes re-validated per global block id",
                        ref.get("plan_version", 1), self.plan_version)
        shapes_by_gid = {int(g): tuple(int(x) for x in s)
                         for g, s in ref.get("shapes_by_gid", {}).items()}
        for g, s in zip(self.global_ids, self.shapes):
            want = shapes_by_gid.get(int(g))
            if want is not None and want != tuple(int(x) for x in s):
                raise CheckpointRefError(
                    f"block {g}: checkpoint shape {want} does not match this manifest's "
                    f"{tuple(s)} — the streaming blocks were rebuilt differently; refusing "
                    "to resume")
        if ref.get("written") and not os.path.isdir(ref["dir"]):
            raise CheckpointRefError(
                f"spilled coefficient dir {ref['dir']} referenced by this checkpoint no longer "
                "exists — restoring would silently zero trained coefficients; falling back to "
                "an older step")
        out = PerHostSpilledREState(dir=ref["dir"], shapes=list(self.shapes),
                                    global_ids=list(self.global_ids),
                                    plan_version=int(self.plan_version))
        written = {int(g) for g in ref.get("written_gids", [])}
        missing = [int(g) for i, g in enumerate(self.global_ids)
                   if int(g) in written and not os.path.exists(out._path(i))]
        if missing:
            raise CheckpointRefError(
                f"blocks {missing} had coefficients at save time but their files are missing "
                f"from {ref['dir']} — refusing to resume onto zeros")
        return out


# ---------------------------------------------------------------------------
# the coordinate (a drop-in for CoordinateDescent, as its single-host base)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PerHostStreamingRandomEffectCoordinate(StreamingRandomEffectCoordinate):
    """Entity-sharded streaming random-effect coordinate: the inherited
    block loop (prefetch pipeline, per-block solves, block-boundary drain
    points) runs over only the blocks this rank owns; ``score`` merges the
    ranks' scatters exactly and ``regularization_term`` folds the exactly
    merged per-block terms in global block order, so every rank holds the
    single-host value bit for bit. Updates need no collective: each
    entity's rows live with its coefficients. A solve schedule, the sparse
    race and the adaptive order run per owned block, as the plan gives
    them."""

    ctx: Optional[MeshContext] = None
    num_processes: int = 1
    # a rank's unowned score rows are -0.0 until the merge
    _SCORE_FILL = DISJOINT_FILL

    def __post_init__(self):
        super().__post_init__()
        if self.num_processes > 1 and self.ctx is None:
            raise ValueError("PerHostStreamingRandomEffectCoordinate needs a MeshContext to "
                             "merge scores across processes")
        m = self.manifest
        self._global_ids = list(getattr(m, "global_block_ids", None) or range(len(m.blocks)))
        self._blocks_total = int(getattr(m, "num_blocks_total", 0) or len(m.blocks))

    @property
    def num_entities(self) -> int:
        return int(getattr(self.manifest, "num_entities_global", 0)
                   or self.manifest.num_entities)

    def _ledger_gid(self, i: int) -> int:
        """Ledger key = global block id (valid wherever the block lives)."""
        return int(self._global_ids[i])

    def _make_state(self, dir_path: str) -> PerHostSpilledREState:
        return PerHostSpilledREState(dir=dir_path, shapes=list(self._shapes),
                                     global_ids=[int(g) for g in self._global_ids],
                                     plan_version=int(getattr(self.manifest, "plan_version", 1)))

    def _partial_payload(self, new_state, done_blocks, inner: Optional[dict] = None) -> dict:
        payload = super()._partial_payload(new_state, done_blocks, inner)
        # progress by global block id and plan version
        payload["meta"]["done_global_ids"] = [int(self._global_ids[i])
                                              for i in sorted(done_blocks)]
        payload["meta"]["plan_version"] = int(getattr(self.manifest, "plan_version", 1))
        return payload

    def _resume_done_locals(self, m: dict, active) -> set:
        if m.get("done_global_ids") is not None:
            local_of = {int(g): i for i, g in enumerate(self._global_ids)}
            done = {local_of[int(g)] for g in m["done_global_ids"] if int(g) in local_of}
            return done & set(active)
        return super()._resume_done_locals(m, active)

    def _resume_inner_ok(self, m: dict) -> bool:
        cur = int(getattr(self.manifest, "plan_version", 1))
        saved = m.get("plan_version")
        if saved is not None and int(saved) != cur:
            logger.info("dropping mid-chunk scheduler snapshot across plan change (saved v%s "
                        "-> v%s): the block re-solves whole, bitwise as the chunked resume",
                        saved, cur)
            return False
        return True

    def score(self, state) -> Tensor:
        return merge_disjoint(super().score(state), self.ctx, self.num_processes)

    def regularization_term(self, state) -> Tensor:
        from photon_ml_tpu_torch.optim.problem import _split_reg_weight

        l1, l2 = _split_reg_weight(self.regularization, None)
        terms = np.full(self._blocks_total, DISJOINT_FILL, np.float64)
        for i in range(len(self.manifest.blocks)):
            w = state.block(i)
            terms[self._global_ids[i]] = (l1 * float(np.sum(np.abs(w)))
                                          + 0.5 * l2 * float(np.sum(np.square(w))))
        merged = merge_disjoint(terms, self.ctx, self.num_processes)
        # the single-host coordinate's accumulation, in global block order
        acc = 0.0
        for gi in range(self._blocks_total):
            acc += float(merged[gi])
        return torch.tensor(acc, dtype=real_dtype(), device=self._device)


# ---------------------------------------------------------------------------
# validation / inference row routing against per-host streaming models
# ---------------------------------------------------------------------------


def score_routed_rows_streaming(manifest: PerHostStreamingManifest,
                                means_by_raw_id: Dict[str, np.ndarray], rows: HostRows,
                                num_rows_out: int, ctx: Optional[MeshContext],
                                num_processes: int = 1, process_id: int = 0) -> np.ndarray:
    """Score rows THIS rank ingested against entity models owned by any
    rank: each row goes to its entity's block owner (the plan sidecars name
    it), the owner dots it with its back-projected entity means, and the
    partials merge exactly (each output row written by one rank). Cold
    entities and features add 0 (RandomEffectModel.scala:129-158). Returns
    the (num_rows_out,) float32 scores, the same on every rank."""
    if num_rows_out > np.iinfo(np.int32).max:
        raise ValueError(f"{num_rows_out} scoring rows exceed the int32 id space of the "
                         "routing exchange; shard the scoring pass")
    block_of, owners = manifest.physical_plan_arrays()
    varr = np.asarray(manifest.vocab, dtype=object)
    raw = np.asarray(rows.entity_raw_ids, dtype=object)
    pos = np.searchsorted(varr, raw) if len(varr) else np.zeros(len(raw), np.int64)
    pos_c = np.clip(pos, 0, max(len(varr) - 1, 0))
    known = (varr[pos_c] == raw) if len(varr) else np.zeros(len(raw), bool)
    sel = np.nonzero(known)[0]
    dest = owners[block_of[pos_c[sel]]].astype(np.int64)
    fi_p, fv_p = _agree_padded_features(rows, ctx, num_processes)
    int_payload = np.concatenate([rows.row_index[sel].astype(np.int32)[:, None],
                                  pos_c[sel].astype(np.int32)[:, None], fi_p[sel]], axis=1)
    bi, bf = route_rows_to_hosts(dest, int_payload, fv_p[sel], ctx, num_processes, process_id)
    local = np.full(num_rows_out, DISJOINT_FILL, np.float32)
    if len(bi):
        # one means row per routed entity, then a batched (R, K) gather-dot
        uniq, inv = np.unique(bi[:, 1], return_inverse=True)
        w_rows = np.zeros((len(uniq), int(manifest.global_dim)), np.float32)
        have = np.zeros(len(uniq), bool)
        for j, de in enumerate(uniq):
            w = means_by_raw_id.get(str(varr[de]))
            if w is not None:
                w_rows[j] = np.asarray(w, np.float32)
                have[j] = True
        fi_r = bi[:, 2:]
        vals = w_rows[inv[:, None], np.maximum(fi_r, 0)]  # (R, K)
        contrib = np.sum(np.where(fi_r >= 0, vals * bf, 0.0), axis=1) * have[inv]
        # each routed row is owned once: a plain scatter
        local[bi[:, 0]] = contrib.astype(np.float32)
    return np.asarray(merge_disjoint(local, ctx, num_processes), np.float32)
