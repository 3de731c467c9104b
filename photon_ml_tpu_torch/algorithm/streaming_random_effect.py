"""Out-of-core random-effect coordinate: entity-block streaming (port of
photon_ml_tpu/algorithm/streaming_random_effect.py, single host).

The reference trains random-effect datasets larger than memory by spilling
the grouped per-entity datasets to disk (StorageLevel.scala:22-24,
CoordinateDescent.scala:134-147) and streaming them back on every pass.
Here the entity-major stacks are written once to disk as entity blocks,
each built and released in turn, and every update or scoring pass streams
one block at a time through the lane-batched solve: the device holds one
block (two while the next one's copy is in flight). Coefficients are
spilled to per-block ``.npy`` files between updates, so the coordinate's
state is a directory handle (:class:`SpilledREState`), which a checkpoint
stores by reference.

Entities are sorted by row count before blocking, so each block pads only
to its own largest entity. For the same counts and budget the block layout
is the JAX package's: the same entity assignment, padded shapes and
manifest.

Blocks move through io/pipeline.py: a background thread reads up to
``prefetch_depth`` blocks ahead, and on the card the next block is copied
from pinned memory on a side stream while the current one solves. A sparse
spec builds each block's slab on its first visit, races it under ``auto``
(the recorded winners are reused, as for buckets), and keeps it, with its
column tables, on the host: later epochs upload it with the block, so the
device never accumulates slabs. With a ``solve_schedule`` every block's
solve is convergence-compacted (optim/scheduler.py); with an ``adaptive``
schedule, blocks under tolerance for ``patience`` epochs are skipped, each
skip a recorded decision, and the convergence ledger is a sidecar file.
Block boundaries are preemption drain points (site ``"block"``).

``frozen_blocks`` (the delta retrain's unchanged blocks, retrain/delta.py)
never solve: their coefficients carry forward bitwise from the warm-seeded
state, and their scores are computed once and cached. ``elastic`` (an
``ElasticMonitor`` of parallel/elastic.py, or anything with ``poll()``) is
polled at update entry, at every block boundary and at score entry; a
pending membership proposal unwinds with ``ReplanRequired`` carrying the
block progress by global id. ``initial_epoch`` is the epoch floor of a
coordinate rebuilt on a re-planned manifest: its spill dirs never collide
with the ones the checkpointed state still references.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.algorithm.bucketed_random_effect import _filter_game_data
from photon_ml_tpu_torch.algorithm.random_effect import (
    RandomEffectCoordinate,
    global_coefficients,
)
from photon_ml_tpu_torch.compile.plan import PlanDecision
from photon_ml_tpu_torch.data.game import (
    GameData,
    RandomEffectDataConfig,
    RandomEffectDataset,
    _np_real,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.ops import fused_sparse
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optim.common import OptimizerConfig, OptResult
from photon_ml_tpu_torch.optim.convergence import ConvergenceLedger
from photon_ml_tpu_torch.optim.problem import _split_reg_weight
from photon_ml_tpu_torch.optim.scheduler import solve_stats
from photon_ml_tpu_torch.resilience import faults, preemption
from photon_ml_tpu_torch.types import OptimizerType, TaskType, real_dtype

Tensor = torch.Tensor

_instance_seq = 0

_DATASET_FIELDS = RandomEffectDataset.TENSOR_FIELDS
# a block's host-resident slab, uploaded with the block (see _slab_for)
_SLAB_TABLES = ("lane_cols", "lane_slots", "cols", "col_end", "slots")


def plan_entity_blocks(counts: np.ndarray, *, global_dim: int,
                       active_upper_bound: Optional[int] = None,
                       block_entities: Optional[int] = None,
                       memory_budget_bytes: Optional[int] = None,
                       itemsize: Optional[int] = None) -> List[np.ndarray]:
    """The entity blocking as a function of the (V,) per-entity row counts:
    present entities sorted by count (stable), then cut every
    ``block_entities`` or where the padded x-stack estimate would pass the
    memory budget. Exactly one of the two is required."""
    counts = np.asarray(counts)
    n = int(counts.sum())
    present = np.nonzero(counts > 0)[0]
    order = present[np.argsort(counts[present], kind="stable")]
    cap = active_upper_bound or (int(counts.max()) if n else 1)
    active = np.minimum(counts[order], cap)
    if (block_entities is None) == (memory_budget_bytes is None):
        raise ValueError("exactly one of block_entities / memory_budget_bytes is required")
    itemsize = itemsize or np.dtype(_np_real()).itemsize
    blocks: List[np.ndarray] = []
    if block_entities is not None:
        for lo in range(0, len(order), block_entities):
            blocks.append(np.sort(order[lo: lo + block_entities]))
        return blocks
    if memory_budget_bytes <= 0:
        raise ValueError(f"memory_budget_bytes must be positive, got {memory_budget_bytes}")
    start = 0
    while start < len(order):
        end = start + 1
        while end < len(order):
            # padded x-stack estimate if [start, end] became one block; the
            # local dim is bounded by width * 64 and the shard's global dim
            width = int(active[end])
            est = (end - start + 1) * width * itemsize
            if est * min(global_dim, width * 64) > memory_budget_bytes:
                break
            end += 1
        blocks.append(np.sort(order[start:end]))
        start = end
    return blocks


def build_block_payload(data: GameData, config: RandomEffectDataConfig, entity_ids: np.ndarray,
                        bucketer=None, memory_budget_bytes: Optional[int] = None,
                        label: str = "block",
                        row_to_global: Optional[np.ndarray] = None) -> dict:
    """One entity block's on-disk payload (numpy), built through the same
    ``build_random_effect_dataset`` as the in-memory coordinate over only
    the block's rows, then padded up the ladder when a ``bucketer`` is
    given; the budget is checked on the padded x-stack."""
    from photon_ml_tpu_torch.compile import canonicalize_re_arrays

    re_id = config.random_effect_id
    ids = data.ids[re_id]
    row_sel = np.nonzero(np.isin(ids, entity_ids))[0]
    filtered = _filter_game_data(data, re_id, config.feature_shard_id, row_sel, entity_ids)
    ds = build_random_effect_dataset(filtered, config, device="cpu")
    payload = {f: getattr(ds, f).numpy() for f in _DATASET_FIELDS}
    if bucketer is not None:
        payload = canonicalize_re_arrays(payload, bucketer)
    if memory_budget_bytes is not None and payload["x"].nbytes > memory_budget_bytes:
        raise ValueError(
            f"{label}: x-stack {payload['x'].nbytes}B exceeds the "
            f"{memory_budget_bytes}B budget — lower active_upper_bound "
            "or raise the budget (one entity's slab must fit)"
        )
    row_global = row_sel if row_to_global is None else row_to_global[row_sel]
    payload["row_sel"] = np.asarray(row_global).astype(np.int64)
    payload["entity_ids"] = np.asarray(entity_ids).astype(np.int64)
    payload["dense_ids"] = filtered.ids[re_id].astype(np.int32)
    return payload


def write_block_file(out_dir: str, name: str, payload: dict) -> dict:
    """Atomically write one block payload; returns its manifest entry."""
    path = os.path.join(out_dir, name)
    with open(path + ".tmp", "wb") as f:
        np.savez(f, **payload)
    os.replace(path + ".tmp", path)
    return dict(
        file=name,
        # padded lane / local-dim counts: the shapes the solver and the
        # spilled coefficient stacks carry
        num_entities=int(payload["x"].shape[0]),
        local_dim=int(payload["x"].shape[2]),
        num_rows=int(len(payload["row_sel"])),
        x_bytes=int(payload["x"].nbytes),
    )


def write_streaming_manifest_json(out_dir: str, metas: List[dict], *, num_rows: int,
                                  global_dim: int, vocab: List[str], random_effect_id: str,
                                  feature_shard_id: str, ladder: Optional[str]) -> None:
    """Atomically commit a block directory's ``manifest.json``."""
    manifest = dict(blocks=metas, num_rows=int(num_rows), global_dim=int(global_dim),
                    vocab=list(vocab), random_effect_id=random_effect_id,
                    feature_shard_id=feature_shard_id, ladder=ladder)
    with open(os.path.join(out_dir, "manifest.json.tmp"), "w") as f:
        json.dump(manifest, f)
    os.replace(os.path.join(out_dir, "manifest.json.tmp"), os.path.join(out_dir, "manifest.json"))


def write_re_entity_blocks(data: GameData, config: RandomEffectDataConfig, out_dir: str,
                           block_entities: Optional[int] = None,
                           memory_budget_bytes: Optional[int] = None, tensor_cache=None,
                           cache_key: Optional[str] = None,
                           bucketer=None) -> "StreamingREManifest":
    """Split the random-effect dataset into entity blocks on disk; exactly
    one of ``block_entities`` / ``memory_budget_bytes`` sizes them. Each
    block is built over its own entities' rows, written and released: the
    full stack never exists.

    With a ``tensor_cache`` and ``cache_key`` the block directory is a cache
    entry, and a later call with the same key returns its manifest without
    building anything (``out_dir`` is then unused); a cache write that
    stays broken degrades to the plain build. With a ``bucketer`` every
    block's dims are padded up the ladder before writing, and the ladder is
    recorded in the manifest."""
    from photon_ml_tpu_torch.compile import resolve_bucketer
    from photon_ml_tpu_torch.resilience import RetryError

    bucketer = resolve_bucketer(bucketer)
    if tensor_cache is not None and cache_key is not None:
        hit = tensor_cache.get_dir(cache_key)
        if hit is not None:
            return StreamingREManifest.load(hit)
        try:
            entry = tensor_cache.build_dir(cache_key, lambda tmp: write_re_entity_blocks(
                data, config, tmp, block_entities=block_entities,
                memory_budget_bytes=memory_budget_bytes, bucketer=bucketer or "off"))
            return StreamingREManifest.load(entry)
        except RetryError:
            pass  # the cache is unusable: the plain build below
    if config.projector == "RANDOM":
        raise ValueError(
            "streaming random effects support INDEX_MAP/IDENTITY projectors "
            "(a shared RANDOM projection matrix would have to be replicated "
            "into every block; use the in-memory coordinate)"
        )
    re_id = config.random_effect_id
    ids = data.ids[re_id]
    n = data.num_rows
    counts = np.bincount(ids, minlength=int(ids.max()) + 1 if n else 0)
    global_dim = int(data.shards[config.feature_shard_id].dim)
    blocks = plan_entity_blocks(counts, global_dim=global_dim,
                                active_upper_bound=config.active_upper_bound,
                                block_entities=block_entities,
                                memory_budget_bytes=memory_budget_bytes)
    os.makedirs(out_dir, exist_ok=True)
    metas = []
    for i, entity_ids in enumerate(blocks):
        payload = build_block_payload(data, config, entity_ids, bucketer=bucketer,
                                      memory_budget_bytes=memory_budget_bytes,
                                      label=f"block {i}")
        metas.append(write_block_file(out_dir, f"block-{i:05d}.npz", payload))
        del payload
    write_streaming_manifest_json(
        out_dir, metas, num_rows=int(n), global_dim=global_dim,
        vocab=list(data.id_vocabs[re_id]), random_effect_id=re_id,
        feature_shard_id=config.feature_shard_id,
        ladder=(f"{bucketer.base}:{bucketer.growth:g}" if bucketer else None),
    )
    return StreamingREManifest.load(out_dir)


@dataclasses.dataclass
class BlockMeta:
    """One block's per-entity bookkeeping, without the data slab (the
    fields :func:`global_coefficients` reads, as tensors on ``device``)."""

    entity_pos: np.ndarray
    dense_ids: np.ndarray
    entity_ids: np.ndarray
    row_sel: np.ndarray
    local_to_global: Tensor
    global_dim: int
    projection_matrix = None


def _positions_of_dense(m: BlockMeta) -> np.ndarray:
    """Dense (block-local) entity id -> tensor position, -1 where absent;
    ladder pad rows beyond ``dense_ids`` are sliced off first."""
    entity_pos = m.entity_pos[: len(m.dense_ids)]
    known = entity_pos >= 0
    pos_of_dense = np.full(len(m.entity_ids), -1, np.int32)
    pos_of_dense[m.dense_ids[known]] = entity_pos[known]
    return pos_of_dense


@dataclasses.dataclass
class StreamingREManifest:
    """On-disk entity-block layout descriptor (``manifest.json``)."""

    dir: str
    blocks: List[dict]
    num_rows: int
    global_dim: int
    vocab: List[str]
    random_effect_id: str
    feature_shard_id: str
    # the "BASE:GROWTH" ladder the blocks were padded with, or None
    ladder: Optional[str] = None

    @classmethod
    def load(cls, path: str) -> "StreamingREManifest":
        with open(os.path.join(path, "manifest.json")) as f:
            m = json.load(f)
        return cls(dir=path, **m)

    @property
    def num_entities(self) -> int:
        return sum(b["num_entities"] for b in self.blocks)

    @property
    def max_block_bytes(self) -> int:
        return max(b["x_bytes"] for b in self.blocks)

    def load_block_host(self, i: int) -> dict:
        """Block i's arrays read onto the host (writable numpy): the disk
        stage of the pipeline, run on the prefetch thread."""
        with np.load(os.path.join(self.dir, self.blocks[i]["file"])) as z:
            out = {f: z[f] for f in _DATASET_FIELDS}
            out["row_sel"] = z["row_sel"]
            out["dense_ids"] = z["dense_ids"]
        out["_index"] = i
        return out

    def _block_from_device(self, block: dict) -> Tuple[int, RandomEffectDataset, Tensor, dict]:
        i = block["_index"]
        ds = RandomEffectDataset(**{f: block[f] for f in _DATASET_FIELDS},
                                 num_entities=self.blocks[i]["num_entities"],
                                 global_dim=self.global_dim)
        extra = {k: v for k, v in block.items()
                 if k not in _DATASET_FIELDS and k not in ("_index", "row_sel", "dense_ids")}
        return i, ds, block["row_sel"], extra

    def iter_blocks(self, prefetch_depth: Optional[int] = None, indices: Optional[List[int]] = None,
                    device=None, extra=None
                    ) -> "Iterator[Tuple[int, RandomEffectDataset, Tensor, dict]]":
        """``(i, dataset, row_sel, extra)`` on ``device`` for the blocks
        ``indices`` (default all), in that order, through the pipeline
        (depth <= 0: synchronous). ``extra(i)`` may add host arrays to a
        block (a cached slab), which travel with it and come back in
        ``extra``; the dense ids stay on the host. Order and arithmetic
        are the same at every depth, so results are bitwise equal."""
        from photon_ml_tpu_torch.io.pipeline import pipelined_to_device

        seq = list(indices) if indices is not None else list(range(len(self.blocks)))

        def to_host(i):
            block = self.load_block_host(i)
            del block["dense_ids"]
            if extra is not None:
                block.update(extra(i) or {})
            return block

        for block in pipelined_to_device(lambda: iter(seq), to_host, resolve_device(device),
                                         prefetch_depth, name="re-block-prefetch"):
            yield self._block_from_device(block)

    def load_block_meta(self, i: int, device=None) -> BlockMeta:
        """Block i's bookkeeping without its data slab."""
        with np.load(os.path.join(self.dir, self.blocks[i]["file"])) as z:
            return BlockMeta(
                entity_pos=z["entity_pos"], dense_ids=z["dense_ids"],
                entity_ids=z["entity_ids"], row_sel=z["row_sel"],
                local_to_global=torch.from_numpy(z["local_to_global"]).to(
                    resolve_device(device)),
                global_dim=self.global_dim,
            )


@dataclasses.dataclass
class SpilledREState:
    """Coordinate state spilled to disk: per-block ``coefs-<i>.npy`` under
    ``dir``. A missing file means zeros (the initial state costs no I/O)."""

    dir: str
    shapes: List[Tuple[int, int]]

    def _path(self, i: int) -> str:
        return os.path.join(self.dir, f"coefs-{i:05d}.npy")

    def block(self, i: int) -> np.ndarray:
        path = self._path(i)
        if not os.path.exists(path):
            return np.zeros(self.shapes[i], _np_real())
        return np.load(path)

    def write(self, i: int, arr: np.ndarray) -> None:
        os.makedirs(self.dir, exist_ok=True)
        path = self._path(i)
        with open(path + ".tmp", "wb") as f:
            np.save(f, np.asarray(arr))
        os.replace(path + ".tmp", path)

    # -- the checkpoint's by-reference protocol (checkpoint.py) --------------
    # the coefficients are already durable (atomic per-block spills), so a
    # checkpoint stores the directory handle, not the arrays
    def __checkpoint_ref__(self) -> dict:
        return {
            "kind": "spilled_re_state",
            "dir": self.dir,
            "shapes": [list(map(int, s)) for s in self.shapes],
            # "never written: zeros by design" against "written, since
            # vanished", which a restore must reject
            "written": os.path.isdir(self.dir),
        }

    def __checkpoint_from_ref__(self, ref: dict) -> "SpilledREState":
        from photon_ml_tpu_torch.checkpoint import CheckpointRefError

        if ref.get("kind") != "spilled_re_state":
            raise CheckpointRefError(
                f"checkpoint ref kind {ref.get('kind')!r} is not a spilled "
                "streaming state — coordinate types changed since the save"
            )
        shapes = [tuple(s) for s in ref["shapes"]]
        if shapes != [tuple(s) for s in self.shapes]:
            raise CheckpointRefError(
                "spilled-state ref shapes do not match this manifest's "
                f"blocks ({shapes[:3]}... vs {self.shapes[:3]}...) — the "
                "streaming blocks were rebuilt differently; refusing to resume"
            )
        if ref.get("written") and not os.path.isdir(ref["dir"]):
            raise CheckpointRefError(
                f"spilled coefficient dir {ref['dir']} referenced by this "
                "checkpoint no longer exists (epoch GC'd or output dir "
                "wiped) — restoring would silently zero trained "
                "coefficients; falling back to an older step"
            )
        return SpilledREState(dir=ref["dir"], shapes=shapes)


def _host_result(res: OptResult) -> OptResult:
    """A solve result moved to the host (a device result would pin every
    block's buffers alive)."""
    return OptResult(*(None if f is None else f.detach().cpu() for f in res))


@dataclasses.dataclass
class StreamingRandomEffectCoordinate:
    """Random-effect coordinate over disk-resident entity blocks."""

    # blocks stream through the host every update: no fused cycle
    cd_jit = False
    manifest: StreamingREManifest
    task: TaskType
    optimizer: OptimizerType = OptimizerType.LBFGS
    optimizer_config: Optional[OptimizerConfig] = None
    regularization: RegularizationContext = dataclasses.field(
        default_factory=RegularizationContext.none
    )
    state_root: Optional[str] = None  # default: <manifest.dir>/state-<pid>-<n>
    # io/pipeline depth; None reads PHOTON_PREFETCH_DEPTH (default 2)
    prefetch_depth: Optional[int] = None
    # optim.scheduler.SolveSchedule: each block's solve is compacted
    solve_schedule: Optional[object] = None
    # optim.convergence.AdaptiveSchedule: blocks visited by descending
    # score, persistently converged ones skipped (recorded decisions)
    adaptive: Optional[object] = None
    # a prior run's ledger entries, seeding a run with no sidecar yet
    ledger_seed: Optional[dict] = None
    # sparse spec per block (None reads PHOTON_SPARSE_KERNEL)
    sparse_kernel: Optional[str] = None
    # the resolved compile.plan.ExecutionPlan: fills the policies above when unset
    plan: Optional[object] = None
    device: Optional[object] = None  # where blocks solve (default cuda)
    # the delta retrain's skip set: blocks whose data and membership are
    # unchanged since the prior run. They never solve (coefficients carry
    # forward bitwise from the warm-seeded incoming state, no slab read)
    # and their scores are computed once and cached. The caller seeds the
    # state with the prior coefficients (retrain.warm.seed_spilled_state).
    frozen_blocks: Optional[frozenset] = None
    # the re-plan monitor (parallel/elastic.ElasticMonitor, or anything
    # with poll() -> Optional[proposal]); None = off
    elastic: Optional[object] = None
    # the epoch numbering floor of a coordinate rebuilt mid-run on a
    # re-planned manifest; 0 = a fresh run
    initial_epoch: int = 0
    # the score buffer's entries before the blocks write theirs (the
    # per-host subclass merges -0.0 where it owns no row)
    _SCORE_FILL = 0.0

    def __post_init__(self):
        if self.plan is not None:
            if self.solve_schedule is None:
                self.solve_schedule = self.plan.schedule
            if self.adaptive is None:
                self.adaptive = self.plan.adaptive
            if self.sparse_kernel is None:
                self.sparse_kernel = self.plan.sparse_kernel or "off"
            if self.prefetch_depth is None:
                self.prefetch_depth = self.plan.prefetch_depth
        if self.optimizer_config is None:
            self.optimizer_config = (OptimizerConfig.tron_default()
                                     if self.optimizer == OptimizerType.TRON
                                     else OptimizerConfig.lbfgs_default())
        self._device = resolve_device(self.device)
        if self.state_root is None:
            # unique per coordinate instance: grid combos share a manifest
            global _instance_seq
            _instance_seq += 1
            base = self.manifest.dir
            if os.path.exists(os.path.join(base, "meta.json")):
                # a cache-resident manifest is an immutable shared entry:
                # run state goes to a private temp dir instead
                base = tempfile.mkdtemp(prefix="photon-re-state-")
            self.state_root = os.path.join(base, f"state-{os.getpid()}-{_instance_seq}")
        self._epoch = int(self.initial_epoch)
        # the last update's input and output spill dirs (replan_state_dirs)
        self._last_input_state_dir: Optional[str] = None
        self._last_output_state_dir: Optional[str] = None
        self._shapes = [(b["num_entities"], b["local_dim"]) for b in self.manifest.blocks]
        self.frozen_blocks = frozenset(self.frozen_blocks or ())
        bad = [i for i in self.frozen_blocks if not 0 <= i < len(self.manifest.blocks)]
        if bad:
            raise ValueError(f"frozen_blocks {sorted(bad)} out of range for a "
                             f"{len(self.manifest.blocks)}-block manifest")
        # frozen block -> (row_sel, scores): epoch-invariant, so one
        # streaming pass serves the whole descent
        self._frozen_scores: dict = {}
        self._sparse_spec = fused_sparse.resolve_sparse_kernel(self.sparse_kernel)
        # block -> its slab on the host (None: the block stays dense)
        self._host_slabs: Dict[int, Optional[dict]] = {}
        self._ledger = ConvergenceLedger.load(self._ledger_dir())
        if self._ledger is None and self.ledger_seed:
            self._ledger = ConvergenceLedger.from_json(self.ledger_seed)
        if self._ledger is None:
            self._ledger = ConvergenceLedger()
        # blocks the last update skipped, and their cached scores
        self._adaptive_skipped: set = set()
        self._skipped_scores: dict = {}
        self.skip_decisions: list = []

    def _make_state(self, dir_path: str) -> SpilledREState:
        """The state under ``dir_path`` (the per-host subclass names its
        spill files by global block id)."""
        return SpilledREState(dir=dir_path, shapes=self._shapes)

    # -- adaptive-schedule plumbing (optim/convergence.py) -------------------
    def _ledger_gid(self, i: int) -> int:
        """The ledger key of local block ``i``: the block's global id in the
        per-host subclass, ``i`` here (a single-host manifest holds every
        block)."""
        return int(i)

    def _ledger_dir(self) -> str:
        """The ledger sidecar's directory: next to the manifest, unless the
        manifest is a cache entry (then under this run's state root)."""
        base = self.manifest.dir
        if os.path.exists(os.path.join(base, "meta.json")):
            return self.state_root
        return base

    def ledger_export(self) -> dict:
        return self._ledger.to_json()

    def _save_ledger(self) -> None:
        try:
            self._ledger.save(self._ledger_dir())
        except OSError:
            pass  # the ledger is never load-bearing: a restart re-visits everything

    def _record_block_result(self, i: int, res: OptResult) -> None:
        """Fold a solved block into the ledger and ``solve_stats``: the score
        is the largest lane gradient norm, the cost the lane-iterations."""
        gid = self._ledger_gid(i)
        score = float(torch.max(res.grad_norm)) if res.grad_norm.numel() else 0.0
        executed = int(torch.sum(res.iterations))
        under = self.adaptive is not None and score < self.adaptive.tolerance
        self._ledger.observe(gid, score, executed=executed, epoch=self._epoch,
                             under_tolerance=under)
        solve_stats.record_block(f"g{gid}", score=score, executed=executed)
        self._adaptive_skipped.discard(i)
        self._skipped_scores.pop(i, None)
        self._save_ledger()

    def _adaptive_partition(self, pending: List[int]) -> Tuple[List[int], List[int]]:
        """(visit, skip) of the pending blocks: visits by descending score,
        skips those under tolerance for ``patience`` epochs. The
        ``optim.block_skip`` fault site guards the decision: a fault
        degrades the epoch to visit-everything, recorded."""
        if self.adaptive is None or not pending:
            return pending, []
        gid_of = {i: self._ledger_gid(i) for i in pending}
        rank = {g: r for r, g in enumerate(self._ledger.order(gid_of.values()))}
        by_gap = sorted(pending, key=lambda i: rank[gid_of[i]])
        candidates = [i for i in by_gap if self._ledger.should_skip(gid_of[i], self.adaptive)]
        if candidates:
            try:
                faults.inject("optim.block_skip", epoch=self._epoch, blocks=len(candidates))
            except Exception as e:  # noqa: BLE001 — an injected fault makes the skip decision untrusted; visiting everything is the safe degrade
                self.skip_decisions.append(PlanDecision(
                    "adaptive", "pinned",
                    f"block-skip fault at epoch {self._epoch} "
                    f"({type(e).__name__}: {e}); degraded to "
                    "visit-everything for this epoch",
                ))
                return by_gap, []
        return [i for i in by_gap if i not in candidates], candidates

    # -- the elastic re-plan hooks (parallel/elastic.py) --------------------
    def replan_state_dirs(self) -> List[str]:
        """The spill dirs a re-plan re-bases: the input of the last (or
        in-flight) update, which a checkpoint taken before it references,
        and the last finished update's output, which one taken after it
        references. A moved block's coefficients are copied into both."""
        dirs: List[str] = []
        for d in (self._last_input_state_dir, self._last_output_state_dir):
            if d is not None and d not in dirs:
                dirs.append(d)
        return dirs

    def _elastic_drain(self, partial=None, where: str = "") -> None:
        """Poll the re-plan monitor; a pending proposal unwinds with
        ``ReplanRequired`` (``partial`` may be a callable, built only when a
        drain fires)."""
        if self.elastic is None:
            return
        from photon_ml_tpu_torch.parallel.elastic import drain_if_replan_pending

        drain_if_replan_pending(self.elastic, partial=partial, where=where)

    # -- coordinate protocol ------------------------------------------------
    @property
    def num_entities(self) -> int:
        return self.manifest.num_entities

    def initial_coefficients(self) -> SpilledREState:
        return self._make_state(os.path.join(self.state_root, "init"))

    def _sub_for(self, ds: RandomEffectDataset, block: Optional[int] = None,
                 slab=None) -> RandomEffectCoordinate:
        return RandomEffectCoordinate(
            dataset=ds, task=self.task, optimizer=self.optimizer,
            optimizer_config=self.optimizer_config, regularization=self.regularization,
            solve_label="streaming-re" if block is None else f"streaming-re[block {block}]",
            # selection happened in _slab_for: never re-resolve the env here
            sparse_kernel="off", sparse_slab=slab, solve_schedule=self.solve_schedule,
        )

    def _host_slab(self, i: int) -> Optional[dict]:
        """The cached host slab of block i, as arrays to upload with it."""
        cached = self._host_slabs.get(i)
        if not cached:
            return None
        return {f"slab.{k}": v for k, v in cached["arrays"].items()}

    def _slab_for(self, i: int, ds: RandomEffectDataset, extra: dict):
        """Block i's slab (None: the dense stack). The first visit builds it
        on the device from the block's stack (``auto`` races it; the race
        cache answers same-shape blocks) and keeps a host copy of the slab
        and its column tables; later visits rebuild it from the arrays that
        came with the block."""
        if self._sparse_spec is None:
            return None
        if i in self._host_slabs:
            cached = self._host_slabs[i]
            if cached is None:
                return None
            arr = {k[len("slab."):]: v for k, v in extra.items() if k.startswith("slab.")}
            if not arr:  # prefetched before the first visit cached it
                arr = {k: torch.from_numpy(v).to(ds.device)
                       for k, v in cached["arrays"].items()}
            tables = fused_sparse.ColumnTables(
                *(arr[k] for k in _SLAB_TABLES), **cached["table_meta"])
            return fused_sparse.SparseSlab(arr["idx"], arr["val"], cached["dim"],
                                           cached["kernel"], tables)
        slab = fused_sparse.build_and_select(
            self.task, ds.x, ds.labels, ds.base_offsets, ds.weights, self._sparse_spec,
            f"streaming-re[block {i}]",
            # --plan auto narrows the race to the predicted family against
            # the dense incumbent; None races every family
            candidates=getattr(self.plan, "sparse_candidates", None))
        if slab is None:
            self._host_slabs[i] = None
            return None
        t = slab.kernel_tables()
        host = lambda v: v.detach().cpu().numpy()
        self._host_slabs[i] = {
            "arrays": {"idx": host(slab.idx), "val": host(slab.val),
                       **{k: host(getattr(t, k)) for k in _SLAB_TABLES}},
            "table_meta": {"slot16": t.slot16, "max_lane_cols": t.max_lane_cols,
                           "max_lane_slots": t.max_lane_slots},
            "dim": slab.dim, "kernel": slab.kernel,
        }
        return slab

    def _padded_resid(self, local_resid: Tensor, ds: RandomEffectDataset) -> Tensor:
        """Block residuals padded to the block's (ladder) row count; pad
        slots are never gathered."""
        n_pad = ds.num_rows
        if local_resid.shape[0] == n_pad:
            return local_resid
        return torch.nn.functional.pad(local_resid, (0, n_pad - local_resid.shape[0]))

    def _partial_payload(self, new_state: SpilledREState, done_blocks,
                         inner: Optional[dict] = None) -> dict:
        """Preemption ``partial`` payload: the epoch dir (the finished
        blocks are already spilled there) and which blocks are done, plus a
        paused block solve's scheduler snapshot under ``inner.`` keys."""
        done = sorted(int(i) for i in done_blocks)
        meta = {
            "kind": "streaming_re",
            "epoch": self._epoch,
            "epoch_dir": new_state.dir,
            "blocks_done": len(done),
            "done_blocks": done,
            "inner": inner["meta"] if inner is not None else None,
        }
        arrays = {}
        if inner is not None:
            arrays = {f"inner.{k}": v for k, v in inner["arrays"].items()}
        return {"meta": meta, "arrays": arrays}

    def _resume_done_locals(self, m: dict, active) -> set:
        """The local blocks a resume payload records as solved this epoch:
        ``done_blocks`` when present, else the prefix of the active order
        that ``blocks_done`` counts (older payloads)."""
        if m.get("done_blocks") is not None:
            return {int(i) for i in m["done_blocks"]}
        return set(active[: int(m["blocks_done"])])

    def _resume_inner_ok(self, m: dict) -> bool:
        """Whether a paused block solve's scheduler snapshot may resume (the
        per-host subclass drops it across a plan change; the block then
        re-solves whole, bitwise the same)."""
        return True

    def update(self, residual_offsets: Tensor, state: SpilledREState,
               resume: Optional[dict] = None) -> Tuple[SpilledREState, tuple]:
        """One block resident at a time: gather the block rows' residuals,
        solve, spill the coefficients, release. Returns a new state
        directory; the previous epoch's stays (coordinate descent may still
        reference it) and older ones are removed.

        Block boundaries are preemption drain points: ``Preempted`` carries
        the epoch dir and the finished blocks (and a paused block solve's
        snapshot); passing that payload back as ``resume`` continues from
        the first unfinished block, bitwise as an uninterrupted update."""
        # the spill the incoming parameters reference: a re-plan copies moved
        # blocks' coefficients into it
        self._last_input_state_dir = getattr(state, "dir", None)
        n_blocks = len(self.manifest.blocks)
        active = [i for i in range(n_blocks) if i not in self.frozen_blocks]
        inner_resume = None
        if resume is not None:
            m = resume["meta"]
            if m.get("kind") != "streaming_re":
                raise ValueError(f"resume payload kind {m.get('kind')!r} is not a "
                                 "streaming-RE progress snapshot")
            # continue the interrupted epoch in place: its dir holds the done blocks
            self._epoch = int(m["epoch"])
            new_state = self._make_state(m["epoch_dir"])
            done_locals = set(self._resume_done_locals(m, active))
            if m.get("inner") is not None and self._resume_inner_ok(m):
                inner_resume = {"meta": m["inner"],
                                "arrays": {k[len("inner."):]: v
                                           for k, v in (resume.get("arrays") or {}).items()
                                           if k.startswith("inner.")}}
        else:
            # a pending proposal re-runs the whole update after the re-plan:
            # drain before any work, and before the epoch advances
            self._elastic_drain(where="streaming-RE update entry")
            self._epoch += 1
            for old in range(1, self._epoch - 1):
                old_dir = os.path.join(self.state_root, f"epoch-{old}")
                if os.path.abspath(old_dir) != os.path.abspath(state.dir):
                    shutil.rmtree(old_dir, ignore_errors=True)
            new_state = self._make_state(os.path.join(self.state_root, f"epoch-{self._epoch}"))
            done_locals = set()
        resid = torch.as_tensor(residual_offsets, device=self._device)
        # frozen blocks never solve: an atomic per-block copy of the
        # incoming (warm-seeded) coefficients, no slab read
        for i in sorted(self.frozen_blocks):
            new_state.write(i, state.block(i))
        summaries: List[Optional[OptResult]] = [None] * n_blocks
        pending = [i for i in active if i not in done_locals]
        pending, skipped = self._adaptive_partition(pending)
        if skipped:
            for i in skipped:
                gid = self._ledger_gid(i)
                new_state.write(i, state.block(i))
                self._ledger.record_skip(gid, epoch=self._epoch)
                solve_stats.record_block(f"g{gid}", skipped=True)
                self.skip_decisions.append(PlanDecision(
                    "adaptive", "skipped",
                    f"block g{gid} scored under tolerance "
                    f"{self.adaptive.tolerance:g} for >= "
                    f"{self.adaptive.patience} consecutive epochs; epoch "
                    f"{self._epoch} carries its coefficients forward",
                ))
                self._adaptive_skipped.add(i)
                done_locals.add(i)
            self._save_ledger()
        blocks = self.manifest.iter_blocks(self.prefetch_depth, indices=pending,
                                           device=self._device, extra=self._host_slab)
        # a drain unwinds out of the loop: close the pipeline (its worker
        # stops and is joined) before the exception leaves the update
        try:
            for k, (i, ds, row_sel, extra) in enumerate(blocks):
                local_resid = self._padded_resid(resid[row_sel], ds)
                w0 = torch.from_numpy(state.block(i)).to(self._device)
                slab = self._slab_for(i, ds, extra)
                sub = self._sub_for(ds, block=i, slab=slab)
                try:
                    coefs, res = sub.update(local_resid, w0,
                                            resume=inner_resume if k == 0 else None)
                except preemption.Preempted as e:
                    # inside block i: wrap the solve's snapshot with this
                    # coordinate's block progress and unwind
                    raise preemption.Preempted(
                        str(e), site=e.site,
                        partial=self._partial_payload(new_state, done_locals, e.partial)) from e
                new_state.write(i, coefs.detach().cpu().numpy())
                summaries[i] = _host_result(res)
                self._record_block_result(i, summaries[i])
                del ds, coefs, res, sub, slab, extra
                done_locals.add(i)
                if len(done_locals) < len(active):
                    if preemption.check("block", block=i, epoch=self._epoch):
                        raise preemption.Preempted(
                            f"preempted at block boundary ({len(done_locals)}/"
                            f"{len(active)} active blocks, epoch {self._epoch}): "
                            f"{preemption.reason()}",
                            site="block", partial=self._partial_payload(new_state, done_locals))
                    # the re-plan drain at the same boundary
                    self._elastic_drain(
                        partial=lambda: self._partial_payload(new_state, done_locals),
                        where=f"block boundary (epoch {self._epoch})")
        finally:
            blocks.close()
        self._last_output_state_dir = new_state.dir
        return new_state, tuple(summaries)

    def score(self, state: SpilledREState) -> Tensor:
        """(N,) scores, block by block; a frozen block reuses the scores of
        its first pass, a skipped block those of its last pass (their
        coefficients have not changed since). Drains for a pending re-plan
        first (before the per-host subclass's merge collective)."""
        self._elastic_drain(where="streaming-RE score entry")
        total = torch.full((self.manifest.num_rows,), self._SCORE_FILL, dtype=real_dtype(),
                           device=self._device)
        stream = []
        for i in range(len(self.manifest.blocks)):
            cached = None
            if i in self.frozen_blocks:
                cached = self._frozen_scores.get(i)
            elif i in self._adaptive_skipped:
                cached = self._skipped_scores.get(i)
            if cached is not None:
                rows, vals = cached
                total[torch.from_numpy(rows).to(self._device)] = vals.to(self._device)
            else:
                stream.append(i)
        for i, ds, row_sel, _ in self.manifest.iter_blocks(self.prefetch_depth, indices=stream,
                                                           device=self._device):
            w = torch.from_numpy(state.block(i)).to(self._device)
            # ladder-padded blocks score their pad rows too; slice them off
            vals = self._sub_for(ds).score(w)[: row_sel.numel()]
            total[row_sel] = vals
            if i in self.frozen_blocks:
                self._frozen_scores[i] = (row_sel.cpu().numpy(), vals.cpu())
            elif i in self._adaptive_skipped:
                self._skipped_scores[i] = (row_sel.cpu().numpy(), vals.cpu())
            del ds, w
        return total

    def regularization_term(self, state: SpilledREState) -> Tensor:
        l1, l2 = _split_reg_weight(self.regularization, None)
        acc = 0.0
        for i in range(len(self.manifest.blocks)):
            w = state.block(i)
            acc += l1 * float(np.sum(np.abs(w))) + 0.5 * l2 * float(np.sum(np.square(w)))
        return torch.tensor(acc, dtype=real_dtype(), device=self._device)

    # -- driver exports (as BucketedRandomEffectCoordinate's) ----------------
    def stack_sizes(self) -> List[int]:
        """Entity count per block stack, in block order."""
        return [b["num_entities"] for b in self.manifest.blocks]

    def vocab_position_maps(self) -> Tuple[np.ndarray, np.ndarray]:
        """Vocab index -> (owning block, position in its stack), from the
        blocks' bookkeeping alone."""
        v = len(self.manifest.vocab)
        block_of = np.full(v, -1, np.int32)
        pos_in_block = np.full(v, -1, np.int32)
        for i in range(len(self.manifest.blocks)):
            m = self.manifest.load_block_meta(i, "cpu")
            pos_of_dense = _positions_of_dense(m)
            has = pos_of_dense >= 0
            block_of[m.entity_ids[has]] = i
            pos_in_block[m.entity_ids[has]] = pos_of_dense[has]
        return block_of, pos_in_block

    def global_coefficient_stacks(self, state: SpilledREState) -> List[Tensor]:
        """Per-block (E_b, D_global) back-projected coefficient stacks."""
        return [global_coefficients(self.manifest.load_block_meta(i, self._device),
                                    torch.from_numpy(state.block(i)).to(self._device))
                for i in range(len(self.manifest.blocks))]

    def entity_means_by_raw_id(self, state: SpilledREState) -> Dict[str, np.ndarray]:
        return self.entity_export_by_raw_id(state)[0]

    def entity_export_by_raw_id(self, state: SpilledREState,
                                residual_offsets: Optional[Tensor] = None):
        """(means, variances) dicts keyed by raw entity id. Only the
        variance branch streams the data slabs (Hessian diagonals need the
        samples); the means come from the bookkeeping alone."""
        means: Dict[str, np.ndarray] = {}
        variances: Optional[Dict[str, np.ndarray]] = {} if residual_offsets is not None else None
        vocab = self.manifest.vocab
        slabs = (self.manifest.iter_blocks(self.prefetch_depth, device=self._device)
                 if residual_offsets is not None else iter(()))
        resid = (torch.as_tensor(residual_offsets, device=self._device)
                 if residual_offsets is not None else None)
        for i in range(len(self.manifest.blocks)):
            m = self.manifest.load_block_meta(i, self._device)
            w = torch.from_numpy(state.block(i)).to(self._device)
            mean_stack = global_coefficients(m, w).cpu().numpy()
            var_stack = None
            if resid is not None:
                _, ds, row_sel, _ = next(slabs)
                var = self._sub_for(ds).coefficient_variances(
                    w, self._padded_resid(resid[row_sel], ds))
                var_stack = global_coefficients(m, var).cpu().numpy()
                del ds
            pos_of_dense = _positions_of_dense(m)
            for j, vi in enumerate(m.entity_ids):
                if pos_of_dense[j] >= 0:
                    means[vocab[vi]] = mean_stack[pos_of_dense[j]]
                    if variances is not None:
                        variances[vocab[vi]] = var_stack[pos_of_dense[j]]
        return means, variances
