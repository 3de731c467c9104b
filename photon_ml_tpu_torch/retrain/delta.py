"""The delta planner: classify files, coordinates and entity blocks (port
of photon_ml_tpu/retrain/delta.py, the same module).

A daily retrain sees a file set that is mostly the prior day's. The planner
diffs the new inputs against the prior run's
:class:`~photon_ml_tpu_torch.retrain.manifest.RetrainManifest` with the
identity the tensor cache uses (path, size, mtime_ns stat tokens) and
classifies:

  * every **file**: ``unchanged | changed | new | removed``;
  * every **coordinate**: ``unchanged`` (identical inputs and config: the
    prior coefficients are the result, carried forward bitwise without a
    solve), ``dirty`` (data or config moved: re-solve, warm-started from
    the prior model), or ``new`` (no prior: cold solve);
  * every **entity block** of a dirty streaming random-effect coordinate:
    the prior run's blocking is pinned (surviving entities keep their
    block; new entities append as new blocks), so a block whose membership
    is intact and holds no dirty entity is ``unchanged``: its on-disk
    payload is reused (only the global row selector and the vocab ids are
    rewritten) and its solve is skipped, while ``dirty``/``new`` blocks
    rebuild from the new rows and re-solve warm.

Dirty entities are found by reading only the changed and new files' id
columns (``io/avro_data.collect_entity_ids``, through the native decoder),
so the cost scales with the delta. An entity can lose rows from a changed
file without appearing in its new content, so a candidate-unchanged block
is also checked by row count in the new row space: a mismatch demotes it to
a rebuilt dirty block, never a stale payload. Every adjustment is a
recorded :class:`~photon_ml_tpu_torch.compile.plan.PlanDecision`, logged by
the driver. Block files and cache keys are the JAX package's bytes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from photon_ml_tpu_torch.compile.plan import PlanDecision

__all__ = [
    "BlockDelta",
    "CoordinateDelta",
    "DeltaPlan",
    "FileDelta",
    "build_delta_streaming_manifest",
    "diff_files",
    "dirty_set_digest",
    "pin_prior_blocks",
    "plan_delta",
    "probe_dirty_entities",
]

UNCHANGED = "unchanged"
DIRTY = "dirty"
NEW = "new"


@dataclasses.dataclass(frozen=True)
class FileDelta:
    """Input-file classification vs the prior run (absolute paths)."""

    unchanged: Tuple[str, ...]
    changed: Tuple[str, ...]
    new: Tuple[str, ...]
    removed: Tuple[str, ...]

    @property
    def clean(self) -> bool:
        return not (self.changed or self.new or self.removed)

    def describe(self) -> str:
        return (
            f"{len(self.unchanged)} unchanged / {len(self.changed)} changed "
            f"/ {len(self.new)} new / {len(self.removed)} removed"
        )


@dataclasses.dataclass(frozen=True)
class BlockDelta:
    """One streaming entity block's classification in the delta build."""

    index: int
    status: str  # unchanged | dirty | new
    prior_index: Optional[int] = None
    reason: str = ""


@dataclasses.dataclass(frozen=True)
class CoordinateDelta:
    name: str
    status: str  # unchanged | dirty | new
    reason: str = ""


@dataclasses.dataclass
class DeltaPlan:
    """The resolved retrain plan: what skips, what warms, what runs cold."""

    files: FileDelta
    coordinates: Dict[str, CoordinateDelta]
    # True: inputs, config, and grid are identical to the prior run — the
    # prior model IS this run's result (the driver short-circuits training
    # and re-exports it bitwise)
    short_circuit: bool
    decisions: Tuple[PlanDecision, ...] = ()
    # filled by probe_dirty_entities once the changed files' ids are read
    dirty_entities: Dict[str, Set[str]] = dataclasses.field(default_factory=dict)

    def frozen_coordinates(self) -> Set[str]:
        return {
            n for n, c in self.coordinates.items() if c.status == UNCHANGED
        }

    def describe_decisions(self) -> Tuple[str, ...]:
        return tuple(d.describe() for d in self.decisions)


def diff_files(prior_stats: Dict[str, tuple], new_files: List[str]) -> FileDelta:
    """Stat-token diff (same identity as tensor-cache keys): a file is
    unchanged iff path, size, AND mtime_ns all match the prior record."""
    unchanged, changed, new = [], [], []
    seen = set()
    for path in sorted(new_files):
        ap = os.path.abspath(path)
        seen.add(ap)
        st = os.stat(ap)
        prior = prior_stats.get(ap)
        if prior is None:
            new.append(ap)
        elif prior == (int(st.st_size), int(st.st_mtime_ns)):
            unchanged.append(ap)
        else:
            changed.append(ap)
    removed = sorted(p for p in prior_stats if p not in seen)
    return FileDelta(
        unchanged=tuple(unchanged), changed=tuple(changed),
        new=tuple(new), removed=tuple(removed),
    )


def plan_delta(
    prior,
    new_files: List[str],
    *,
    task: str,
    updating_sequence: List[str],
    ingest_inputs: Dict[str, object],
    combo_configs: Optional[Dict[str, str]] = None,
    eval_identity: Optional[Dict[str, object]] = None,
) -> DeltaPlan:
    """Coordinate-level classification (block-level happens later, inside
    the dirty streaming build, because it needs the new ingest).

    ``combo_configs`` maps coordinate name -> repr of its optimization
    config when the run trains a SINGLE grid combo; pass None for a
    multi-combo grid (freezing is then off — each combo trains its own
    lambda, warm-started — but warm starts stay on).

    ``eval_identity`` (validation file stats + evaluator specs) gates the
    short-circuit ONLY: a changed validation side must re-score — with
    every coordinate still frozen, so the re-score run solves nothing.
    """
    files = diff_files(prior.stat_by_path(), new_files)
    decisions: List[PlanDecision] = []
    identical_env = (
        files.clean
        and task == prior.task
        and ingest_inputs == prior.ingest_inputs
    )
    if not files.clean:
        decisions.append(PlanDecision(
            "retrain", "composed",
            f"input delta: {files.describe()} — changed coordinates "
            "re-solve warm-started from the prior model",
        ))
    if files.clean and ingest_inputs != prior.ingest_inputs:
        decisions.append(PlanDecision(
            "retrain", "pinned",
            "inputs unchanged but the ingest configuration moved — "
            "coefficients warm-start, nothing freezes",
        ))
    if files.clean and task != prior.task:
        decisions.append(PlanDecision(
            "retrain", "pinned",
            f"task changed {prior.task} -> {task}: the prior optimum is a "
            "warm start for a different loss, not a reusable result",
        ))

    coords: Dict[str, CoordinateDelta] = {}
    for name in updating_sequence:
        rec = prior.coordinates.get(name)
        if rec is None:
            coords[name] = CoordinateDelta(
                name, NEW, "coordinate absent from the prior run — cold solve"
            )
            decisions.append(PlanDecision(
                "retrain", "composed",
                f"coordinate {name!r} is new — cold solve",
            ))
            continue
        if not identical_env:
            coords[name] = CoordinateDelta(
                name, DIRTY, "inputs or configuration changed — warm re-solve"
            )
            continue
        cfg = None if combo_configs is None else combo_configs.get(name, "")
        if cfg is not None and cfg == rec.opt_config:
            coords[name] = CoordinateDelta(
                name, UNCHANGED,
                "inputs + config identical to the prior run — prior "
                "coefficients carried forward bitwise, solve skipped",
            )
            decisions.append(PlanDecision(
                "retrain", "subsumed",
                f"coordinate {name!r} unchanged — skipping its solve "
                "(prior coefficients bitwise)",
            ))
        else:
            coords[name] = CoordinateDelta(
                name, DIRTY,
                "optimization grid differs from the prior selected combo — "
                "warm re-solve",
            )

    eval_same = (eval_identity or {}) == (getattr(prior, "eval_identity", {}) or {})
    short = (
        identical_env
        and eval_same
        and list(updating_sequence) == list(prior.updating_sequence)
        and all(c.status == UNCHANGED for c in coords.values())
    )
    if identical_env and not eval_same:
        decisions.append(PlanDecision(
            "retrain", "composed",
            "training side unchanged but the validation inputs/evaluators "
            "moved — re-scoring with every solve still skipped (frozen "
            "coordinates), no wholesale short-circuit",
        ))
    if short:
        decisions.append(PlanDecision(
            "retrain", "subsumed",
            "nothing changed — reusing the prior model wholesale "
            "(0 solves, 0 compiles)",
        ))
    return DeltaPlan(
        files=files, coordinates=coords, short_circuit=short,
        decisions=tuple(decisions),
    )


def probe_dirty_entities(
    files: FileDelta, id_types: List[str]
) -> Dict[str, Set[str]]:
    """Raw entity ids whose data moved: everything appearing in changed or
    new files' CURRENT content. (Entities that only LOST rows from a
    changed file are caught by the per-block row-count guard in the delta
    build — see module doc.)"""
    from photon_ml_tpu_torch.io.avro_data import collect_entity_ids

    touched = list(files.changed) + list(files.new)
    if not touched:
        return {t: set() for t in id_types}
    return collect_entity_ids(touched, id_types)


def dirty_set_digest(dirty_raw: Set[str]) -> str:
    """Stable digest of a dirty-entity set — part of the delta build's
    tensor-cache key (a different dirty set classifies blocks differently,
    so it must address a different cache entry)."""
    h = hashlib.sha256()
    for r in sorted(dirty_raw):
        h.update(r.encode())
        h.update(b"\x00")
    return h.hexdigest()


# ---------------------------------------------------------------------------
# delta streaming-block build
# ---------------------------------------------------------------------------


def pin_prior_blocks(
    prior_blocks, vocab: List[str], counts: np.ndarray, dirty_raw: Set[str],
) -> Tuple[List[Tuple[np.ndarray, str, Optional[int], str]], np.ndarray, List[str]]:
    """The prior run's blocking pinned onto the new vocab: the one rule of
    the single-process and the per-host delta builds. ``prior_blocks``
    holds, per prior block, ``(raw entity ids, its row count)``, or a
    reason string when the block could not be read. Per prior block, the
    surviving entities (sorted new dense ids) keep their block, classified
    ``unchanged`` only when none left, none is dirty and the block's row
    count (uncapped) is the prior's: an entity can lose rows from a changed
    file without appearing in its new content. Returns (blocks, assigned
    mask, degrade reasons). Raw-id order and sorted-dense order agree
    across runs because both vocabs sort raw ids. An unreadable prior
    block contributes no pin: its entities fall through to the fresh
    blocking's leftover and rebuild cold, with the reason recorded."""
    raw_to_new = {r: i for i, r in enumerate(vocab)}
    assigned = np.zeros(len(vocab), bool)
    out = []
    degraded: List[str] = []
    for bi, prior in enumerate(prior_blocks):
        if isinstance(prior, str):
            degraded.append(f"prior block {bi} unreadable ({prior})")
            continue
        prior_raws, prior_rows = prior
        keep = [
            raw_to_new[r]
            for r in prior_raws
            if r in raw_to_new and counts[raw_to_new[r]] > 0
        ]
        if not keep:
            continue  # every entity of this block left the dataset
        ent = np.sort(np.asarray(keep, np.int64))
        assigned[ent] = True
        rows = int(np.asarray(counts)[ent].sum())
        if len(keep) != len(prior_raws):
            out.append((ent, DIRTY, bi, "entity membership changed"))
        elif any(r in dirty_raw for r in prior_raws):
            out.append((ent, DIRTY, bi, "contains dirty entities"))
        elif rows != int(prior_rows):
            out.append((ent, DIRTY, bi, f"row count moved ({int(prior_rows)} -> {rows}) "
                                        "— rows left a changed file"))
        else:
            out.append((ent, UNCHANGED, bi, ""))
    return out, assigned, degraded


def _pinned_blocking(prior_manifest, vocab: List[str], counts: np.ndarray,
                     dirty_raw: Set[str]):
    """:func:`pin_prior_blocks` over a single-process prior manifest's
    block files (each block's entity ids and row selector)."""
    prior_blocks = []
    for bi in range(len(prior_manifest.blocks)):
        try:
            meta = prior_manifest.load_block_meta(bi, "cpu")
        except (OSError, KeyError, ValueError) as e:
            prior_blocks.append(f"{type(e).__name__}: {e}")
            continue
        prior_blocks.append(([prior_manifest.vocab[v] for v in meta.entity_ids],
                             len(meta.row_sel)))
    return pin_prior_blocks(prior_blocks, vocab, counts, dirty_raw)


def build_delta_streaming_manifest(
    data,
    config,
    out_dir: str,
    prior_manifest,
    dirty_raw: Set[str],
    *,
    bucketer=None,
    block_entities: Optional[int] = None,
    memory_budget_bytes: Optional[int] = None,
    tensor_cache=None,
    cache_key: Optional[str] = None,
):
    """Entity blocks for the NEW data with the prior run's blocking pinned.

    Returns ``(StreamingREManifest, [BlockDelta...])``. Unchanged blocks'
    payload arrays are copied from the prior block files as-is (only
    ``row_sel`` — global row positions — and ``entity_ids`` — dense vocab
    ids — are rewritten for the new row/vocab spaces); dirty and new
    blocks build through the ordinary
    :func:`~photon_ml_tpu_torch.algorithm.streaming_random_effect.
    build_block_payload` path. Any failure to reuse a prior block (file
    vanished, row count moved, ladder changed) demotes it to a rebuilt
    dirty block with a recorded reason — never a wrong warm payload.

    With ``tensor_cache``/``cache_key`` the built directory commits as a
    cache entry exactly like the cold builder; per-block classifications
    ride in the manifest metas (``delta`` key), so a cache hit recovers
    them without rebuilding. The caller's key must include the prior-run
    identity and the dirty-set digest — this function trusts the key.
    """
    from photon_ml_tpu_torch.algorithm.streaming_random_effect import (
        StreamingREManifest,
        build_block_payload,
        plan_entity_blocks,
        write_block_file,
        write_streaming_manifest_json,
        _DATASET_FIELDS,
    )
    from photon_ml_tpu_torch.compile import resolve_bucketer

    bucketer = resolve_bucketer(bucketer)
    spec = f"{bucketer.base}:{bucketer.growth:g}" if bucketer else None

    if tensor_cache is not None and cache_key is not None:
        hit = tensor_cache.get_dir(cache_key)
        if hit is not None:
            manifest = StreamingREManifest.load(hit)
            deltas = [
                BlockDelta(i, b.get("delta", DIRTY), b.get("delta_prior"),
                           b.get("delta_reason", ""))
                for i, b in enumerate(manifest.blocks)
            ]
            return manifest, deltas

    re_id = config.random_effect_id
    ids = data.ids[re_id]
    vocab = data.id_vocabs[re_id]
    counts = np.bincount(ids, minlength=len(vocab))
    # ONE fresh-blocking policy (incl. the either-or sizing default),
    # shared by the leftover planning below and the budget-outgrown
    # re-block path inside the build
    fresh_block_kw = dict(
        global_dim=data.shards[config.feature_shard_id].dim,
        active_upper_bound=config.active_upper_bound,
        block_entities=(
            block_entities
            if (block_entities is not None) != (memory_budget_bytes is not None)
            else 1024
        ),
        memory_budget_bytes=memory_budget_bytes,
    )

    plan: List[Tuple[np.ndarray, str, Optional[int], str]] = []
    degraded: List[str] = []
    if spec == prior_manifest.ladder:
        pinned, assigned, degraded = _pinned_blocking(
            prior_manifest, vocab, counts, dirty_raw
        )
        plan.extend(pinned)
        leftover_counts = np.where(assigned, 0, counts)
    else:
        # ladder change reshapes every padded payload — nothing reuses;
        # classify everything dirty through a fresh blocking
        assigned = np.zeros(len(vocab), bool)
        leftover_counts = counts
    if leftover_counts.any():
        fresh = plan_entity_blocks(leftover_counts, **fresh_block_kw)
        if spec != prior_manifest.ladder:
            status, reason = DIRTY, "shape ladder changed — full rebuild"
        elif degraded:
            # entities orphaned by unreadable prior blocks rebuild cold
            status, reason = DIRTY, "; ".join(degraded)
        else:
            status, reason = NEW, ""
        plan.extend((ent, status, None, reason) for ent in fresh)

    def _build(tmp: str):
        metas = []
        deltas: List[BlockDelta] = []
        idx = 0

        def _emit(payload, st, pi, rsn):
            nonlocal idx
            meta = write_block_file(tmp, f"block-{idx:05d}.npz", payload)
            meta["delta"] = st
            meta["delta_prior"] = pi
            meta["delta_reason"] = rsn
            metas.append(meta)
            deltas.append(BlockDelta(idx, st, pi, rsn))
            idx += 1

        for ent, status, prior_i, reason in plan:
            if status == UNCHANGED:
                payload, why = _reuse_prior_payload(
                    prior_manifest, prior_i, ids, ent, _DATASET_FIELDS
                )
                if payload is not None:
                    _emit(payload, UNCHANGED, prior_i, "")
                    del payload
                    continue
                status, reason = DIRTY, why  # demoted: never a stale payload
            try:
                payload = build_block_payload(
                    data, config, ent, bucketer=bucketer,
                    memory_budget_bytes=memory_budget_bytes,
                    label=f"delta block {idx}",
                )
            except ValueError as e:
                if prior_i is None:
                    raise  # fresh blocks keep the cold builder's contract
                # a pinned block's data GREW past the memory budget (the
                # steady state of daily growth): re-block its entities
                # fresh under the budget instead of failing a retrain a
                # cold run of the same config would survive
                sub_counts = np.zeros_like(counts)
                sub_counts[ent] = counts[ent]
                for sub in plan_entity_blocks(sub_counts, **fresh_block_kw):
                    _emit(
                        build_block_payload(
                            data, config, sub, bucketer=bucketer,
                            memory_budget_bytes=memory_budget_bytes,
                            label=f"delta block {idx}",
                        ),
                        DIRTY, prior_i,
                        f"prior block outgrew the budget ({e}) — re-blocked",
                    )
                continue
            _emit(payload, status, prior_i, reason)
            del payload
        write_streaming_manifest_json(
            tmp, metas,
            num_rows=int(data.num_rows),
            global_dim=int(data.shards[config.feature_shard_id].dim),
            vocab=list(vocab),
            random_effect_id=re_id,
            feature_shard_id=config.feature_shard_id,
            ladder=spec,
        )
        return deltas

    if tensor_cache is not None and cache_key is not None:
        from photon_ml_tpu_torch.resilience import RetryError

        holder: List[List[BlockDelta]] = []
        try:
            entry = tensor_cache.build_dir(
                cache_key, lambda tmp: holder.append(_build(tmp))
            )
            return StreamingREManifest.load(entry), holder[0]
        except RetryError:
            pass  # cache unusable: fall through to the plain build
    os.makedirs(out_dir, exist_ok=True)
    deltas = _build(out_dir)
    return StreamingREManifest.load(out_dir), deltas


def _reuse_prior_payload(
    prior_manifest, prior_i: int, ids: np.ndarray, ent: np.ndarray,
    dataset_fields,
) -> Tuple[Optional[dict], str]:
    """The prior block's payload rewritten into the new row/vocab spaces,
    or (None, reason) when reuse is unsafe. The block's rows all live in
    unchanged files (no member is dirty), so the new row selector aligns
    element-wise with the prior one whenever the COUNT matches — a count
    mismatch means rows were silently lost (e.g. an entity dropped from a
    changed file without appearing in its new content) and the block must
    rebuild."""
    try:
        z = np.load(os.path.join(
            prior_manifest.dir, prior_manifest.blocks[prior_i]["file"]
        ))
        new_row_sel = np.nonzero(np.isin(ids, ent))[0]
        if len(new_row_sel) != len(z["row_sel"]):
            return None, (
                f"row count moved ({len(z['row_sel'])} -> "
                f"{len(new_row_sel)}) — rows left a changed file"
            )
        payload = {f: np.asarray(z[f]) for f in dataset_fields}
        payload["row_sel"] = new_row_sel.astype(np.int64)
        payload["entity_ids"] = np.asarray(ent, np.int64)
        payload["dense_ids"] = np.asarray(z["dense_ids"])
        return payload, ""
    except (OSError, KeyError, ValueError) as e:
        return None, f"prior block unreadable ({type(e).__name__}: {e})"
