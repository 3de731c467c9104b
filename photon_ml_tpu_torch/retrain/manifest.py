"""The ``retrain.json`` record one training run leaves for the next (port of
photon_ml_tpu/retrain/manifest.py, the same file).

The training driver writes it at the output root (atomic tmp+rename). It
captures the run's identity: the training files' stat tokens
(:func:`file_stat_token`), the ingest-config inputs and digest
(:func:`index_map_digest` of every feature shard), per-coordinate records
and the model it produced, so the JAX package's delta planner
(``--warm-start-from``) can read a run of this port. Fields of features the
port does not have yet (streaming manifests, convergence ledgers, the
planner's cost model, the tensor cache) take the values the JAX driver
writes when those features are off.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, Iterable, List, Optional

__all__ = [
    "MANIFEST_FORMAT",
    "RETRAIN_MANIFEST",
    "CoordinateRecord",
    "RetrainManifest",
    "file_stat_token",
    "index_map_digest",
]

RETRAIN_MANIFEST = "retrain.json"
MANIFEST_FORMAT = 1


def file_stat_token(paths: Iterable[str]) -> list:
    """[path, size, mtime_ns] per source file, sorted by path — the identity
    of the inputs (photon_ml_tpu/io/tensor_cache.py's vocabulary). Taken
    before ingest, so the record describes the files the run is about to
    read."""
    out = []
    for p in sorted(paths):
        st = os.stat(p)
        out.append([os.path.abspath(p), int(st.st_size), int(st.st_mtime_ns)])
    return out


def index_map_digest(index_map) -> str:
    """SHA-256 of an index map's feature names in index order, through the
    shared protocol (``__len__`` + ``get_feature_name``); the in-memory list
    is read directly when the map has one."""
    h = hashlib.sha256()
    names = getattr(index_map, "index_to_name", None)
    if names is None:
        names = (index_map.get_feature_name(i) for i in range(len(index_map)))
    for name in names:
        h.update((name or "").encode())
        h.update(b"\x00")
    return h.hexdigest()


@dataclasses.dataclass
class CoordinateRecord:
    """One coordinate's identity in the prior run.

    ``kind`` is ``"fixed" | "random" | "streaming_random" | "factored"``.
    ``opt_config`` is the repr of the SELECTED combo's optimization config
    (lambda, optimizer, ...): a config change means the prior coefficients
    are a warm start, not a reusable result. ``streaming_manifest_dir``
    points at the durable entity-block layout the delta build pins its
    blocking to (may live inside a shared tensor-cache entry)."""

    kind: str
    opt_config: str = ""
    cache_key: Optional[str] = None
    streaming_manifest_dir: Optional[str] = None
    # the entity-shard plan version the streaming layout was built/last
    # re-based under (elastic re-sharding, parallel/elastic.py); 1 for
    # single-host layouts. A future multihost delta retrain compares it
    # against the live plan so topology drift is a recorded re-plan, not
    # a silent blanket rebuild.
    shard_plan_version: int = 1
    # the coordinate's convergence ledger at the end of the run
    # (ConvergenceLedger.to_json(), optim/convergence.py): per-block
    # gradient-norm scores and visit/skip counts. A warm delta retrain
    # seeds the next run's adaptive schedule from it so importance
    # ordering survives across runs, not just across epochs. Optional and
    # never load-bearing — a missing/old record just starts cold.
    convergence_ledger: Optional[dict] = None


@dataclasses.dataclass
class RetrainManifest:
    """Everything the next run's planner needs about this run."""

    output_dir: str
    model_dir: str  # the saved best model (model_io layout)
    task: str
    file_stats: List[list]  # [path, size, mtime_ns] per training input
    # config that determines the ingest OUTPUT given the input files,
    # known BEFORE feature maps exist (sections, intercepts, id types,
    # ladder, offheap dir): the planner's cheap pre-ingest equality check
    ingest_inputs: Dict[str, object]
    # digest of the FULL ingest cache config (incl. index-map digests,
    # known only after feature maps build): gates block-level reuse — a
    # feature-space change shifts every gather index, so reuse is off
    ingest_digest: str
    updating_sequence: List[str]
    coordinates: Dict[str, CoordinateRecord]
    # the whole-set ingest tensor-cache key (cache hygiene: the next delta
    # run invalidates it once superseded — it can never hit again)
    data_cache_key: Optional[str] = None
    # validation-side identity (validation file stats + evaluator specs):
    # gates the SHORT-CIRCUIT only — a changed validation set must re-score
    # even when training has nothing to do (coordinate freezing still
    # applies, so the re-score run skips every solve)
    eval_identity: Dict[str, object] = dataclasses.field(default_factory=dict)
    # --plan auto: the run's cost model (compile/cost.py to_json) rides
    # along so warm starts plan from realized costs; None when planning
    # was off or the run recorded nothing (priors stay in force)
    cost_model: Optional[dict] = None
    format: int = MANIFEST_FORMAT

    # ------------------------------------------------------------------
    def save(self, directory: str) -> str:
        path = os.path.join(directory, RETRAIN_MANIFEST)
        payload = dataclasses.asdict(self)
        if payload.get("cost_model") is None:
            # --plan off leaves the manifest bytes exactly as before the
            # planner existed (the off mode's bitwise-identity guarantee)
            payload.pop("cost_model", None)
        with open(path + ".tmp", "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(path + ".tmp", path)
        return path
