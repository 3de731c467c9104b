"""The ``retrain.json`` record one training run leaves for the next (port of
photon_ml_tpu/retrain/manifest.py, the same file).

The training driver writes it at the output root (atomic tmp+rename). It
captures the run's identity: the training files' stat tokens
(:func:`file_stat_token`), the ingest-config inputs and digest
(:func:`index_map_digest` of every feature shard), per-coordinate records
and the model it produced, so the next run's delta planner
(``--warm-start-from``, retrain/delta.py) answers "what changed since the
prior run?" from stat calls and one small JSON read. Each package reads the
other's file: the tensor-cache keys, the streaming manifests' directories,
the convergence ledgers and, under ``--plan auto``, the cost model included.
``file_stat_token`` and ``index_map_digest`` are io/tensor_cache.py's.

Reading the prior run's manifest carries the ``retrain.delta_plan`` fault
site: a corrupt or injected-faulty prior raises, and the driver records a
cold run. A broken prior costs a cold retrain, never a wrong warm one.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

from photon_ml_tpu_torch.io.tensor_cache import file_stat_token, index_map_digest
from photon_ml_tpu_torch.resilience import faults

__all__ = [
    "MANIFEST_FORMAT",
    "RETRAIN_MANIFEST",
    "CoordinateRecord",
    "RetrainManifest",
    "file_stat_token",
    "index_map_digest",
    "load_prior_manifest",
]

RETRAIN_MANIFEST = "retrain.json"
MANIFEST_FORMAT = 1


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

    @classmethod
    def load(cls, directory: str) -> "RetrainManifest":
        with open(os.path.join(directory, RETRAIN_MANIFEST)) as f:
            raw = json.load(f)
        if int(raw.get("format", -1)) != MANIFEST_FORMAT:
            raise ValueError(
                f"retrain manifest format {raw.get('format')!r} != "
                f"{MANIFEST_FORMAT} — prior run predates/postdates this "
                "planner; retrain cold"
            )
        coords = {
            name: CoordinateRecord(**rec)
            for name, rec in raw.pop("coordinates").items()
        }
        return cls(coordinates=coords, **raw)

    def stat_by_path(self) -> Dict[str, tuple]:
        return {p: (int(size), int(mtime)) for p, size, mtime in self.file_stats}


def load_prior_manifest(prior_dir: str) -> RetrainManifest:
    """The prior run's manifest from its output dir (``--warm-start-from``).

    Carries the ``retrain.delta_plan`` fault site and checks the model
    reference: a manifest whose saved model has since vanished is as
    useless as a corrupt one. Any failure raises; the driver catches it,
    records the cold-degrade decision and trains cold."""
    faults.inject("retrain.delta_plan", prior_dir=prior_dir)
    manifest = RetrainManifest.load(prior_dir)
    if not os.path.isdir(manifest.model_dir):
        raise FileNotFoundError(
            f"prior retrain manifest at {prior_dir} references model dir "
            f"{manifest.model_dir}, which no longer exists"
        )
    return manifest
