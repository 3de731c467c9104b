"""Retraining records (port of the manifest half of photon_ml_tpu/retrain/):
the ``retrain.json`` every GAME training run leaves beside its model. The
delta planner that reads it (``retrain/delta.py``) is not yet ported."""

from photon_ml_tpu_torch.retrain.manifest import (
    MANIFEST_FORMAT,
    RETRAIN_MANIFEST,
    CoordinateRecord,
    RetrainManifest,
    file_stat_token,
    index_map_digest,
)

__all__ = [
    "MANIFEST_FORMAT",
    "RETRAIN_MANIFEST",
    "CoordinateRecord",
    "RetrainManifest",
    "file_stat_token",
    "index_map_digest",
]
