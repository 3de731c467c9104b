"""Incremental delta retraining, the daily retrain loop (port of
photon_ml_tpu/retrain/).

A GLMix model retrains daily on data that is mostly the prior day's: the
per-entity random effects change only where new rows arrived. This package
connects the durable, content-addressed pieces (tensor-cache keys,
streaming entity-block files, saved models, the serving store a live swap
takes) into a loop that skips unchanged work:

  * :mod:`~photon_ml_tpu_torch.retrain.manifest`: the ``retrain.json`` a
    training run leaves behind (source-file stat tokens, ingest identity,
    per-coordinate cache keys and block layouts, the saved model);
  * :mod:`~photon_ml_tpu_torch.retrain.delta`: the planner that classifies
    every input file, every coordinate and, inside a dirty streaming
    random effect, every entity block against it, pinning the prior
    blocking so unchanged blocks are reused bitwise and only dirty and new
    ones rebuild and re-solve, warm-started;
  * :mod:`~photon_ml_tpu_torch.retrain.warm`: the warm-start builders that
    gather a saved model's rows back into each coordinate's solve space.

A corrupt prior manifest, a vanished prior model or a lost block layout
degrades to a recorded cold solve (the ``retrain.delta_plan`` fault site),
never a wrong warm result. The GAME driver runs the loop with
``--warm-start-from PRIOR_OUTPUT_DIR``, and so does the multihost driver,
whose per-host streaming state ``seed_perhost_spilled_state`` seeds.
"""

from photon_ml_tpu_torch.retrain.delta import (
    BlockDelta,
    CoordinateDelta,
    DeltaPlan,
    FileDelta,
    build_delta_streaming_manifest,
    diff_files,
    dirty_set_digest,
    plan_delta,
    probe_dirty_entities,
)
from photon_ml_tpu_torch.retrain.manifest import (
    MANIFEST_FORMAT,
    RETRAIN_MANIFEST,
    CoordinateRecord,
    RetrainManifest,
    file_stat_token,
    index_map_digest,
    load_prior_manifest,
)
from photon_ml_tpu_torch.retrain.warm import (
    bucketed_random_effect_init,
    dense_random_effect_init,
    fixed_effect_init,
    random_effect_entity_means,
    seed_perhost_spilled_state,
    seed_spilled_state,
)

__all__ = [
    "BlockDelta",
    "CoordinateDelta",
    "CoordinateRecord",
    "DeltaPlan",
    "FileDelta",
    "MANIFEST_FORMAT",
    "RETRAIN_MANIFEST",
    "RetrainManifest",
    "bucketed_random_effect_init",
    "build_delta_streaming_manifest",
    "dense_random_effect_init",
    "diff_files",
    "dirty_set_digest",
    "file_stat_token",
    "fixed_effect_init",
    "index_map_digest",
    "load_prior_manifest",
    "plan_delta",
    "probe_dirty_entities",
    "random_effect_entity_means",
    "seed_perhost_spilled_state",
    "seed_spilled_state",
]
