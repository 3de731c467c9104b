"""Online scoring service on the card: the persistent GAME request path
(port of photon_ml_tpu/serve/, one host; the fleet is not yet ported).

  * :mod:`.model_store` — mmap'd off-heap coefficient store (the
    ``io/offheap.py`` pmix machinery generalized from feature indices to
    coefficient slabs; entity -> slab-row hash probes in mapped memory).
    A store either package exports opens in the other.
  * :mod:`.quantize` — the f32 / bf16 / int8 slab policy under a pinned,
    export-verified error budget.
  * :mod:`.batcher` — request micro-batching onto the canonical shape
    ladder (bounded wait, padded batch, sliced responses).
  * :mod:`.server` — the scoring engine + JSON-lines request loop; scores
    are bitwise the batch ``game_scoring_driver``'s.
  * :mod:`.swap` — model rolls through the checkpoint by-reference
    protocol (no dropped requests, no new batch shapes).
  * :mod:`.stats` — p50/p99 latency, batch-fill ratio, QPS telemetry.

Driver: ``photon_ml_tpu_torch.cli.serve_driver``.
"""

from __future__ import annotations

from photon_ml_tpu_torch.serve.batcher import MicroBatcher, RowBatch
from photon_ml_tpu_torch.serve.model_store import (
    ModelStore,
    build_model_store,
    is_model_store,
)
from photon_ml_tpu_torch.serve.quantize import STORE_DTYPES
from photon_ml_tpu_torch.serve.server import ScoringServer, serve_json_lines
from photon_ml_tpu_torch.serve.stats import FleetStats, ServeStats, serve_stats
from photon_ml_tpu_torch.serve.swap import ModelSwapper

__all__ = [
    "FleetStats",
    "MicroBatcher",
    "ModelStore",
    "ModelSwapper",
    "RowBatch",
    "STORE_DTYPES",
    "ScoringServer",
    "ServeStats",
    "build_model_store",
    "is_model_store",
    "serve_json_lines",
    "serve_stats",
]
