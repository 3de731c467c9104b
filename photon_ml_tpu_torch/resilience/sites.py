"""Registry of the port's resilience site names (the port's counterpart of
photon_ml_tpu/resilience/sites.py, holding the sites the port wires).

Every site string handed to :func:`faults.inject` / ``corrupt`` / ``flag``
and every preemption poll boundary of :func:`preemption.check` in
``photon_ml_tpu_torch`` is registered here, and every entry is used:
``tests/test_torch_checkpoint.py`` holds both directions. Dependency-free.
"""

from __future__ import annotations

from typing import Dict, Tuple

__all__ = ["FAULT_SITES", "PREEMPT_SITES"]

#: site -> where it fires; keys are the exact literals production code passes
FAULT_SITES: Dict[str, str] = {
    "io.read_block": "per Avro container block read (io/avro.py, io/avro_data.py)",
    "io.index_load": "index-map / off-heap store loads (io/index_map.py, io/offheap.py)",
    "io.cache_read": "tensor-cache entry reads and probes; a read fault that survives retries degrades to a miss (io/tensor_cache.py)",
    "io.cache_write": "tensor-cache entry commits; a write that stays broken raises RetryError and the drivers go on uncached (io/tensor_cache.py)",
    "io.cache_invalidate": "tensor-cache entry removal; a failure is a logged no-op (io/tensor_cache.py)",
    "io.checkpoint_write": "per checkpoint save attempt (checkpoint.py)",
    "multihost.barrier": "cross-process sync points (parallel/multihost.py)",
    "multihost.heartbeat": "per-host heartbeat writes (parallel/multihost.py)",
    "multihost.entity_route": "host-granular entity-routing exchange (parallel/shuffle.py)",
    "multihost.membership": "elastic fleet-membership reads/commits (parallel/elastic.py)",
    "multihost.replan_barrier": "elastic re-plan barrier entry; a failure that survives retries falls back to supervised relaunch (parallel/elastic.py)",
    "io.block_transfer": "delta block/state file copies during an elastic re-shard; a failed block copy degrades to a recorded cold rebuild (parallel/elastic.py)",
    "multihost.relaunch_replan": "relaunch-time re-plan of a smaller/larger cohort from plan sidecars; a failure degrades to a recorded full re-ingest (parallel/elastic.py)",
    "multihost.streaming_reduce": "exact cross-rank streaming merges: score scatters, FE chunk partials, reg terms; fired before the collective and retried (parallel/perhost_streaming.py)",
    "io.perhost_block_write": "per-host streaming entity-block writes, retried (parallel/perhost_streaming.py)",
    "optim.step": "coordinate-descent updates, NaN corruption (algorithm/coordinate_descent.py)",
    "retrain.multihost_delta_agree": "cross-rank delta-plan agreement; a disagreement or an injected fault on any rank degrades every rank to a recorded cold run (cli/game_multihost_driver.py)",
    "retrain.delta_plan": "delta-retrain prior manifest/model reads; failure degrades to a recorded cold run (retrain/manifest.py)",
    "optim.block_skip": "adaptive-schedule skip decision boundary; an injected fault degrades the epoch to visit-everything, never a silent skip (algorithm/bucketed_random_effect.py)",
    "optim.device_drain": "device-loop dispatch gate; an injected fault degrades the solve to the host chunk loop, bitwise (optim/scheduler.py)",
    "preempt.signal": "preemption polls; flags instead of raising (resilience/preemption.py)",
    "serve.dequant": "quantized-store open gate: scale-sidecar/budget validation before a bf16/int8 slab may serve (serve/model_store.py)",
    "serve.route": "fleet router request-routing entry (serve/fleet/router.py)",
    "serve.replica_scatter": "per sub-request dispatch to a slab-owner replica (serve/fleet/router.py)",
    "serve.fleet_swap_barrier": "fleet-wide swap generation barrier, between prepare-all and commit (serve/fleet/swap.py)",
    "serve.fleet_delta_rollout": "delta-retrain fleet rollout entry: export-manifest validation before the generation barrier; a failure aborts to the old generation (serve/fleet/swap.py)",
}

#: preemption poll boundaries (the safe drain points) accepted by
#: ``preemption.check`` and the ``PHOTON_PREEMPT_AT`` grammar
PREEMPT_SITES: Tuple[str, ...] = (
    "cycle",  # coordinate-descent update boundary
    "chunk",  # compacted-solver chunk boundary (optim/scheduler.py)
    "bucket",  # scheduled bucketed-RE bucket boundary (algorithm/bucketed_random_effect.py)
    "rung",  # device-loop rung-hop boundary (optim/fused_schedule.py)
    "block",  # streaming random-effect entity-block boundary (algorithm/streaming_random_effect.py)
)
