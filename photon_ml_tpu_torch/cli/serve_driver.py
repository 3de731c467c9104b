"""Online scoring server driver on the card (port of
photon_ml_tpu/cli/serve_driver.py).

Brings a persistent GAME scoring process up warm and serves JSON-lines
requests on stdin/stdout (photon_ml_tpu_torch/serve):

  1. resolve the model store (export a saved GAME model into the mmap'd
     serving layout if the store does not exist yet),
  2. score a zero batch at every (rows, nnz) ladder rung the request path
     can produce (warmup),
  3. log ``compile_stats.summary()``,
  4. serve; a ``{"cmd": "swap", "store_dir": ...}`` line rolls the model
     live through the by-reference swap path,
  5. at EOF or ``{"cmd": "shutdown"}``, log the serving stats summary.

The JAX driver's persistent XLA cache has no counterpart here: the command
line fences ``--persistent-cache``, and ``--assert-warm`` raises, as the
JAX driver does on a jax without the cache API.

Usage::

    python -m photon_ml_tpu_torch.cli.serve_driver \\
        --model-store-dir /models/store \\
        --game-model-input-dir /models/best \\
        --feature-shard-id-to-feature-section-keys-map \\
            "global:fixedFeatures|per_user:userFeatures" < requests.jsonl
"""

from __future__ import annotations

import sys
from typing import List, Optional

from photon_ml_tpu_torch.cli.game_params import GameServeParams, parse_serve_params
from photon_ml_tpu_torch.device import enable_determinism
from photon_ml_tpu_torch.utils.logging import PhotonLogger


class GameServeDriver:
    """Builds/opens the store, warms the server, runs the request loop."""

    def __init__(self, params: GameServeParams, logger: Optional[PhotonLogger] = None):
        params.validate()
        self.params = params
        self._own_logger = logger is None
        self.logger = logger or PhotonLogger(params.log_path)
        self.server = None
        self.swapper = None
        self.warm_report: Optional[dict] = None
        self.handled = 0

    # ------------------------------------------------------------------
    def resolve_store(self):
        from photon_ml_tpu_torch.compile import resolve_bucketer
        from photon_ml_tpu_torch.serve import ModelStore, build_model_store, is_model_store

        p = self.params
        if not is_model_store(p.model_store_dir):
            if not p.game_model_input_dir:
                raise ValueError(
                    f"{p.model_store_dir} is not a serve store and no "
                    "--game-model-input-dir was given to export from"
                )
            self.logger.info(
                f"exporting {p.game_model_input_dir} -> serve store "
                f"{p.model_store_dir}"
            )
            build_model_store(
                p.game_model_input_dir,
                p.model_store_dir,
                num_partitions=p.num_store_partitions,
                bucketer=resolve_bucketer(p.shape_canonicalization),
                store_dtype=p.store_dtype,
            )
        store = ModelStore(p.model_store_dir)
        self.logger.info(store.describe())
        fp = store.footprint()
        self.logger.info(
            f"store footprint: dtype {fp['store_dtype']}, "
            f"{fp['slab_bytes_disk']} slab bytes on disk, "
            f"{fp['mapped_bytes']} bytes mapped"
        )
        return store

    def start(self):
        """Everything up to (not including) the blocking request loop."""
        from photon_ml_tpu_torch.compile import compile_stats
        from photon_ml_tpu_torch.serve import ModelSwapper, ScoringServer

        p = self.params
        if p.persistent_cache_dir:
            self.logger.warn(
                "--persistent-cache requested, but the port keeps no compiled-graph "
                "cache across processes; serving uncached"
            )
        if p.assert_warm:
            # the JAX driver's error where jax has no cache API: with no
            # cache a start cannot be warm, so the gate cannot hold
            raise RuntimeError(
                "--assert-warm needs a working persistent cache (enabled=False) "
                "and the jax.monitoring compile listeners (installed="
                f"{compile_stats.install_xla_listeners()}) to be verifiable on "
                "this jax version"
            )
        store = self.resolve_store()
        if p.build_store_only:
            store.close()
            return None
        self.server = ScoringServer(
            store,
            shard_sections=p.feature_shard_sections,
            bucketer=p.shape_canonicalization,
            max_batch_rows=p.max_batch_rows,
            max_wait_ms=p.max_wait_ms,
            device=p.device,
        )
        self.swapper = ModelSwapper(self.server)
        if p.warmup:
            self.warm_report = self.server.warmup(warm_nnz=p.warm_nnz)
            self.logger.info(
                f"warmup: {self.warm_report['warm_batches']} batches over "
                f"row rungs {self.warm_report['row_rungs']} x nnz rungs "
                f"{self.warm_report['nnz_rungs']}; "
                f"{self.warm_report['new_traces']} new batch shapes"
            )
        self.logger.info(compile_stats.summary())
        return self.server

    def run(self, in_stream=None, out_stream=None) -> None:
        from photon_ml_tpu_torch.serve import serve_json_lines

        try:
            if self.start() is None:
                return  # --build-store-only
            self.logger.info(
                f"serving on {self.server.device} (max_batch_rows="
                f"{self.params.max_batch_rows}, max_wait_ms={self.params.max_wait_ms})"
            )
            self.handled = serve_json_lines(
                self.server,
                in_stream if in_stream is not None else sys.stdin,
                out_stream if out_stream is not None else sys.stdout,
                swapper=self.swapper,
            )
        finally:
            if self.server is not None:
                self.logger.info(self.server.stats.summary())
                if self.server.new_request_compiles():
                    self.logger.warn(
                        f"{self.server.new_request_compiles()} request-path "
                        "batch shapes first seen AFTER warmup — a request shape "
                        "escaped the warmed ladder (raise --warm-nnz or "
                        "--max-batch-rows)"
                    )
                self.server.close()
            if self._own_logger:
                self.logger.close()


def main(argv: Optional[List[str]] = None) -> GameServeDriver:
    enable_determinism()
    driver = GameServeDriver(parse_serve_params(argv))
    driver.run()
    return driver


if __name__ == "__main__":
    main()
