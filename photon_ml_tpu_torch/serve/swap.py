"""Zero-downtime model roll for the scoring server (port of
photon_ml_tpu/serve/swap.py).

Production GLMix retrains daily; a server must pick the new model up
WITHOUT a restart (a restart pays model load + warmup and drops every open
connection). The swapper rolls a live :class:`~photon_ml_tpu_torch.serve.
server.ScoringServer` to a new :class:`~photon_ml_tpu_torch.serve.
model_store.ModelStore` through the checkpoint by-reference protocol
(:func:`photon_ml_tpu_torch.checkpoint.rebuild_from_ref` — the same path a
streaming checkpoint's spilled-state leaves restore through):

  1. REBUILD: the new store opens from its ref (a handful of mmaps; a
     stale/missing ref raises ``CheckpointRefError`` — the old model keeps
     serving).
  2. VALIDATE: coordinate names, feature dims, slab dtypes and padded slab
     shapes are compared against the live bundle. Matching shapes (the
     point of padding slab rows up the shape ladder) mean the new model
     meets only batch shapes the server has seen.
  3. UPLOAD + FLIP: device tensors are prepared OUTSIDE the lock, then the
     current-bundle pointer flips atomically. Requests featurized against
     the old generation stay PINNED to it through the batcher (their
     entity rows index the old slab layout), so nothing is dropped or
     mis-scored mid-roll.
  4. PROBE + RETIRE: a zero batch scored against the new bundle proves the
     no-new-shapes claim (watermark-asserted); after a drain fence the old
     store's mmaps close. The old generation's device tensors are freed
     when the last batch pinned to it lets go of its bundle.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional, Union

from photon_ml_tpu_torch.checkpoint import CheckpointRefError, rebuild_from_ref
from photon_ml_tpu_torch.compile import compile_stats
from photon_ml_tpu_torch.serve.model_store import (
    STORE_FORMAT,
    STORE_VERSION,
    ModelStore,
)
from photon_ml_tpu_torch.serve.server import ScoringServer

logger = logging.getLogger(__name__)


class ModelSwapper:
    """Serialized (one roll at a time) model swaps for one server."""

    def __init__(self, server: ScoringServer, drain_timeout_s: float = 60.0):
        self.server = server
        self.drain_timeout_s = drain_timeout_s

    def _resolve(self, target: Union[str, dict]) -> ModelStore:
        """A store dir or a checkpoint ref -> an opened ModelStore, via the
        by-reference rebuild (the current store is the template leaf)."""
        ref = (
            target
            if isinstance(target, dict)
            else {
                "kind": STORE_FORMAT,
                "version": STORE_VERSION,
                "store_dir": os.path.abspath(str(target)),
            }
        )
        return rebuild_from_ref(self.server.store, ref)

    def validate_compatible(self, new_store: ModelStore) -> list:
        """Shape/coordinate mismatches vs the live model (each one is a
        new batch shape or a refused swap; empty = a roll that meets only
        seen shapes)."""
        cur = self.server.store
        problems = []
        if cur.store_dtype != new_store.store_dtype:
            problems.append(
                f"store dtype changed: {cur.store_dtype} -> "
                f"{new_store.store_dtype} (the gather meets a new slab "
                "dtype; the first post-swap batch is a new shape)"
            )
        if sorted(cur.feature_maps) != sorted(new_store.feature_maps):
            problems.append(
                f"feature shards changed: {sorted(cur.feature_maps)} -> "
                f"{sorted(new_store.feature_maps)}"
            )
        for shard in set(cur.feature_maps) & set(new_store.feature_maps):
            if len(cur.feature_maps[shard]) != len(new_store.feature_maps[shard]):
                problems.append(
                    f"shard {shard!r} dim {len(cur.feature_maps[shard])} -> "
                    f"{len(new_store.feature_maps[shard])}"
                )
        cur_re = {r.name: r for r in cur.random}
        new_re = {r.name: r for r in new_store.random}
        if sorted(cur_re) != sorted(new_re):
            problems.append(
                f"random-effect coordinates changed: {sorted(cur_re)} -> "
                f"{sorted(new_re)}"
            )
        for name in set(cur_re) & set(new_re):
            if cur_re[name].slab.shape != new_re[name].slab.shape:
                problems.append(
                    f"coordinate {name!r} slab {cur_re[name].slab.shape} -> "
                    f"{new_re[name].slab.shape} (entity count crossed a "
                    "ladder rung; the first post-swap batch is a new shape)"
                )
        if [f.name for f in cur.fixed] != [f.name for f in new_store.fixed]:
            problems.append(
                f"fixed-effect coordinates changed: "
                f"{[f.name for f in cur.fixed]} -> "
                f"{[f.name for f in new_store.fixed]}"
            )
        return problems

    def swap(
        self,
        target: Union[str, dict],
        require_compatible: bool = False,
        probe: bool = True,
        retire_old: bool = True,
    ) -> dict:
        """Roll the server to ``target`` (store dir or checkpoint ref).

        Returns a report: ``{"generation", "store_dir", "shape_compatible",
        "problems", "new_compiles", "dropped_requests"}`` —
        ``dropped_requests`` is definitionally 0 (pinned generations), kept
        in the report so monitoring has the explicit claim to alert on.
        """
        new_store = self._resolve(target)
        problems = self.validate_compatible(new_store)
        if problems and require_compatible:
            new_store.close()
            raise CheckpointRefError(
                "refusing incompatible swap: " + "; ".join(problems)
            )
        for p in problems:
            logger.warning("model swap shape change: %s", p)

        old_bundle = self.server.install_bundle(new_store)
        new_compiles = 0
        if probe:
            # prove the claim NOW (not on the first unlucky request): one
            # zero batch at the smallest warmed rung through the new
            # bundle. The watermark brackets ONLY the probe — a concurrent
            # request's documented first sight (nnz past the warmed rungs)
            # must not be booked as the swap's.
            wm = compile_stats.watermark()
            self._probe(self.server.model)
            new_compiles = wm.new_traces()
        if retire_old:
            # per-generation fence: waits only on requests pinned to the
            # OLD bundle (new-generation traffic cannot starve it — a
            # busy server still retires the old store promptly). The
            # drain->retire pair loops because a submit that read the old
            # bundle pre-flip may pin it between the two; retire_if_idle
            # is atomic, so once it returns True no pin can follow.
            deadline = time.monotonic() + self.drain_timeout_s
            retired = False
            while not retired:
                remaining = deadline - time.monotonic()
                if not old_bundle.drain(max(remaining, 0.0)):
                    break
                retired = old_bundle.retire_if_idle()
            if retired:
                old_bundle.store.close()
            else:
                logger.warning(
                    "old model generation %d still has in-flight requests "
                    "after %.0fs; leaving its store open",
                    old_bundle.generation, self.drain_timeout_s,
                )
        report = {
            "generation": self.server.model.generation,
            "store_dir": new_store.store_dir,
            "shape_compatible": not problems,
            "problems": problems,
            "new_compiles": int(new_compiles),
            "dropped_requests": 0,
        }
        self.server.stats.record_swap(int(new_compiles))
        logger.info(
            "model swap -> generation %d (%s; %d new shapes)",
            report["generation"],
            "shape-compatible" if not problems else "SHAPES CHANGED",
            report["new_compiles"],
        )
        return report

    def _probe(self, bundle) -> None:
        server = self.server
        n = server._ladder_rungs(1, 1)[0] if server.bucketer else 1
        k = server.bucketer.canon(1) if server.bucketer else 1
        server._score_with(bundle, server._zero_batch(bundle, n, k))
