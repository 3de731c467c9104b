"""GAME (GLMix) training driver on the card (port of
photon_ml_tpu/cli/game_training_driver.py for fixed-effect, random-effect
and factored random-effect coordinates).

Reference spec: cli/game/training/Driver.scala:64-537 — prepare feature maps
(``--offheap-indexmap-dir`` maps from feature_indexing, a NameAndTerm
vocabulary, or a whole-dataset scan of the Avro inputs), resolve dated
input dirs, load the GAME data (native Avro decoder), build the
per-coordinate datasets, build the evaluators, train every combination of
the ';'-separated optimization grids by coordinate descent, pick the best by
the first evaluator, save the model in the reference's on-disk layout
(``best/fixed-effect/<name>/``, ``best/random-effect/<name>/``; every combo
under ``all/<i>/`` with ``--model-output-mode ALL``). Same flag names and log
lines as the JAX driver; tensors live on ``--device`` (default cuda).

A dense fixed effect solves through the fused CUDA value+gradient kernel on
the card; a fixed-effect shard wider than ``DENSE_DIM_THRESHOLD`` features
trains on padded-COO ``SparseFeatures``; a down-sampling rate below 1
zeroes the weights of the rows it drops; ``PHOTON_ML_TPU_FUSED=auto`` (the
default) races the fused kernel against two matmuls for each dense fixed
effect. With ``PHOTON_SPARSE_KERNEL=pallas`` the random effects solve over
sparse slabs through the CUDA GEVM/HVP kernels; ``auto`` races the families
and the dense stack per dataset. ``--bucketed-random-effects true`` solves
each random effect in size buckets (``--shape-canonicalization`` pads every
bucket and slab width up a geometric ladder), one race per bucket under
``auto``; with ``--checkpoint-dir`` the race winners are kept beside the
steps (``races.json``) and a resumed run takes them. A
factored coordinate (``--factored-random-effect-optimization-
configurations``) factors its IDENTITY dataset and is saved both flattened
and as latent factors. ``--vmapped-grid true|auto`` trains a lambda-only
grid through ``CoordinateDescent.run_grid`` on coordinates built once.
``--solve-compaction`` runs every random-effect solve convergence-compacted
(``device[:CHUNK]``: the rung loop, captured CUDA graphs on the card) and
``--adaptive-schedule`` skips converged buckets, both resolved once by the
execution plan (compile/plan.py); the run logs the capture and solve
ledgers. ``--streaming-random-effects true`` writes each random effect's
entity blocks once under ``<output>/streaming-re/<coord>`` (sized by
``--re-memory-budget-mb``, else 1024 entities a block) and streams them
through the pipelined block loop (algorithm/streaming_random_effect.py);
its state is spilled to ``<output>/streaming-re-state/``. ``--tensor-cache
DIR`` keeps the decoded training columns, each in-memory random-effect
dataset and each coordinate's entity blocks in a content-addressed cache
(io/tensor_cache.py, the JAX package's keys and layout): a warm run skips
the Avro decode (the feature-key scan still runs) and the builds. ``--checkpoint-dir`` saves the descent after every coordinate update (every
iteration on the grid path) and resumes from it; a preemption (SIGTERM/
SIGINT, ``PHOTON_PREEMPT_AT``) drains to the next boundary (inside a scheduled
update: its chunk, rung or bucket boundary), then relaunches
in-process (``--max-restarts``) or exits with code 75 (a streaming update
drains at its block boundaries too). The run leaves
``retrain.json`` at the output root, as the JAX driver does.

``--warm-start-from PRIOR_OUTPUT_DIR`` runs the daily retrain loop
(retrain/): the delta planner diffs the training files against the prior
run's ``retrain.json``; an all-unchanged rerun copies the prior model
forward with no ingest and no solve; otherwise every coordinate warm-starts
from the prior model, unchanged coordinates are frozen, and a dirty
streaming random effect pins the prior blocking, reusing and freezing its
unchanged blocks. Any unusable prior degrades to a logged cold run.
``--plan auto`` lets the cost model (compile/cost.py) choose the knobs left
unset and writes ``cost-model.json`` beside ``retrain.json``; the next run
reads it from the ``--warm-start-from`` dir, else from its own output dir.

    python -m photon_ml_tpu_torch.cli.game_training_driver \\
      --train-input-dirs data/train --validate-input-dirs data/val \\
      --output-dir out --task-type LOGISTIC_REGRESSION \\
      --feature-shard-id-to-feature-section-keys-map "global:features|per_user:userFeatures" \\
      --updating-sequence fixed,per-user \\
      --fixed-effect-data-configurations "fixed:global,1" \\
      --random-effect-data-configurations "per-user:userId,per_user,1,-1,-1,-1,INDEX_MAP" \\
      --fixed-effect-optimization-configurations "fixed:50,1e-7,0.01,1,LBFGS,L2" \\
      --random-effect-optimization-configurations "per-user:40,1e-6,0.1,1,LBFGS,L2" \\
      --evaluator-type AUC --num-iterations 2 --checkpoint-dir out/ckpt
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import shutil
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.algorithm.bucketed_random_effect import (
    BucketedDatasetBundle,
    BucketedRandomEffectCoordinate,
)
from photon_ml_tpu_torch.algorithm.coordinate_descent import (
    CoordinateDescent,
    CoordinateDescentResult,
)
from photon_ml_tpu_torch.algorithm.factored_random_effect import (
    FactoredRandomEffectCoordinate,
    FactoredState,
    MFOptimizationConfig,
)
from photon_ml_tpu_torch.algorithm.fixed_effect import FixedEffectCoordinate
from photon_ml_tpu_torch.algorithm.random_effect import (
    RandomEffectCoordinate,
    global_coefficients,
)
from photon_ml_tpu_torch.algorithm.streaming_random_effect import (
    SpilledREState,
    StreamingREManifest,
    StreamingRandomEffectCoordinate,
    write_re_entity_blocks,
)
from photon_ml_tpu_torch.checkpoint import CoordinateDescentCheckpointer, fingerprint
from photon_ml_tpu_torch.checkpoint_async import maybe_async
from photon_ml_tpu_torch.compile import compile_stats
from photon_ml_tpu_torch.compile.plan import ExecutionPlan
from photon_ml_tpu_torch.cli.game_params import (
    CoordinateOptConfig,
    GameTrainingParams,
    parse_training_params,
)
from photon_ml_tpu_torch.data.game import (
    GameData,
    build_fixed_effect_batch,
    build_random_effect_dataset,
    game_data_from_arrays,
    game_data_to_arrays,
    padded_row_coo,
)
from photon_ml_tpu_torch.device import enable_determinism, resolve_device
from photon_ml_tpu_torch import resilience
from photon_ml_tpu_torch.resilience import preemption
from photon_ml_tpu_torch.resilience.guards import DivergenceGuard
from photon_ml_tpu_torch import retrain
from photon_ml_tpu_torch.retrain.manifest import (
    CoordinateRecord,
    RetrainManifest,
    file_stat_token,
    index_map_digest,
)
from photon_ml_tpu_torch.evaluation.evaluators import Evaluator, EvaluatorType, evaluator_for
from photon_ml_tpu_torch.io import avro_data, model_io
from photon_ml_tpu_torch.io.index_map import IndexMap
from photon_ml_tpu_torch.io.name_and_term import NameAndTermFeatureSetContainer
from photon_ml_tpu_torch.io.offheap import load_shard_index_map
from photon_ml_tpu_torch.models.game import gather_scores
from photon_ml_tpu_torch.ops import losses as losses_mod
from photon_ml_tpu_torch.ops.features import DenseFeatures
from photon_ml_tpu_torch.ops import fused_glm, fused_sparse
from photon_ml_tpu_torch.ops.fused_glm import select_fused_block_rows
from photon_ml_tpu_torch.optim.common import OptResult, summarize_result, summarize_stacked_results
from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.optim.scheduler import solve_stats
from photon_ml_tpu_torch.types import ModelOutputMode, TaskType
from photon_ml_tpu_torch.utils.date_range import DateRange, expand_date_range_paths
from photon_ml_tpu_torch.utils.io_utils import prepare_output_dir
from photon_ml_tpu_torch.utils.logging import PhotonLogger
from photon_ml_tpu_torch.utils.profiling import maybe_trace
from photon_ml_tpu_torch.utils.timer import Timer

DENSE_DIM_THRESHOLD = 4096
BEST_MODEL_DIR = "best"
ALL_MODELS_DIR = "all"
RACES_FILE = "races.json"  # in --checkpoint-dir: the run's race decisions


def _summarize_tracker(tracker) -> str:
    """Per-coordinate convergence summary of the last update's OptResult
    (RandomEffectOptimizationTracker.scala:62-95 for lane-batched solves);
    a bucketed coordinate's tuple gives one summary per bucket."""
    # OptResult is a NamedTuple: test for it before the bucketed tuple
    if isinstance(tracker, OptResult):
        if tracker.reason.dim() >= 1:
            return summarize_stacked_results(tracker)
        return summarize_result(tracker)
    if isinstance(tracker, tuple):
        parts = [_summarize_tracker(t) for t in tracker]
        return " | ".join(f"bucket{j}: {s}" for j, s in enumerate(parts) if s)
    return ""


def _input_files(dirs: List[str]) -> List[str]:
    files = []
    for d in dirs:
        if os.path.isfile(d):
            files.append(d)
        else:
            files.extend(os.path.join(d, f) for f in sorted(os.listdir(d))
                         if not f.startswith((".", "_")))
    return files


def resolve_date_range_dirs(
    dirs: List[str],
    date_range: Optional[str],
    days_ago: Optional[str],
) -> List[str]:
    """Expand input dirs into their daily/yyyy/MM/dd subdirs within the
    requested range (IOUtils.scala:85-130 discovery); no range -> unchanged."""
    if not date_range and not days_ago:
        return dirs
    dr = DateRange.from_string(date_range) if date_range else DateRange.from_days_ago(days_ago)
    out: List[str] = []
    for d in dirs:
        try:
            out.extend(expand_date_range_paths(d, dr))
        except FileNotFoundError:
            pass  # an error only if the union over ALL dirs is empty (IOUtils parity)
    if not out:
        raise FileNotFoundError(
            f"no daily inputs under any of {dirs} within {dr.start}..{dr.end}"
        )
    return out


def io_resilience_config(on_corrupt: str, corrupt_skip_budget: int, io_retries: int,
                         io_retry_base_delay: Optional[float] = None):
    """The process-wide ingest settings from a driver's flags: the flags set
    the attempts (and the base delay); the rest of the retry policy keeps
    its environment-tunable defaults (PHOTON_IO_RETRY_*)."""
    policy = dataclasses.replace(resilience.RetryPolicy.io_default(), max_attempts=io_retries)
    if io_retry_base_delay is not None:
        policy = dataclasses.replace(policy, base_delay=io_retry_base_delay)
    return resilience.ResilienceConfig(on_corrupt=on_corrupt,
                                       corrupt_skip_budget=corrupt_skip_budget,
                                       io_policy=policy)


def _default_evaluators(task: TaskType):
    default = {
        TaskType.LOGISTIC_REGRESSION: EvaluatorType.AUC,
        TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: EvaluatorType.AUC,
        TaskType.LINEAR_REGRESSION: EvaluatorType.RMSE,
        TaskType.POISSON_REGRESSION: EvaluatorType.POISSON_LOSS,
    }[task]
    return [(default, None, None)]


class GameTrainingDriver:
    """Builds coordinates from params and data, runs coordinate descent,
    saves the model."""

    def __init__(self, params: GameTrainingParams, logger: Optional[PhotonLogger] = None):
        params.validate()
        self.params = params
        self.device = resolve_device(params.device)
        # one execution plan resolves the shape ladder, the solve schedule
        # (ladder-bound) and the adaptive schedule, and records every
        # composition decision. The ladder is None when off (the flag's
        # default): it pads every bucket and every slab width the driver
        # builds; the driver never reads PHOTON_SHAPE_LADDER
        self.plan = ExecutionPlan.resolve(
            shape_canonicalization=params.shape_canonicalization,
            solve_compaction=params.solve_compaction,
            adaptive_schedule=params.adaptive_schedule,
            bucketed=params.bucketed_random_effects,
            vmapped_grid=params.vmapped_grid,
            streaming=params.streaming_random_effects,
            plan=params.plan,
            # warm starts inherit the prior run's realized costs; cold runs
            # read back their own sidecar on the next invocation
            cost_model_dir=(params.warm_start_from or params.output_dir))
        self.bucketer = self.plan.bucketer
        self.solve_schedule = self.plan.schedule
        self._race_mark = len(fused_glm.race_log)  # where this run's race decisions start
        self._own_logger = logger is None
        self.logger = logger or PhotonLogger(
            os.path.join(params.output_dir, "photon-ml-tpu-game.log")
        )
        self.timer = Timer(self.logger.info)
        self.shard_index_maps: Dict[str, IndexMap] = {}
        self.train_data: Optional[GameData] = None
        self.validation_data: Optional[GameData] = None
        self.re_datasets: Dict[str, object] = {}
        # bucketed coordinates' per-bucket datasets, built once, shared by combos
        self.bucketed_bundles: Dict[str, BucketedDatasetBundle] = {}
        # --streaming-random-effects: each coordinate's entity-block layout
        self.streaming_manifests: Dict[str, object] = {}
        self._stream_state_seq = 0
        # tensor-cache keys for retrain.json
        self._coord_cache_keys: Dict[str, Optional[str]] = {}
        self._data_cache_key: Optional[str] = None
        self.fe_batches: Dict[str, object] = {}
        # (config map, CoordinateDescentResult, final validation metrics)
        self.results: List[Tuple[Dict[str, CoordinateOptConfig], CoordinateDescentResult,
                                 Dict[str, float]]] = []
        self.combo_coords: List[Dict[str, object]] = []
        self.best_index: int = 0
        # identity of the inputs for retrain.json, taken before ingest
        self._train_file_stats: Optional[list] = None
        self._eval_identity_cache: Optional[Dict[str, object]] = None
        # --- the delta retrain (retrain/) -------------------------------
        self.retrain_prior = None  # the prior run's RetrainManifest, or None
        self.delta_plan = None  # the resolved DeltaPlan, or None: a cold run
        self.block_deltas: Dict[str, list] = {}  # streaming coord -> [BlockDelta]
        self._train_files: List[str] = []
        self._frozen_blocks: Dict[str, frozenset] = {}  # coord -> skip set
        self._warm_fixed: Dict[str, np.ndarray] = {}
        self._warm_dense_re: Dict[str, np.ndarray] = {}
        self._warm_spilled: Dict[str, SpilledREState] = {}
        self._warm_bucketed: Dict[str, list] = {}  # coord -> per-bucket stacks
        self._warm_means_cache: Dict[str, Optional[dict]] = {}

    # ------------------------------------------------------------------
    def _shard_ids(self) -> List[str]:
        p = self.params
        shards = {spec.feature_shard_id for spec in p.fixed_effect_data_configs.values()}
        shards |= {cfg.feature_shard_id for cfg in p.random_effect_data_configs.values()}
        return sorted(shards)

    def _train_dirs(self) -> List[str]:
        p = self.params
        return resolve_date_range_dirs(p.train_input_dirs, p.train_date_range,
                                       p.train_date_range_days_ago)

    def _validate_dirs(self) -> List[str]:
        p = self.params
        return resolve_date_range_dirs(p.validate_input_dirs or [], p.validate_date_range,
                                       p.validate_date_range_days_ago)

    def prepare_feature_maps(self) -> None:
        """GAMEDriver.prepareFeatureMaps: one index map per feature shard,
        from ``--offheap-indexmap-dir`` (:76-82), else a NameAndTerm
        vocabulary, else a whole-dataset scan of the training inputs
        (:49-69), in that order."""
        p = self.params
        nt_container = None
        if p.feature_name_and_term_set_path and not p.offheap_indexmap_dir:
            # every shard's sections, with the "features" default of an
            # unconfigured shard, so no shard gets an empty vocabulary
            all_sections = sorted({s for shard in self._shard_ids()
                                   for s in (p.feature_shard_sections.get(shard) or ["features"])})
            nt_container = NameAndTermFeatureSetContainer.read_from_text(
                p.feature_name_and_term_set_path, all_sections)
        paths = None
        for shard in self._shard_ids():
            sections = p.feature_shard_sections.get(shard) or ["features"]
            add_intercept = p.feature_shard_intercepts.get(shard, True)
            if p.offheap_indexmap_dir:
                self.shard_index_maps[shard] = load_shard_index_map(p.offheap_indexmap_dir, shard)
            elif nt_container is not None:
                self.shard_index_maps[shard] = nt_container.index_map(sections, add_intercept)
            else:
                paths = paths or _input_files(self._train_dirs())
                keys = avro_data.collect_feature_keys(paths, sections)
                self.shard_index_maps[shard] = IndexMap.build(keys, add_intercept)
            self.logger.info(
                f"feature shard {shard!r}: {len(self.shard_index_maps[shard])} features"
            )

    def _id_types(self) -> List[str]:
        """Random-effect grouping ids and any id column an evaluator needs."""
        ids = {cfg.random_effect_id for cfg in self.params.random_effect_data_configs.values()}
        ids |= {id_name for _, _, id_name in self.params.evaluators if id_name}
        return sorted(ids)

    def _tensor_cache(self):
        """The --tensor-cache store (made on first use), or None."""
        if not self.params.tensor_cache_dir:
            return None
        if not hasattr(self, "_tensor_cache_obj"):
            from photon_ml_tpu_torch.io.tensor_cache import TensorCache

            self._tensor_cache_obj = TensorCache(self.params.tensor_cache_dir)
        return self._tensor_cache_obj

    def _ingest_cache_config(self) -> Dict[str, object]:
        """The ingest part of every tensor-cache key (the JAX driver's
        fields): anything that changes the decoded columns, the feature
        index assignment or the padded shapes changes the key."""
        p = self.params
        return {
            "sections": p.feature_shard_sections,
            "intercepts": p.feature_shard_intercepts,
            "id_types": self._id_types(),
            "ladder": self.bucketer.spec() if self.bucketer is not None else None,
            "index_maps": {shard: index_map_digest(imap)
                           for shard, imap in sorted(self.shard_index_maps.items())},
        }

    def _next_stream_state_seq(self) -> int:
        self._stream_state_seq += 1
        return self._stream_state_seq

    def _read_train_data(self, train_files: List[str]) -> None:
        """The training columns: a tensor-cache hit, or the Avro decode
        (then stored when a cache is set)."""
        p = self.params
        cache = self._tensor_cache()
        train_key = (cache.key_for(train_files, {"kind": "game_data",
                                                 **self._ingest_cache_config()})
                     if cache is not None else None)
        self._data_cache_key = train_key
        if (cache is not None and self.retrain_prior is not None
                and self.retrain_prior.data_cache_key
                and self.retrain_prior.data_cache_key != train_key):
            # cache hygiene: the prior run's whole-set ingest entry can never
            # be addressed again (its file stats are history). Streaming-block
            # entries are kept: the prior block layout may be one
            if cache.invalidate(self.retrain_prior.data_cache_key):
                self.logger.info(
                    "tensor cache: invalidated superseded prior ingest "
                    f"entry {self.retrain_prior.data_cache_key[:12]}"
                )
        hit = cache.get(train_key) if cache is not None else None
        if hit is not None:
            self.train_data = game_data_from_arrays(hit.arrays, hit.meta)
            self.logger.info(f"tensor cache HIT {train_key[:12]}: Avro decode skipped")
            return
        self.train_data = avro_data.read_game_data(
            train_files, self.shard_index_maps,
            p.feature_shard_sections, self._id_types(),
            shard_intercepts=p.feature_shard_intercepts or None,
        )
        if cache is not None:
            from photon_ml_tpu_torch.resilience import RetryError

            try:
                arrays, meta = game_data_to_arrays(self.train_data)
                cache.put(train_key, arrays, meta)
                self.logger.info(f"tensor cache stored {train_key[:12]}")
            except RetryError as e:
                self.logger.info(f"tensor cache write failed (uncached): {e}")

    def _write_streaming_blocks(self, name: str, cfg, train_files: List[str]) -> None:
        """Write coordinate ``name``'s entity blocks once (each built and
        released in turn); every combo streams the same blocks."""
        p = self.params
        cache = self._tensor_cache()
        budget = int(p.re_memory_budget_mb * 1e6) if p.re_memory_budget_mb is not None else None
        block_key = (cache.key_for(train_files, {
            "kind": "streaming_re_blocks", "coord": name, "config": dataclasses.asdict(cfg),
            "budget": budget, **self._ingest_cache_config()}) if cache is not None else None)
        self._coord_cache_keys[name] = block_key
        if self._delta_streaming_build(name, cfg, budget, cache, train_files):
            return
        manifest = write_re_entity_blocks(
            self.train_data, cfg, os.path.join(p.output_dir, "streaming-re", name),
            # `is None`, not falsy: a zero budget must not pass both sizing modes
            block_entities=None if budget is not None else 1024,
            memory_budget_bytes=budget, bucketer=self.bucketer or "off",
            tensor_cache=cache, cache_key=block_key)
        self.streaming_manifests[name] = manifest
        self.logger.info(f"streaming RE {name}: {len(manifest.blocks)} blocks, max resident "
                         f"slab {manifest.max_block_bytes}B")

    def _cached_re_dataset(self, name: str, cfg, train_files: List[str]):
        """An in-memory random-effect dataset through the tensor cache."""
        cache = self._tensor_cache()
        re_key = (cache.key_for(train_files, {"kind": "re_dataset", "coord": name,
                                              "config": dataclasses.asdict(cfg),
                                              **self._ingest_cache_config()})
                  if cache is not None else None)
        self._coord_cache_keys[name] = re_key
        prior_rec = (self.retrain_prior.coordinates.get(name)
                     if self.retrain_prior is not None else None)
        if (cache is not None and prior_rec is not None and prior_rec.kind == "random"
                and prior_rec.cache_key and prior_rec.cache_key != re_key):
            # a superseded in-memory dataset entry (warm starts read the
            # saved model, never the cached dataset)
            cache.invalidate(prior_rec.cache_key)
        return build_random_effect_dataset(self.train_data, cfg, device=self.device,
                                           tensor_cache=cache, cache_key=re_key)

    def prepare_datasets(self) -> None:
        """Read the training (and validation) rows, then build each
        coordinate's tensors on the device; each step is a timer span."""
        p = self.params
        # the file list the delta plan and the manifest's stat tokens came
        # from: one file set for plan, ingest and retrain.json
        train_files = self._train_files or _input_files(self._train_dirs())
        self._train_files = train_files
        with self.timer.measure("read-train-data"):
            self._read_train_data(train_files)
        self.logger.info(f"training rows: {self.train_data.num_rows}")
        if p.validate_input_dirs:
            with self.timer.measure("read-validation-data"):
                self.validation_data = avro_data.read_game_data(
                    _input_files(self._validate_dirs()), self.shard_index_maps,
                    p.feature_shard_sections, self._id_types(),
                    shard_intercepts=p.feature_shard_intercepts or None,
                    id_vocabs=self.train_data.id_vocabs,
                )
            self.logger.info(f"validation rows: {self.validation_data.num_rows}")
        with self.timer.measure("build-fixed-effect-batches"):
            for name, spec in p.fixed_effect_data_configs.items():
                self.fe_batches[name] = build_fixed_effect_batch(
                    self.train_data, spec.feature_shard_id,
                    dense=self._dense(spec.feature_shard_id), device=self.device,
                )
        with self.timer.measure("build-random-effect-datasets"):
            for name, cfg in p.random_effect_data_configs.items():
                if p.streaming_random_effects and name not in p.factored_configs:
                    self._write_streaming_blocks(name, cfg, train_files)
                    continue
                if p.bucketed_random_effects and name not in p.factored_configs:
                    # a bucketed coordinate owns per-bucket stacks: the one
                    # globally padded stack is what bucketing avoids
                    self.bucketed_bundles[name] = BucketedDatasetBundle.build(
                        self.train_data, cfg, bucketer=self.bucketer or "off",
                        device=self.device)
                    shapes = [tuple(ds.x.shape) for ds in self.bucketed_bundles[name].datasets]
                    self.logger.info(f"bucketed RE {name}: {len(shapes)} buckets, "
                                     f"(E, M, D) {shapes}")
                    continue
                if name in p.factored_configs and cfg.projector != "IDENTITY":
                    # the factored coordinate factors the unprojected dataset
                    cfg = dataclasses.replace(cfg, projector="IDENTITY")
                self.re_datasets[name] = self._cached_re_dataset(name, cfg, train_files)

    def _dense(self, shard: str) -> bool:
        """A fixed-effect shard's layout: dense up to the threshold."""
        return len(self.shard_index_maps[shard]) <= DENSE_DIM_THRESHOLD

    def _build_coordinates(self, opt_configs: Dict[str, CoordinateOptConfig]) -> Dict[str, object]:
        """Coordinates in updating-sequence order
        (cli/game/training/Driver.scala:344-402)."""
        p = self.params
        coords: Dict[str, object] = {}
        for name in p.updating_sequence:
            cfg = opt_configs.get(name, CoordinateOptConfig())
            if name in p.fixed_effect_data_configs:
                batch = self.fe_batches[name]
                block_rows = None
                if isinstance(batch.features, DenseFeatures):
                    # the fused value+gradient kernel on the card; None on a CPU
                    block_rows = select_fused_block_rows(
                        losses_mod.for_task(p.task_type), batch.num_rows, batch.dim,
                        batch.features.matrix.dtype, self.device)
                coords[name] = FixedEffectCoordinate(
                    batch,
                    GLMOptimizationProblem(
                        task=p.task_type,
                        optimizer=cfg.optimizer,
                        optimizer_config=cfg.optimizer_config(),
                        regularization=cfg.regularization_context(),
                        fused_block_rows=block_rows,
                    ),
                    down_sampling_rate=(
                        cfg.down_sampling_rate if cfg.down_sampling_rate < 1.0 else None),
                )
            elif name in p.factored_configs:
                spec = p.factored_configs[name]
                coords[name] = FactoredRandomEffectCoordinate(
                    self.re_datasets[name],
                    p.task_type,
                    mf_config=MFOptimizationConfig(spec.mf_num_iterations, spec.latent_dim),
                    re_optimizer=spec.random_effect.optimizer,
                    re_optimizer_config=spec.random_effect.optimizer_config(),
                    re_regularization=spec.random_effect.regularization_context(),
                    latent_optimizer=spec.latent_factor.optimizer,
                    latent_optimizer_config=spec.latent_factor.optimizer_config(),
                    latent_regularization=spec.latent_factor.regularization_context(),
                )
            elif name in self.streaming_manifests:
                coords[name] = StreamingRandomEffectCoordinate(
                    manifest=self.streaming_manifests[name],
                    task=p.task_type,
                    optimizer=cfg.optimizer,
                    optimizer_config=cfg.optimizer_config(),
                    regularization=cfg.regularization_context(),
                    # the plan carries the schedule, sparse spec and prefetch depth
                    plan=self.plan,
                    device=self.device,
                    # the delta retrain's unchanged blocks skip their solves
                    # (empty or None on a cold run)
                    frozen_blocks=self._frozen_blocks.get(name),
                    # a warm delta retrain seeds the convergence ledger from
                    # the prior run's record (a sidecar beside the manifest
                    # still wins inside the coordinate)
                    ledger_seed=(self.retrain_prior.coordinates[name].convergence_ledger
                                 if self.retrain_prior is not None
                                 and name in self.retrain_prior.coordinates else None),
                    # spilled state under this run's output dir, never in a
                    # (possibly shared, cache-resident) manifest dir; one per
                    # coordinate instance, so grid combos never share one
                    state_root=os.path.join(
                        p.output_dir, "streaming-re-state",
                        f"{name}-{os.getpid()}-{self._next_stream_state_seq()}"),
                )
            elif name in self.bucketed_bundles:
                coords[name] = BucketedRandomEffectCoordinate(
                    self.train_data,
                    p.random_effect_data_configs[name],
                    p.task_type,
                    optimizer=cfg.optimizer,
                    optimizer_config=cfg.optimizer_config(),
                    regularization=cfg.regularization_context(),
                    bundle=self.bucketed_bundles[name],
                    solve_schedule=self.solve_schedule,
                    adaptive=self.plan.adaptive,
                )
            else:
                coords[name] = RandomEffectCoordinate(
                    self.re_datasets[name],
                    p.task_type,
                    optimizer=cfg.optimizer,
                    optimizer_config=cfg.optimizer_config(),
                    regularization=cfg.regularization_context(),
                    solve_label=name,
                    bucketer=self.bucketer or "off",
                    solve_schedule=self.solve_schedule,
                )
        return coords

    # ------------------------------------------------------------------
    def _training_loss_fn(self):
        """The loss part of the training objective over total scores
        (Driver.scala:185-202)."""
        loss = losses_mod.for_task(self.params.task_type)
        put = lambda a: torch.from_numpy(a).to(self.device)
        labels = put(self.train_data.response)
        offsets = put(self.train_data.offset)
        weights = put(self.train_data.weight)

        def fn(total_scores):
            return torch.sum(weights * loss.loss(total_scores + offsets, labels))

        return fn

    def _entity_position_of_vocab(self, name: str) -> np.ndarray:
        """Raw-vocabulary index -> tensor position in coordinate ``name``'s
        stacked coefficients (from the training rows)."""
        cfg = self.params.random_effect_data_configs[name]
        ids = self.train_data.ids[cfg.random_effect_id]
        entity_pos = self.re_datasets[name].entity_pos.cpu().numpy()
        pos = np.full(len(self.train_data.id_vocabs[cfg.random_effect_id]), -1, np.int32)
        # only rows with a tensor position: dropped passive rows have -1
        known = entity_pos >= 0
        pos[ids[known]] = entity_pos[known]
        return pos

    def _validation_scorer(self, coords: Dict[str, object]):
        """coefficients map -> (Nv,) margin scores on the validation data.
        Fixed effects score by matvec; random effects go back to the global
        feature space and gather per validation row (rows of unseen
        entities contribute 0)."""
        p = self.params
        vdata = self.validation_data
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        fe_feats = {}
        re_info = {}
        for name in p.updating_sequence:
            if name in p.fixed_effect_data_configs:
                spec = p.fixed_effect_data_configs[name]
                fe_feats[name] = build_fixed_effect_batch(
                    vdata, spec.feature_shard_id, dense=self._dense(spec.feature_shard_id),
                    device=self.device,
                ).features
            else:
                cfg = p.random_effect_data_configs[name]
                cols, vals = padded_row_coo(vdata.shards[cfg.feature_shard_id], pad_col=0)
                vocab_ids = vdata.ids[cfg.random_effect_id]
                safe_vid = np.maximum(vocab_ids, 0)
                coord = coords.get(name)
                if isinstance(coord, (BucketedRandomEffectCoordinate,
                                      StreamingRandomEffectCoordinate)):
                    # each validation row's position in the concatenated
                    # stacks: the bucket's offset + the position within it
                    bucket_of, pos_in_bucket = coord.vocab_position_maps()
                    starts = np.concatenate([[0], np.cumsum(coord.stack_sizes())[:-1]])
                    b_of, p_in = bucket_of[safe_vid], pos_in_bucket[safe_vid]
                    ent_pos = np.where((vocab_ids >= 0) & (b_of >= 0) & (p_in >= 0),
                                       starts[np.maximum(b_of, 0)] + p_in, -1)
                else:
                    pos_of_vocab = self._entity_position_of_vocab(name)
                    ent_pos = np.where(vocab_ids >= 0, pos_of_vocab[safe_vid], -1)
                re_info[name] = (put(cols), put(vals), put(ent_pos.astype(np.int32)))
        offset = put(vdata.offset)

        def scorer(params_map):
            total = torch.zeros((vdata.num_rows,), dtype=torch.float32, device=self.device)
            for name in p.updating_sequence:
                w = params_map[name]
                if name in fe_feats:
                    total = total + fe_feats[name].matvec(w)
                    continue
                cols, vals, ent_pos = re_info[name]
                if isinstance(w, (tuple, SpilledREState)):
                    # bucketed or streaming: gather from the concatenated stacks
                    wg = torch.cat(coords[name].global_coefficient_stacks(w), dim=0)
                elif isinstance(w, FactoredState):
                    # a factored coordinate's IDENTITY local space is the global one
                    wg = w.v @ w.matrix
                else:
                    wg = global_coefficients(self.re_datasets[name], w)
                total = total + gather_scores(wg, ent_pos, cols, vals)
            return total + offset

        return scorer

    def _validation_evaluators(self) -> Dict[str, Tuple[Evaluator, dict]]:
        p = self.params
        vdata = self.validation_data
        put = lambda a: torch.from_numpy(a).to(self.device)
        out: Dict[str, Tuple[Evaluator, dict]] = {}
        for etype, k, id_name in (p.evaluators or _default_evaluators(p.task_type)):
            kwargs = {"labels": put(vdata.response), "weights": put(vdata.weight)}
            if id_name is not None:
                kwargs["group_ids"] = put(vdata.ids[id_name])
            key = etype.value if k is None else f"{etype.value}@{k}"
            out[key] = (evaluator_for(etype, k or 10), kwargs)
        return out

    # ------------------------------------------------------------------
    def _make_checkpointer(self, combo_index: int, opt_configs, grid: bool = False):
        """The combo's checkpointer (async under --checkpoint-async), with
        the JAX driver's fingerprint parts; None without --checkpoint-dir.
        Grid and per-combo runs fingerprint apart: their steps never
        cross-resume."""
        p = self.params
        if not p.checkpoint_dir:
            return None
        races = self._record_race_decisions()
        return maybe_async(
            CoordinateDescentCheckpointer(
                os.path.join(p.checkpoint_dir, f"combo-{combo_index}"),
                # num_iterations left out: extending a finished run with
                # more iterations is the resume case
                run_fingerprint=fingerprint({
                    "coordinates": p.updating_sequence,
                    "num_rows": self.train_data.num_rows,
                    "combo": combo_index,
                    "configs": {k: str(v) for k, v in opt_configs.items()},
                    **({"grid": True} if grid else {}),
                    # a resume that would take other race winners is refused
                    **({"races": races} if races else {}),
                }),
            ),
            p.checkpoint_async,
        )

    def _races_path(self) -> str:
        return os.path.join(self.params.checkpoint_dir, RACES_FILE)

    def _adopt_recorded_races(self) -> None:
        """Take the race winners an earlier attempt recorded beside its
        checkpoints, so this run's selections match the steps it resumes."""
        path = self._races_path()
        if os.path.exists(path):
            with open(path) as f:
                decisions = json.load(f)
            fused_sparse.adopt_race_decisions(decisions)
            self.logger.info(f"adopted {len(decisions)} race decisions from {path}")

    def _record_race_decisions(self) -> list:
        """This run's race decisions so far, one per (race, key) in first
        order, as JSON lists; written beside the checkpoints for a resume."""
        seen, decisions = set(), []
        for race, key, winner in fused_glm.race_log[self._race_mark:]:
            if (race, key) not in seen:
                seen.add((race, key))
                decisions.append([race, list(key), winner])
        if decisions:
            os.makedirs(self.params.checkpoint_dir, exist_ok=True)
            tmp = self._races_path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump(decisions, f)
            os.replace(tmp, self._races_path())
        return decisions

    @staticmethod
    def _close_checkpointer(checkpointer) -> None:
        """Async fence: every commit durable, and a background failure
        surfaced, before the models are saved."""
        if checkpointer is not None and hasattr(checkpointer, "close"):
            checkpointer.close()

    def _vmapped_grid_blocker(self, combos) -> Optional[str]:
        """Why --vmapped-grid cannot apply, or None when it can: the grid
        must vary only per-coordinate lambda on plain fixed/random
        coordinates."""
        p = self.params
        if len(combos) < 2:
            return "grid has a single combo"
        if p.streaming_random_effects:
            return "--streaming-random-effects (host streaming cannot vmap)"
        if p.bucketed_random_effects:
            return "--bucketed-random-effects (static per-bucket lambdas)"
        if p.factored_configs:
            return "factored coordinates (lambda lives in nested configs)"
        if p.compute_variance:
            return "--compute-variance (save-time Hessians need per-combo statics)"
        if p.divergence_guard != "off":
            return "--divergence-guard (per-update host gate cannot enter the compiled cycle)"
        if self.solve_schedule is not None:
            return "--solve-compaction (chunk pauses re-enter the host per update)"
        for name in p.updating_sequence:
            # every field but lambda must agree across the combos
            non_lambda = {dataclasses.replace(c.get(name, CoordinateOptConfig()), reg_weight=0.0)
                          for c in combos}
            if len(non_lambda) > 1:
                return f"combos vary beyond lambda for coordinate {name!r}"
        return None

    def _evaluation(self, coords):
        """(validation scorer, evaluators, primary evaluator key), all None
        without validation data."""
        if self.validation_data is None:
            return None, None, None
        evaluators = self._validation_evaluators()
        return self._validation_scorer(coords), evaluators, next(iter(evaluators), None)

    def _record(self, i: int, opt_configs, result: CoordinateDescentResult, evaluators,
                primary, tag: str = "") -> None:
        """Keep combo ``i``'s result, log it, and move ``best_index`` when the
        primary evaluator prefers it."""
        metrics = result.validation_history[-1] if result.validation_history else {}
        self.results.append((opt_configs, result, metrics))
        self.logger.info(
            f"combo {i}{tag}: objective={result.objective_history[-1]:.6g} "
            + " ".join(f"{k}={v:.6g}" for k, v in metrics.items())
        )
        if primary is not None and metrics:
            ev = evaluators[primary][0]
            best = self.results[self.best_index][2].get(primary) if i else None
            if best is None or ev.better_than(metrics[primary], best):
                self.best_index = i

    def _train_shared_compile_grid(self, combos, init_params=None) -> None:
        """Every combo through ``CoordinateDescent.run_grid`` on coordinates
        built once; results and ``best_index`` as the per-combo path sets
        them. With --checkpoint-dir each combo checkpoints per cycle and
        resumes from its last complete iteration. ``init_params`` (the delta
        retrain) seeds every combo from the prior run's selected model."""
        p = self.params
        coords = self._build_coordinates(combos[0])
        scorer, evaluators, primary = self._evaluation(coords)
        cd = CoordinateDescent(coords, self._training_loss_fn(), scorer, evaluators)
        lam = {name: [c.get(name, CoordinateOptConfig()).reg_weight for c in combos]
               for name in p.updating_sequence}
        checkpointers = ([self._make_checkpointer(i, combos[i], grid=True)
                          for i in range(len(combos))] if p.checkpoint_dir else None)
        try:
            with self.timer.measure("shared-compile-grid"), maybe_trace("game-grid"):
                grid_results = cd.run_grid(lam, p.num_iterations, self.train_data.num_rows,
                                           init_params=init_params,
                                           checkpointers=checkpointers)
        finally:
            for ck in checkpointers or ():
                self._close_checkpointer(ck)
        for i, (opt_configs, result) in enumerate(zip(combos, grid_results)):
            self.combo_coords.append(coords)
            self._record(i, opt_configs, result, evaluators, primary, " (grid)")

    def train(self) -> None:
        p = self.params
        combos = p.config_grid()
        self._prepare_warm_starts()
        warm_init = self._warm_init()
        frozen = self._frozen_coordinate_names(warm_init)
        if p.vmapped_grid in ("true", "auto"):
            blocker = ("delta-frozen coordinates (the per-coordinate skip lives "
                       "outside the compiled grid cycle)"
                       if frozen else self._vmapped_grid_blocker(combos))
            if blocker is None:
                self.logger.info(
                    "--vmapped-grid: training through the shared-compile grid (the "
                    "batched G-lane variant was removed; sequential won every "
                    "measured race)"
                    + (" — every lane warm-started from the prior model" if warm_init else ""))
                self._train_shared_compile_grid(combos, init_params=warm_init)
                return
            self.logger.warn(f"--vmapped-grid requested but falling back to the per-combo "
                             f"rebuild grid: {blocker}")
        loss_fn = self._training_loss_fn()
        for i, opt_configs in enumerate(combos):
            coords = self._build_coordinates(opt_configs)
            scorer, evaluators, primary = self._evaluation(coords)
            self.combo_coords.append(coords)
            guard = (None if p.divergence_guard == "off"
                     else DivergenceGuard(mode=p.divergence_guard))
            cd = CoordinateDescent(coords, loss_fn, scorer, evaluators, divergence_guard=guard)
            checkpointer = self._make_checkpointer(i, opt_configs)
            try:
                with self.timer.measure(f"combo-{i}"), maybe_trace(f"game-combo-{i}"):
                    # each combo gets its own copy of the warm state
                    result = cd.run(p.num_iterations, self.train_data.num_rows, checkpointer,
                                    initial_params=self._warm_init() if i else warm_init,
                                    frozen=frozen)
            finally:
                self._close_checkpointer(checkpointer)
            self._record(i, opt_configs, result, evaluators, primary)
            for event in result.guard_events:
                self.logger.warn(f"combo {i} divergence guard: {event}")
            for cname, tracker in result.trackers.items():
                summary = _summarize_tracker(tracker)
                if summary:
                    self.logger.info(f"combo {i} [{cname}] {summary}")

    # ------------------------------------------------------------------
    def _rows_by_raw_id(self, name: str, rows: np.ndarray) -> Dict[str, np.ndarray]:
        """(E, D_global) stack -> {raw entity id: row}."""
        cfg = self.params.random_effect_data_configs[name]
        pos_of_vocab = self._entity_position_of_vocab(name)
        vocab = self.train_data.id_vocabs[cfg.random_effect_id]
        return {raw: rows[pos_of_vocab[vi]] for vi, raw in enumerate(vocab)
                if pos_of_vocab[vi] >= 0}

    def save_models(self, output_dir: str, result: CoordinateDescentResult,
                    combo_index: Optional[int] = None) -> None:
        p = self.params

        def variances_for(name, coeffs):
            """1/H_jj at the final state, with --compute-variance; the
            residual is the total minus this coordinate's own score."""
            if (not p.compute_variance or combo_index is None or name in p.factored_configs
                    or isinstance(coeffs, (tuple, SpilledREState))):
                # a bucketed or streaming coordinate exports its own
                return None
            cfg = p.random_effect_data_configs.get(name)
            if cfg is not None and cfg.projector == "RANDOM":
                # a diagonal variance does not survive a dense random
                # back-projection; the reference has the same limitation
                self.logger.warn(f"[{name}] variances skipped: RANDOM-projected space")
                return None
            coord = self.combo_coords[combo_index][name]
            return coord.coefficient_variances(coeffs, result.total_scores - coord.score(coeffs))

        host = lambda t: t.detach().cpu().numpy()
        for name in p.updating_sequence:
            coeffs = result.coefficients[name]
            var = variances_for(name, coeffs)
            if name in p.fixed_effect_data_configs:
                spec = p.fixed_effect_data_configs[name]
                model_io.save_fixed_effect(
                    output_dir, name, p.task_type, host(coeffs),
                    self.shard_index_maps[spec.feature_shard_id],
                    variances=None if var is None else host(var),
                    feature_shard_id=spec.feature_shard_id,
                )
                continue
            cfg = p.random_effect_data_configs[name]
            if isinstance(coeffs, (tuple, SpilledREState)):  # bucketed or streaming
                coord = self.combo_coords[combo_index][name]
                resid = None
                if p.compute_variance and combo_index is not None:
                    if cfg.projector == "RANDOM":
                        self.logger.warn(f"[{name}] variances skipped: RANDOM-projected space")
                    else:
                        resid = result.total_scores - coord.score(coeffs)
                means, entity_variances = coord.entity_export_by_raw_id(coeffs, resid)
                model_io.save_random_effect(
                    output_dir, name, p.task_type, means,
                    self.shard_index_maps[cfg.feature_shard_id],
                    random_effect_id=cfg.random_effect_id,
                    feature_shard_id=cfg.feature_shard_id,
                    num_files=p.num_output_files_re_model,
                    entity_variances=entity_variances,
                )
                continue
            ds = self.re_datasets[name]
            factored = isinstance(coeffs, FactoredState)
            entity_variances = (
                None if var is None
                else self._rows_by_raw_id(name, host(global_coefficients(ds, var)))
            )
            means = coeffs.v @ coeffs.matrix if factored else global_coefficients(ds, coeffs)
            model_io.save_random_effect(
                output_dir, name, p.task_type,
                self._rows_by_raw_id(name, host(means)),
                self.shard_index_maps[cfg.feature_shard_id],
                random_effect_id=cfg.random_effect_id,
                feature_shard_id=cfg.feature_shard_id,
                num_files=p.num_output_files_re_model,
                entity_variances=entity_variances,
            )
            if factored:
                # the latent structure too (LatentFactorAvro, AvroUtils.scala:
                # 244-266): the flattened coefficients above serve scoring, but
                # alone they cannot rebuild the model
                model_io.save_factored_random_effect(
                    output_dir, name, self._rows_by_raw_id(name, host(coeffs.v)),
                    host(coeffs.matrix),
                    random_effect_id=cfg.random_effect_id,
                    feature_shard_id=cfg.feature_shard_id,
                    num_files=p.num_output_files_re_model,
                    index_map=self.shard_index_maps[cfg.feature_shard_id],
                )

    # ------------------------------------------------------------------
    def run(self, restart: bool = False) -> None:
        """The whole run under the flags' ingest resilience settings, so
        every read (feature scan, dataset load, index maps) behaves alike.
        ``restart=True`` (an in-process relaunch after a preemption) keeps
        the output dir the interrupted attempt wrote into."""
        p = self.params
        with resilience.resilience_scope(io_resilience_config(
                p.on_corrupt, p.corrupt_skip_budget, p.io_retries, p.io_retry_base_delay)):
            self._run(restart)

    def _run(self, restart: bool = False) -> None:
        p = self.params
        if restart:
            os.makedirs(p.output_dir, exist_ok=True)
        else:
            prepare_output_dir(p.output_dir, p.delete_output_dir_if_exists)
        self.logger.info(f"device: {self.device}"
                         + (f" ({torch.cuda.get_device_name(self.device)})"
                            if self.device.type == "cuda" else ""))
        self._race_mark = len(fused_glm.race_log)
        self.logger.info(self.plan.describe())
        for line in self.plan.describe_decisions():
            self.logger.info(f"plan decision: {line}")
        if p.checkpoint_dir:
            self._adopt_recorded_races()
        try:
            # stat tokens before ingest: a file overwritten mid-run is
            # recorded with the identity this run read, and tomorrow's delta
            # run classifies it changed, never wrongly frozen
            train_files = _input_files(self._train_dirs())
            self._train_files = train_files
            self._train_file_stats = file_stat_token(train_files)
            self._eval_identity()  # the validation side, before it is read
            self._maybe_plan_delta(train_files)
            if self.delta_plan is not None and self.delta_plan.short_circuit:
                # nothing changed: the prior model is this run's result;
                # re-export it, no ingest and no training
                with self.timer.measure("delta-short-circuit"):
                    self._short_circuit_run()
                self._log_run_summaries()
                return
            with self.timer.measure("prepare-feature-maps"):
                self.prepare_feature_maps()
            with self.timer.measure("prepare-datasets"):
                self.prepare_datasets()
            with self.timer.measure("train"):
                self.train()
            if p.model_output_mode != ModelOutputMode.NONE:
                with self.timer.measure("save"):
                    best_dir = os.path.join(p.output_dir, BEST_MODEL_DIR)
                    self.save_models(best_dir, self.results[self.best_index][1], self.best_index)
                    self.logger.info(
                        f"saved best model (combo {self.best_index}) to {best_dir}"
                    )
                    if p.model_output_mode == ModelOutputMode.ALL:
                        for i, (_, result, _) in enumerate(self.results):
                            self.save_models(os.path.join(p.output_dir, ALL_MODELS_DIR, str(i)),
                                             result, i)
                    self._record_realized_costs()
                    self._write_retrain_manifest(best_dir)
                self._export_store(best_dir)
            elif p.warm_start_from or p.export_serve_store:
                self.logger.warn(
                    "--model-output-mode NONE: no saved model, so no "
                    "retrain manifest / serving store can be written"
                )
            self._log_run_summaries()
        finally:
            if self._own_logger:
                self.logger.close()

    def _export_store(self, best_dir: str) -> None:
        """--export-serve-store: the trained best model as an mmap'd serving
        store (serve/model_store.py), what a live ScoringServer hot-swaps
        in; timed under the JAX driver's span name."""
        p = self.params
        if not p.export_serve_store:
            return
        from photon_ml_tpu_torch.compile import ShapeBucketer
        from photon_ml_tpu_torch.serve.model_store import build_model_store

        with self.timer.measure("export-serve-store"):
            build_model_store(
                best_dir, p.export_serve_store,
                bucketer=self.bucketer or ShapeBucketer(),
                store_dtype=p.store_dtype,
            )
        self.logger.info(
            f"serving store exported: {p.export_serve_store} "
            f"(dtype {p.store_dtype}; swap it into a live server via "
            "serve.swap.ModelSwapper)"
        )

    def _log_run_summaries(self) -> None:
        self.logger.info(self.timer.summary())
        self.logger.info(compile_stats.summary())
        if self.params.tensor_cache_dir:
            from photon_ml_tpu_torch.io.tensor_cache import cache_stats

            self.logger.info(cache_stats.summary())
        if self.solve_schedule is not None or self.plan.adaptive is not None:
            self.logger.info(solve_stats.summary())
        if self.plan.adaptive is not None:
            # every adaptive skip or degrade is a recorded decision
            for combo in self.combo_coords:
                for name, coord in combo.items():
                    for dec in getattr(coord, "skip_decisions", ()) or ():
                        self.logger.info(f"[{name}] {dec.describe()}")

    # --- retrain.json (photon_ml_tpu/retrain) ---------------------------
    def _ingest_inputs(self) -> Dict[str, object]:
        """What determines the decoded columns and feature space given the
        input files, known before the feature maps are built."""
        p = self.params
        return {
            "sections": {k: list(v) for k, v in sorted((p.feature_shard_sections or {}).items())},
            "intercepts": {k: bool(v) for k, v in sorted(
                (p.feature_shard_intercepts or {}).items())},
            "id_types": self._id_types(),
            "ladder": self.bucketer.spec() if self.bucketer is not None else None,
            "offheap_indexmap_dir": p.offheap_indexmap_dir,
            "name_and_term": p.feature_name_and_term_set_path,
        }

    def _ingest_digest(self) -> str:
        """SHA-256 of the whole ingest config, each shard's index map
        included: the feature-space identity."""
        p = self.params
        config = {
            "sections": p.feature_shard_sections,
            "intercepts": p.feature_shard_intercepts,
            "id_types": self._id_types(),
            "ladder": self.bucketer.spec() if self.bucketer is not None else None,
            "index_maps": {shard: index_map_digest(imap)
                           for shard, imap in sorted(self.shard_index_maps.items())},
        }
        return hashlib.sha256(json.dumps(config, sort_keys=True, default=str).encode()).hexdigest()

    def _eval_identity(self) -> Dict[str, object]:
        """Validation file stats and evaluator specs, taken once, before the
        validation files are read."""
        if self._eval_identity_cache is None:
            p = self.params
            val_files = _input_files(self._validate_dirs()) if p.validate_input_dirs else []
            self._eval_identity_cache = {
                "validate_files": file_stat_token(val_files),
                "evaluators": [[etype.value, k, id_name]
                               for etype, k, id_name in (p.evaluators or [])],
            }
        return self._eval_identity_cache

    def _write_retrain_manifest(self, best_dir: str, short_circuit: bool = False) -> None:
        """Leave this run's ``retrain.json`` for the next run's planner. A
        short-circuited run's inputs are the prior run's by construction, so
        it keeps the prior's digests, coordinate records and cache key."""
        p = self.params
        if short_circuit:
            prior = self.retrain_prior
            manifest = RetrainManifest(
                output_dir=os.path.abspath(p.output_dir),
                model_dir=os.path.abspath(best_dir),
                task=p.task_type.value,
                file_stats=self._train_file_stats,
                ingest_inputs=self._ingest_inputs(),
                ingest_digest=prior.ingest_digest,
                updating_sequence=list(p.updating_sequence),
                coordinates=dict(prior.coordinates),
                data_cache_key=prior.data_cache_key,
                eval_identity=self._eval_identity(),
                cost_model=self._plan_cost_model_json(),
            )
            self.logger.info(f"retrain manifest written: {manifest.save(p.output_dir)}")
            return
        selected = self.results[self.best_index][0]

        def kind(name: str) -> str:
            if name in p.fixed_effect_data_configs:
                return "fixed"
            if name in p.factored_configs:
                return "factored"
            if name in self.streaming_manifests:
                return "streaming_random"
            return "bucketed" if p.bucketed_random_effects else "random"

        def ledger(name: str) -> Optional[dict]:
            """The best combo's convergence ledger (None when the coordinate
            keeps none or recorded nothing)."""
            coord = (self.combo_coords[self.best_index].get(name)
                     if 0 <= self.best_index < len(self.combo_coords) else None)
            export = getattr(coord, "ledger_export", None)
            return (export() or None) if callable(export) else None

        coords = {
            name: CoordinateRecord(
                kind=kind(name),
                opt_config=str(selected.get(name, CoordinateOptConfig())),
                cache_key=self._coord_cache_keys.get(name),
                streaming_manifest_dir=(os.path.abspath(self.streaming_manifests[name].dir)
                                        if name in self.streaming_manifests else None),
                convergence_ledger=ledger(name))
            for name in p.updating_sequence
        }
        manifest = RetrainManifest(
            output_dir=os.path.abspath(p.output_dir),
            model_dir=os.path.abspath(best_dir),
            task=p.task_type.value,
            file_stats=self._train_file_stats,
            ingest_inputs=self._ingest_inputs(),
            ingest_digest=self._ingest_digest(),
            updating_sequence=list(p.updating_sequence),
            coordinates=coords,
            data_cache_key=self._data_cache_key,
            eval_identity=self._eval_identity(),
            cost_model=self._plan_cost_model_json(),
        )
        self.logger.info(f"retrain manifest written: {manifest.save(p.output_dir)}")

    # --- the delta retrain (retrain/) ------------------------------------
    def _maybe_plan_delta(self, train_files: List[str]) -> None:
        """Load the prior manifest and resolve the delta plan
        (--warm-start-from). Any failure reading the prior degrades to a
        logged cold run: a broken prior must never give a wrong warm result
        (the ``retrain.delta_plan`` fault site)."""
        p = self.params
        if not p.warm_start_from:
            return
        try:
            self.retrain_prior = retrain.load_prior_manifest(p.warm_start_from)
            combos = p.config_grid()
            combo_configs = None
            if len(combos) == 1:
                combo_configs = {name: str(combos[0].get(name, CoordinateOptConfig()))
                                 for name in p.updating_sequence}
            # classification stays inside the guard: a parseable but
            # malformed manifest surfaces here, not as a crashed run
            self.delta_plan = retrain.plan_delta(
                self.retrain_prior, train_files,
                task=p.task_type.value,
                updating_sequence=p.updating_sequence,
                ingest_inputs=self._ingest_inputs(),
                combo_configs=combo_configs,
                eval_identity=self._eval_identity(),
            )
        except Exception as e:  # noqa: BLE001 — any unreadable, corrupt or malformed prior (bad JSON, vanished model, bad stat tokens, injected fault) degrades to a cold run, never a wrong warm one
            self.retrain_prior = None
            self.delta_plan = None
            self.logger.warn(
                f"--warm-start-from {p.warm_start_from}: prior manifest "
                f"unusable ({type(e).__name__}: {e}) — retraining cold"
            )
            return
        self.logger.info(
            f"delta retrain plan: files {self.delta_plan.files.describe()}; "
            + " ".join(f"{n}={c.status}" for n, c in self.delta_plan.coordinates.items())
        )
        for line in self.delta_plan.describe_decisions():
            self.logger.info(f"delta retrain: {line}")

    def _dirty_entities(self) -> Dict[str, set]:
        """Raw entity ids whose data moved, probed once from the changed and
        new files' id columns (the cost scales with the delta)."""
        if self.delta_plan is None:
            return {}
        if not self.delta_plan.dirty_entities:
            self.delta_plan.dirty_entities = retrain.probe_dirty_entities(
                self.delta_plan.files, self._id_types())
            for t, ids in sorted(self.delta_plan.dirty_entities.items()):
                self.logger.info(f"delta retrain: {len(ids)} dirty {t!r} entities")
        return self.delta_plan.dirty_entities

    def _load_prior_layout(self, name: str, rec):
        """The prior run's streaming block layout, or None with the degrade
        logged: a vanished or corrupt prior layout costs a recorded cold
        block build, never a failed run or stale blocks."""
        try:
            return StreamingREManifest.load(rec.streaming_manifest_dir)
        except Exception as e:  # noqa: BLE001 — a vanished or corrupt prior block layout (a lost cache entry) degrades to a recorded cold build
            self.logger.warn(
                f"delta retrain [{name}]: prior block layout at "
                f"{rec.streaming_manifest_dir} unusable "
                f"({type(e).__name__}: {e}) — cold block build"
            )
            return None

    def _delta_streaming_build(self, name: str, cfg, budget: Optional[int], cache,
                               train_files: List[str]) -> bool:
        """Build ``name``'s entity blocks through the delta builder (prior
        blocking pinned, unchanged payloads reused, each block's status
        recorded) when the plan says the coordinate is dirty and the prior
        blocks are reusable, or take the prior layout as it is when the
        coordinate is unchanged. False: the cold builder runs, with the
        reason logged."""
        p = self.params
        plan, prior = self.delta_plan, self.retrain_prior
        if plan is None or prior is None:
            return False
        cdelta = plan.coordinates.get(name)
        rec = prior.coordinates.get(name)
        if cdelta is None or rec is None:
            return False
        if (cdelta.status == "unchanged" and rec.kind == "streaming_random"
                and rec.streaming_manifest_dir and prior.ingest_digest == self._ingest_digest()):
            # clean files and identical ingest: the prior block layout is this
            # run's, as it is (row space and vocab identical by construction)
            prior_sm = self._load_prior_layout(name, rec)
            if prior_sm is None:
                return False
            self.streaming_manifests[name] = prior_sm
            self._coord_cache_keys[name] = rec.cache_key
            self.logger.info(
                f"delta retrain [{name}]: coordinate unchanged — prior "
                f"block layout reused verbatim ({len(prior_sm.blocks)} "
                "blocks, no rebuild)"
            )
            return True
        if cdelta.status != "dirty":
            return False
        if rec.kind != "streaming_random" or not rec.streaming_manifest_dir:
            self.logger.info(
                f"delta retrain [{name}]: prior coordinate was "
                f"{rec.kind!r}, not streaming — cold block build"
            )
            return False
        if prior.ingest_digest != self._ingest_digest():
            self.logger.info(
                f"delta retrain [{name}]: feature space changed since the "
                "prior run (index-map digests differ) — block reuse off, "
                "cold block build (warm start stays on, by feature name)"
            )
            return False
        prior_sm = self._load_prior_layout(name, rec)
        if prior_sm is None:
            return False
        dirty_raw = self._dirty_entities().get(cfg.random_effect_id, set())
        delta_key = (cache.key_for(train_files, {
            "kind": "streaming_re_blocks_delta", "coord": name,
            "config": dataclasses.asdict(cfg), "budget": budget,
            "prior": prior.model_dir, "dirty": retrain.dirty_set_digest(dirty_raw),
            **self._ingest_cache_config()}) if cache is not None else None)
        manifest, deltas = retrain.build_delta_streaming_manifest(
            self.train_data, cfg, os.path.join(p.output_dir, "streaming-re", name),
            prior_sm, dirty_raw,
            bucketer=self.bucketer or "off",
            block_entities=None if budget is not None else 1024,
            memory_budget_bytes=budget,
            tensor_cache=cache, cache_key=delta_key,
        )
        self.streaming_manifests[name] = manifest
        self.block_deltas[name] = deltas
        if delta_key is not None:
            self._coord_cache_keys[name] = delta_key
        by_status = {"unchanged": 0, "dirty": 0, "new": 0}
        for d in deltas:
            by_status[d.status] = by_status.get(d.status, 0) + 1
        self.logger.info(
            f"delta retrain [{name}]: {len(deltas)} blocks — "
            f"{by_status['unchanged']} unchanged (solve skipped, payload "
            f"reused), {by_status['dirty']} dirty, {by_status['new']} new"
        )
        return True

    def _prior_entity_means(self, name: str):
        """The prior per-entity global rows of coordinate ``name`` (kept;
        None when the prior model lacks it or it is factored)."""
        if name not in self._warm_means_cache:
            cfg = self.params.random_effect_data_configs[name]
            self._warm_means_cache[name] = retrain.random_effect_entity_means(
                self.retrain_prior.model_dir, name,
                self.shard_index_maps[cfg.feature_shard_id])
        return self._warm_means_cache[name]

    def _prepare_warm_starts(self) -> None:
        """Every coordinate's warm-start state from the prior model (once;
        combos share it) and the frozen-block sets. Paths without a warm
        representation (factored latent state) stay cold with a logged
        reason, never a silent wrong warm start."""
        if self.retrain_prior is None or self.delta_plan is None:
            return
        p = self.params
        prior = self.retrain_prior
        combos = p.config_grid()
        single = combos[0] if len(combos) == 1 else None
        for name in p.updating_sequence:
            cdelta = self.delta_plan.coordinates.get(name)
            if cdelta is None or cdelta.status == "new":
                continue
            if name in p.factored_configs:
                self.logger.info(
                    f"delta retrain [{name}]: factored latent state does "
                    "not round-trip through dense rows — cold solve"
                )
                continue
            if name in p.fixed_effect_data_configs:
                spec = p.fixed_effect_data_configs[name]
                w = retrain.fixed_effect_init(prior.model_dir, name,
                                              self.shard_index_maps[spec.feature_shard_id])
                if w is not None:
                    self._warm_fixed[name] = w
                continue
            means = self._prior_entity_means(name)
            if name in self.bucketed_bundles:
                if means is None:
                    self.logger.info(
                        f"delta retrain [{name}]: prior model has no "
                        "reusable coefficients for this bucketed "
                        "coordinate — cold solve"
                    )
                    continue
                self._warm_bucketed[name] = retrain.bucketed_random_effect_init(
                    means, self.bucketed_bundles[name])
                self.logger.info(
                    f"delta retrain [{name}]: warm-starting "
                    f"{len(self._warm_bucketed[name])} bucket stacks from "
                    "the prior model (gathered through the bucket layout)"
                )
                continue
            if means is None:
                self.logger.info(
                    f"delta retrain [{name}]: prior model has no reusable "
                    "coefficients for this coordinate — cold solve"
                )
                continue
            if name in self.streaming_manifests:
                self._warm_spilled[name] = retrain.seed_spilled_state(
                    self.streaming_manifests[name], means,
                    os.path.join(p.output_dir, "retrain-warm", name))
                deltas = self.block_deltas.get(name)
                rec = prior.coordinates.get(name)
                cfg_now = (str(single.get(name, CoordinateOptConfig()))
                           if single is not None else None)
                if deltas and rec is not None and cfg_now == rec.opt_config:
                    self._frozen_blocks[name] = frozenset(
                        d.index for d in deltas if d.status == "unchanged")
                    self.logger.info(
                        f"delta retrain [{name}]: freezing "
                        f"{len(self._frozen_blocks[name])}/{len(deltas)} "
                        "unchanged blocks (solves skipped, coefficients "
                        "bitwise from the prior model)"
                    )
                elif deltas:
                    self.logger.info(
                        f"delta retrain [{name}]: optimization grid "
                        "differs from the prior selected combo — no block "
                        "freezing (warm start only)"
                    )
                continue
            cfg = p.random_effect_data_configs[name]
            self._warm_dense_re[name] = retrain.dense_random_effect_init(
                means, vocab=self.train_data.id_vocabs[cfg.random_effect_id],
                pos_of_vocab=self._entity_position_of_vocab(name),
                local_to_global=self.re_datasets[name].local_to_global.cpu().numpy())

    def _warm_init(self) -> Optional[Dict[str, object]]:
        """The per-coordinate warm-start parameters on the device (fresh
        tensors at each call: a combo never shares another's), or None when
        cold."""
        put = lambda w: torch.from_numpy(np.array(w)).to(self.device)
        out: Dict[str, object] = {}
        for n, w in self._warm_fixed.items():
            out[n] = put(w)
        for n, w in self._warm_dense_re.items():
            out[n] = put(w)
        for n, stacks in self._warm_bucketed.items():
            # per-bucket stacks, as initial_coefficients() gives them
            out[n] = tuple(put(w) for w in stacks)
        out.update(self._warm_spilled)
        return out or None

    def _frozen_coordinate_names(self, warm_init) -> set:
        """Coordinates the plan froze and the warm start could seed:
        freezing without the prior coefficients would freeze zeros."""
        if self.delta_plan is None:
            return set()
        frozen = self.delta_plan.frozen_coordinates()
        out = {n for n in frozen if warm_init is not None and n in warm_init}
        for n in sorted(frozen - out):
            self.logger.warn(
                f"delta retrain [{n}]: classified unchanged but no warm "
                "state could be built — re-solving instead of freezing"
            )
        return out

    def _short_circuit_run(self) -> None:
        """All-unchanged rerun: copy the prior model forward bitwise and
        re-export it: 0 solves, 0 kernel launches, no ingest."""
        p = self.params
        best_dir = os.path.join(p.output_dir, BEST_MODEL_DIR)
        if os.path.abspath(self.retrain_prior.model_dir) != os.path.abspath(best_dir):
            shutil.copytree(self.retrain_prior.model_dir, best_dir, dirs_exist_ok=True)
        self.logger.info(
            "delta retrain: inputs, configuration, and grid identical to "
            f"the prior run — prior model reused wholesale at {best_dir} "
            "(0 solves, 0 new XLA compiles)"
        )
        self._write_retrain_manifest(best_dir, short_circuit=True)
        self._export_store(best_dir)

    def _record_realized_costs(self) -> None:
        """Close the planner loop (--plan auto): attach this run's realized
        costs, from the registries the planner predicts over, to the plan's
        decisions, fold them into the cost model and write
        ``cost-model.json`` beside ``retrain.json``. A trace here is a
        CUDA-graph capture (compile/stats.py). No-op under --plan off."""
        if self.plan.plan_mode != "auto":
            return
        from photon_ml_tpu_torch.compile.cost import TRACE_COST

        sched_cost = solve_stats.realized_plan_cost()
        if sched_cost is not None:
            self.plan.record_realized("schedule", sched_cost)
            # sharding's realized burden: the executed lane-iterations,
            # without the pause tariff
            self.plan.record_realized(
                "sharding", float(solve_stats.totals()["executed_lane_iterations"]))
        traces = compile_stats.total_traces()
        if traces:
            self.plan.record_realized("ladder", TRACE_COST * float(traces))
        # blocking: the best combo's per-block imbalance, from its ledgers
        block_costs = self._ledger_block_costs()
        if block_costs:
            self.plan.record_realized("blocking",
                                      max(block_costs) / max(1e-9, min(block_costs)))
        path = self.plan.save_cost_model(self.params.output_dir)
        if path:
            self.logger.info(f"plan cost model written: {path}")
            for dec in self.plan.decisions:
                if dec.realized_cost is not None:
                    self.logger.info(dec.describe())

    def _plan_cost_model_json(self) -> Optional[dict]:
        """The plan's cost model for retrain.json; None under --plan off
        (the field stays absent)."""
        if self.plan.plan_mode != "auto" or self.plan.cost_model is None:
            return None
        return self.plan.cost_model.to_json()

    def _ledger_block_costs(self) -> list:
        """The best combo's per-block observed costs (empty when no
        coordinate kept a convergence ledger): the blocking-drift signal."""
        costs: list = []
        if not 0 <= self.best_index < len(self.combo_coords):
            return costs
        for coord in self.combo_coords[self.best_index].values():
            ledger = getattr(coord, "_ledger", None)
            if ledger is not None:
                costs.extend(float(c) for c in ledger.observed_costs().values())
        return costs


def main(argv: Optional[List[str]] = None) -> GameTrainingDriver:
    enable_determinism()
    params = parse_training_params(argv)

    def run_once(attempt: int) -> GameTrainingDriver:
        driver = GameTrainingDriver(params)
        driver.run(restart=attempt > 0)
        return driver

    def on_restart(attempt: int, e: preemption.Preempted) -> None:
        logging.getLogger(__name__).warning(
            "preempted (%s); relaunching from the latest checkpoint (restart %d/%d)",
            e, attempt, params.max_restarts)

    # SIGTERM/SIGINT become cooperative preemption requests for the whole
    # run: descent drains to the next update boundary, writes an emergency
    # checkpoint, then relaunches (--max-restarts) or exits with code 75
    with preemption.signal_scope():
        try:
            return preemption.run_with_restarts(run_once, params.max_restarts,
                                                on_restart=on_restart)
        except preemption.Preempted as e:
            print(f"photon-ml-tpu-torch: preempted ({e}); emergency checkpoint "
                  f"{e.checkpoint_path or '(no --checkpoint-dir)'}; exiting "
                  f"{preemption.PREEMPT_EXIT_CODE}", file=sys.stderr)
            raise SystemExit(preemption.PREEMPT_EXIT_CODE) from e


if __name__ == "__main__":
    main()
