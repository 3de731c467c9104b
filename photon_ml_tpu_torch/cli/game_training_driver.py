"""GAME (GLMix) training driver on the card (port of
photon_ml_tpu/cli/game_training_driver.py for fixed-effect and plain
random-effect coordinates).

Reference spec: cli/game/training/Driver.scala:64-537 — prepare feature maps
(``--offheap-indexmap-dir`` maps from feature_indexing, a NameAndTerm
vocabulary, or a whole-dataset scan of the Avro inputs), resolve dated
input dirs, load the GAME data (native Avro decoder), build the
per-coordinate datasets, build the evaluators, run coordinate descent, save
the model in the reference's on-disk layout (``best/fixed-effect/<name>/``,
``best/random-effect/<name>/``; ``all/0/`` too with ``--model-output-mode
ALL``). Same flag names and log lines as the JAX driver; tensors live on
``--device`` (default cuda). A fixed-effect shard wider than
``DENSE_DIM_THRESHOLD`` features trains on padded-COO ``SparseFeatures``.
With ``PHOTON_SPARSE_KERNEL=pallas`` the random effects solve over sparse
slabs through the CUDA GEVM/HVP kernels. ``--checkpoint-dir`` saves the
descent after every coordinate update and resumes from it; a preemption
(SIGTERM/SIGINT, ``PHOTON_PREEMPT_AT``) drains to the next update boundary,
then relaunches in-process (``--max-restarts``) or exits with code 75. The
run leaves ``retrain.json`` at the output root, as the JAX driver does.

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
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.algorithm.coordinate_descent import (
    CoordinateDescent,
    CoordinateDescentResult,
)
from photon_ml_tpu_torch.algorithm.fixed_effect import FixedEffectCoordinate
from photon_ml_tpu_torch.algorithm.random_effect import (
    RandomEffectCoordinate,
    global_coefficients,
)
from photon_ml_tpu_torch.checkpoint import CoordinateDescentCheckpointer, fingerprint
from photon_ml_tpu_torch.checkpoint_async import maybe_async
from photon_ml_tpu_torch.cli.game_params import (
    CoordinateOptConfig,
    GameTrainingParams,
    parse_training_params,
)
from photon_ml_tpu_torch.data.game import (
    GameData,
    build_fixed_effect_batch,
    build_random_effect_dataset,
    padded_row_coo,
)
from photon_ml_tpu_torch.device import enable_determinism, resolve_device
from photon_ml_tpu_torch import resilience
from photon_ml_tpu_torch.resilience import preemption
from photon_ml_tpu_torch.resilience.guards import DivergenceGuard
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
from photon_ml_tpu_torch.optim.common import OptResult, summarize_result, summarize_stacked_results
from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.types import ModelOutputMode, TaskType
from photon_ml_tpu_torch.utils.date_range import DateRange, expand_date_range_paths
from photon_ml_tpu_torch.utils.io_utils import prepare_output_dir
from photon_ml_tpu_torch.utils.logging import PhotonLogger
from photon_ml_tpu_torch.utils.timer import Timer

DENSE_DIM_THRESHOLD = 4096
BEST_MODEL_DIR = "best"
ALL_MODELS_DIR = "all"


def _summarize_tracker(tracker) -> str:
    """Per-coordinate convergence summary of the last update's OptResult
    (RandomEffectOptimizationTracker.scala:62-95 for lane-batched solves)."""
    if not isinstance(tracker, OptResult):
        return ""
    if tracker.reason.dim() >= 1:
        return summarize_stacked_results(tracker)
    return summarize_result(tracker)


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
        self._own_logger = logger is None
        self.logger = logger or PhotonLogger(
            os.path.join(params.output_dir, "photon-ml-tpu-game.log")
        )
        self.timer = Timer(self.logger.info)
        self.shard_index_maps: Dict[str, IndexMap] = {}
        self.train_data: Optional[GameData] = None
        self.validation_data: Optional[GameData] = None
        self.re_datasets: Dict[str, object] = {}
        self.fe_batches: Dict[str, object] = {}
        # (config map, CoordinateDescentResult, final validation metrics)
        self.results: List[Tuple[Dict[str, CoordinateOptConfig], CoordinateDescentResult,
                                 Dict[str, float]]] = []
        self.combo_coords: List[Dict[str, object]] = []
        self.best_index: int = 0
        # identity of the inputs for retrain.json, taken before ingest
        self._train_file_stats: Optional[list] = None
        self._eval_identity_cache: Optional[Dict[str, object]] = None

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

    def prepare_datasets(self) -> None:
        """Read the training (and validation) rows, then build each
        coordinate's tensors on the device; each step is a timer span."""
        p = self.params
        with self.timer.measure("read-train-data"):
            self.train_data = avro_data.read_game_data(
                _input_files(self._train_dirs()), self.shard_index_maps,
                p.feature_shard_sections, self._id_types(),
                shard_intercepts=p.feature_shard_intercepts or None,
            )
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
                self.re_datasets[name] = build_random_effect_dataset(
                    self.train_data, cfg, device=self.device
                )

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
                coords[name] = FixedEffectCoordinate(
                    self.fe_batches[name],
                    GLMOptimizationProblem(
                        task=p.task_type,
                        optimizer=cfg.optimizer,
                        optimizer_config=cfg.optimizer_config(),
                        regularization=cfg.regularization_context(),
                    ),
                )
            else:
                coords[name] = RandomEffectCoordinate(
                    self.re_datasets[name],
                    p.task_type,
                    optimizer=cfg.optimizer,
                    optimizer_config=cfg.optimizer_config(),
                    regularization=cfg.regularization_context(),
                    solve_label=name,
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
                pos_of_vocab = self._entity_position_of_vocab(name)
                ent_pos = np.where(vocab_ids >= 0, pos_of_vocab[np.maximum(vocab_ids, 0)], -1)
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
                total = total + gather_scores(global_coefficients(self.re_datasets[name], w),
                                              ent_pos, cols, vals)
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
    def _make_checkpointer(self, combo_index: int, opt_configs):
        """The combo's checkpointer (async under --checkpoint-async), with
        the JAX driver's fingerprint parts; None without --checkpoint-dir."""
        p = self.params
        if not p.checkpoint_dir:
            return None
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
                }),
            ),
            p.checkpoint_async,
        )

    def train(self) -> None:
        p = self.params
        opt_configs = p.opt_configs()
        coords = self._build_coordinates(opt_configs)
        scorer = evaluators = None
        if self.validation_data is not None:
            scorer = self._validation_scorer(coords)
            evaluators = self._validation_evaluators()
        self.combo_coords.append(coords)
        guard = None if p.divergence_guard == "off" else DivergenceGuard(mode=p.divergence_guard)
        cd = CoordinateDescent(coords, self._training_loss_fn(), scorer, evaluators,
                               divergence_guard=guard)
        checkpointer = self._make_checkpointer(0, opt_configs)
        try:
            with self.timer.measure("combo-0"):
                result = cd.run(p.num_iterations, self.train_data.num_rows, checkpointer)
        finally:
            # async fence: every commit durable, and a background failure
            # surfaced, before the models are saved
            if checkpointer is not None and hasattr(checkpointer, "close"):
                checkpointer.close()
        metrics = result.validation_history[-1] if result.validation_history else {}
        self.results.append((opt_configs, result, metrics))
        self.logger.info(
            f"combo 0: objective={result.objective_history[-1]:.6g} "
            + " ".join(f"{k}={v:.6g}" for k, v in metrics.items())
        )
        for event in result.guard_events:
            self.logger.warn(f"combo 0 divergence guard: {event}")
        for cname, tracker in result.trackers.items():
            summary = _summarize_tracker(tracker)
            if summary:
                self.logger.info(f"combo 0 [{cname}] {summary}")

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
            if not p.compute_variance or combo_index is None:
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
            ds = self.re_datasets[name]
            entity_variances = (
                None if var is None
                else self._rows_by_raw_id(name, host(global_coefficients(ds, var)))
            )
            model_io.save_random_effect(
                output_dir, name, p.task_type,
                self._rows_by_raw_id(name, host(global_coefficients(ds, coeffs))),
                self.shard_index_maps[cfg.feature_shard_id],
                random_effect_id=cfg.random_effect_id,
                feature_shard_id=cfg.feature_shard_id,
                num_files=p.num_output_files_re_model,
                entity_variances=entity_variances,
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
        try:
            # stat tokens before ingest: a file overwritten mid-run is
            # recorded with the identity this run read
            self._train_file_stats = file_stat_token(_input_files(self._train_dirs()))
            self._eval_identity()
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
                    self._write_retrain_manifest(best_dir)
            self.logger.info(self.timer.summary())
        finally:
            if self._own_logger:
                self.logger.close()

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
            "ladder": None,  # the shape ladder is not yet ported
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
            "ladder": None,
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

    def _write_retrain_manifest(self, best_dir: str) -> None:
        """Leave this run's ``retrain.json`` for the next run's planner."""
        p = self.params
        selected = self.results[self.best_index][0]
        coords = {
            name: CoordinateRecord(
                kind="fixed" if name in p.fixed_effect_data_configs else "random",
                opt_config=str(selected.get(name, CoordinateOptConfig())),
            )
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
            eval_identity=self._eval_identity(),
        )
        self.logger.info(f"retrain manifest written: {manifest.save(p.output_dir)}")


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
