"""GAME (GLMix) training driver on the card (port of
photon_ml_tpu/cli/game_training_driver.py for fixed-effect and plain
random-effect coordinates).

Reference spec: cli/game/training/Driver.scala:64-537 — prepare feature maps
(a whole-dataset scan of the Avro inputs), load the GAME data, build the
per-coordinate datasets, build the evaluators, run coordinate descent, save
the model in the reference's on-disk layout (``best/fixed-effect/<name>/``,
``best/random-effect/<name>/``; ``all/0/`` too with ``--model-output-mode
ALL``). Same flag names and log lines as the JAX driver; tensors live on
``--device`` (default cuda). With ``PHOTON_SPARSE_KERNEL=pallas`` the random
effects solve over sparse slabs through the CUDA GEVM/HVP kernels.

    python -m photon_ml_tpu_torch.cli.game_training_driver \\
      --train-input-dirs data/train --validate-input-dirs data/val \\
      --output-dir out --task-type LOGISTIC_REGRESSION \\
      --feature-shard-id-to-feature-section-keys-map "global:features|per_user:userFeatures" \\
      --updating-sequence fixed,per-user \\
      --fixed-effect-data-configurations "fixed:global,1" \\
      --random-effect-data-configurations "per-user:userId,per_user,1,-1,-1,-1,INDEX_MAP" \\
      --fixed-effect-optimization-configurations "fixed:50,1e-7,0.01,1,LBFGS,L2" \\
      --random-effect-optimization-configurations "per-user:40,1e-6,0.1,1,LBFGS,L2" \\
      --evaluator-type AUC --num-iterations 2
"""

from __future__ import annotations

import os
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
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.evaluation.evaluators import Evaluator, EvaluatorType, evaluator_for
from photon_ml_tpu_torch.io import avro_data, model_io
from photon_ml_tpu_torch.io.index_map import IndexMap
from photon_ml_tpu_torch.ops import losses as losses_mod
from photon_ml_tpu_torch.optim.common import OptResult, summarize_result, summarize_stacked_results
from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.types import ModelOutputMode, TaskType
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

    # ------------------------------------------------------------------
    def _shard_ids(self) -> List[str]:
        p = self.params
        shards = {spec.feature_shard_id for spec in p.fixed_effect_data_configs.values()}
        shards |= {cfg.feature_shard_id for cfg in p.random_effect_data_configs.values()}
        return sorted(shards)

    def prepare_feature_maps(self) -> None:
        """GAMEDriver.prepareFeatureMaps: one index map per feature shard
        from a whole-dataset scan of the training inputs."""
        p = self.params
        paths = _input_files(p.train_input_dirs)
        for shard in self._shard_ids():
            sections = p.feature_shard_sections.get(shard) or ["features"]
            keys = avro_data.collect_feature_keys(paths, sections)
            self.shard_index_maps[shard] = IndexMap.build(
                keys, p.feature_shard_intercepts.get(shard, True)
            )
            self.logger.info(
                f"feature shard {shard!r}: {len(self.shard_index_maps[shard])} features"
            )

    def _id_types(self) -> List[str]:
        """Random-effect grouping ids and any id column an evaluator needs."""
        ids = {cfg.random_effect_id for cfg in self.params.random_effect_data_configs.values()}
        ids |= {id_name for _, _, id_name in self.params.evaluators if id_name}
        return sorted(ids)

    def prepare_datasets(self) -> None:
        p = self.params
        self.train_data = avro_data.read_game_data(
            _input_files(p.train_input_dirs), self.shard_index_maps,
            p.feature_shard_sections, self._id_types(),
            shard_intercepts=p.feature_shard_intercepts or None,
        )
        self.logger.info(f"training rows: {self.train_data.num_rows}")
        if p.validate_input_dirs:
            self.validation_data = avro_data.read_game_data(
                _input_files(p.validate_input_dirs), self.shard_index_maps,
                p.feature_shard_sections, self._id_types(),
                shard_intercepts=p.feature_shard_intercepts or None,
                id_vocabs=self.train_data.id_vocabs,
            )
            self.logger.info(f"validation rows: {self.validation_data.num_rows}")
        for name, spec in p.fixed_effect_data_configs.items():
            self._check_dense(spec.feature_shard_id)
            self.fe_batches[name] = build_fixed_effect_batch(
                self.train_data, spec.feature_shard_id, device=self.device
            )
        for name, cfg in p.random_effect_data_configs.items():
            self.re_datasets[name] = build_random_effect_dataset(
                self.train_data, cfg, device=self.device
            )

    def _check_dense(self, shard: str) -> None:
        width = len(self.shard_index_maps[shard])
        if width > DENSE_DIM_THRESHOLD:
            raise ValueError(
                f"fixed-effect shard {shard!r} has {width} features: the sparse "
                f"layout (D > {DENSE_DIM_THRESHOLD}) is not yet ported to photon_ml_tpu_torch"
            )

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
                    vdata, spec.feature_shard_id, device=self.device
                ).features
            else:
                cfg = p.random_effect_data_configs[name]
                cols, vals = padded_row_coo(vdata.shards[cfg.feature_shard_id])
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
                wg = global_coefficients(self.re_datasets[name], w)
                gathered = wg[torch.clamp_min(ent_pos, 0).long()[:, None],
                              torch.clamp_min(cols, 0).long()]
                valid = (ent_pos[:, None] >= 0) & (cols >= 0)
                total = total + torch.sum(
                    torch.where(valid, gathered * vals, torch.zeros_like(gathered)), dim=-1)
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
    def train(self) -> None:
        p = self.params
        opt_configs = p.opt_configs()
        coords = self._build_coordinates(opt_configs)
        scorer = evaluators = None
        if self.validation_data is not None:
            scorer = self._validation_scorer(coords)
            evaluators = self._validation_evaluators()
        self.combo_coords.append(coords)
        cd = CoordinateDescent(coords, self._training_loss_fn(), scorer, evaluators)
        with self.timer.measure("combo-0"):
            result = cd.run(p.num_iterations, self.train_data.num_rows)
        metrics = result.validation_history[-1] if result.validation_history else {}
        self.results.append((opt_configs, result, metrics))
        self.logger.info(
            f"combo 0: objective={result.objective_history[-1]:.6g} "
            + " ".join(f"{k}={v:.6g}" for k, v in metrics.items())
        )
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
    def run(self) -> None:
        p = self.params
        prepare_output_dir(p.output_dir, p.delete_output_dir_if_exists)
        self.logger.info(f"device: {self.device}"
                         + (f" ({torch.cuda.get_device_name(self.device)})"
                            if self.device.type == "cuda" else ""))
        try:
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
            self.logger.info(self.timer.summary())
        finally:
            if self._own_logger:
                self.logger.close()


def main(argv: Optional[List[str]] = None) -> GameTrainingDriver:
    driver = GameTrainingDriver(parse_training_params(argv))
    driver.run()
    return driver


if __name__ == "__main__":
    main()
