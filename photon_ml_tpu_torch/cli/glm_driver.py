"""GLM training driver: preprocess -> train -> validate (port of
photon_ml_tpu/cli/glm_driver.py for LIBSVM input).

Reference spec: Driver.scala:69-598 — stages INIT -> PREPROCESSED -> TRAINED
-> VALIDATED (DriverStage.scala): preprocess loads, validates and summarizes
data, train runs the warm-started lambda grid, validate computes metric maps
and selects the best lambda, and models are written in text form
(``output/`` per lambda, ``best/`` for the selection). Same flag names, log
lines and output layout as the JAX driver; tensors live on ``--device``
(default cuda). Batches up to ``DENSE_DIM_THRESHOLD`` features are dense,
and on the card their value+gradient pass is the fused CUDA kernel; wider
batches are padded-COO ``SparseFeatures``.

    python -m photon_ml_tpu_torch.cli.glm_driver \\
      --training-data-directory data/train --validating-data-directory data/val \\
      --output-directory out --task LOGISTIC_REGRESSION \\
      --input-file-format LIBSVM --regularization-weights 0.1,1,10 \\
      --normalization-type STANDARDIZATION
"""

from __future__ import annotations

import enum
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.cli.glm_params import GLMParams, parse_from_command_line
from photon_ml_tpu_torch.data.validators import sanity_check_data
from photon_ml_tpu_torch.device import enable_determinism, resolve_device
from photon_ml_tpu_torch.evaluation import metrics as metrics_mod
from photon_ml_tpu_torch.io.index_map import IndexMap
from photon_ml_tpu_torch.io.libsvm import HostDataset, read_libsvm, to_batch
from photon_ml_tpu_torch.model_selection import select_best_model, selection_metric_for
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMBatch
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.ops.stats import BasicStatisticalSummary, summarize
from photon_ml_tpu_torch.optim.common import OptimizerConfig, summarize_result
from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.training import TrainedModelList, train_glm_grid
from photon_ml_tpu_torch.types import NormalizationType, RegularizationType
from photon_ml_tpu_torch.utils.io_utils import prepare_output_dir, write_models_in_text
from photon_ml_tpu_torch.utils.logging import PhotonLogger
from photon_ml_tpu_torch.utils.timer import Timer

# above this width batches stay sparse, as in the JAX driver
DENSE_DIM_THRESHOLD = 4096
LEARNED_MODELS_TEXT = "output"  # Driver.LEARNED_MODELS_TEXT parity


class DriverStage(enum.IntEnum):
    INIT = 0
    PREPROCESSED = 1
    TRAINED = 2
    VALIDATED = 3


class Driver:
    """Staged GLM training pipeline. Construct with params, call run()."""

    def __init__(self, params: GLMParams, logger: Optional[PhotonLogger] = None):
        params.validate()
        self.params = params
        self.device = resolve_device(params.device)
        self.stage = DriverStage.INIT
        self.stage_history: List[DriverStage] = []
        self._own_logger = logger is None
        self.logger = logger or PhotonLogger(os.path.join(params.output_dir, "photon-ml-tpu.log"))
        self.timer = Timer(self.logger.info)

        self.index_map: Optional[IndexMap] = None
        self.train_ds: Optional[HostDataset] = None
        self.train_batch: Optional[GLMBatch] = None
        self.validation_batch: Optional[GLMBatch] = None
        self.summary: Optional[BasicStatisticalSummary] = None
        self.norm: NormalizationContext = NormalizationContext.identity()
        self.trained: Optional[TrainedModelList] = None
        # raw-space (back-transformed) models in training order
        self.models: List[Tuple[float, GeneralizedLinearModel]] = []
        self.best_reg_weight: Optional[float] = None
        self.best_model: Optional[GeneralizedLinearModel] = None
        self.validation_metrics: Dict[float, Dict[str, float]] = {}
        self.per_iteration_metrics: Dict[float, List[Dict[str, float]]] = {}
        self.problem: Optional[GLMOptimizationProblem] = None

    def _advance(self, stage: DriverStage) -> None:
        """Stage assertion (Driver.scala:513-527 parity)."""
        if stage <= self.stage:
            raise RuntimeError(f"cannot move back from {self.stage.name} to {stage.name}")
        self.stage_history.append(self.stage)
        self.stage = stage

    def _assert_stage(self, expected: DriverStage) -> None:
        if self.stage != expected:
            raise RuntimeError(f"stage {expected.name} required, currently {self.stage.name}")

    def run(self) -> None:
        p = self.params
        prepare_output_dir(p.output_dir, p.delete_output_dirs_if_exist)
        self.logger.info(f"job {p.job_name}: {p.task_type.value} via "
                         f"{p.optimizer_type.value}, lambdas={p.regularization_weights}")
        self.logger.info(f"device: {self.device}"
                         + (f" ({torch.cuda.get_device_name(self.device)})"
                            if self.device.type == "cuda" else ""))
        try:
            with self.timer.measure("preprocess"):
                self.preprocess()
            with self.timer.measure("train"):
                self.train()
            if p.validating_data_dir:
                with self.timer.measure("validate"):
                    self.validate()
            self.logger.info(self.timer.summary())
        finally:
            if self._own_logger:
                self.logger.close()

    # -- stage: preprocess ---------------------------------------------------
    def _input_paths(self, directory: str) -> List[str]:
        if os.path.isfile(directory):
            return [directory]
        return [
            os.path.join(directory, f)
            for f in sorted(os.listdir(directory))
            if not f.startswith((".", "_"))
        ]

    def preprocess(self) -> None:
        self._assert_stage(DriverStage.INIT)
        p = self.params
        paths = self._input_paths(p.training_data_dir)
        dim = p.feature_dimension if p.feature_dimension > 0 else None
        ds = read_libsvm(paths[0], dim=dim, add_intercept=p.add_intercept)
        for extra in paths[1:]:
            more = read_libsvm(extra, dim=ds.dim - int(p.add_intercept),
                               add_intercept=p.add_intercept)
            ds = _concat_datasets(ds, more)
        self.train_ds = ds
        self.index_map = IndexMap.for_libsvm(ds.dim - int(p.add_intercept), p.add_intercept)
        dense = ds.dim <= DENSE_DIM_THRESHOLD
        self.train_batch = to_batch(ds, dense=dense, device=self.device)
        self.logger.info(
            f"training data: {ds.num_rows} rows x {ds.dim} features "
            f"({'dense' if dense else 'sparse'} layout)"
        )
        sanity_check_data(self.train_batch, p.task_type, p.data_validation_type)

        if p.normalization_type != NormalizationType.NONE:
            self.summary = summarize(self.train_batch)
            intercept = self.index_map.intercept_index
            self.norm = NormalizationContext.build(
                p.normalization_type,
                mean=self.summary.mean,
                std=self.summary.std,
                max_magnitude=self.summary.max_magnitude,
                intercept_id=intercept if intercept >= 0 else None,
            )

        if p.validating_data_dir:
            vds = read_libsvm(
                self._input_paths(p.validating_data_dir)[0],
                dim=ds.dim - int(p.add_intercept),
                add_intercept=p.add_intercept,
            )
            self.validation_batch = to_batch(vds, dense=dense, device=self.device)
            sanity_check_data(self.validation_batch, p.task_type, p.data_validation_type)
        self._advance(DriverStage.PREPROCESSED)

    # -- stage: train --------------------------------------------------------
    def _regularization_context(self) -> RegularizationContext:
        p = self.params
        if p.regularization_type == RegularizationType.NONE:
            return RegularizationContext.none()
        if p.regularization_type == RegularizationType.L1:
            return RegularizationContext.l1(1.0)
        if p.regularization_type == RegularizationType.ELASTIC_NET:
            return RegularizationContext.elastic_net(
                1.0, p.elastic_net_alpha if p.elastic_net_alpha is not None else 0.5
            )
        return RegularizationContext.l2(1.0)

    def _to_raw_space(self, model: GeneralizedLinearModel) -> GeneralizedLinearModel:
        if self.norm.is_identity:
            return model
        w = self.norm.model_to_original_space(model.coefficients.means)
        variances = model.coefficients.variances
        if variances is not None and self.norm.factors is not None:
            variances = variances * torch.square(self.norm.factors)
        return GeneralizedLinearModel(Coefficients(w, variances), model.task)

    def train(self) -> None:
        self._assert_stage(DriverStage.PREPROCESSED)
        p = self.params
        self.problem = GLMOptimizationProblem(
            task=p.task_type,
            optimizer=p.optimizer_type,
            optimizer_config=OptimizerConfig(
                max_iterations=p.max_num_iterations, tolerance=p.tolerance
            ),
            regularization=self._regularization_context(),
            compute_variance=p.compute_variance,
            track_coefficients=p.validate_per_iteration,
        )
        self.trained = train_glm_grid(
            self.problem, self.train_batch, self.norm, p.regularization_weights
        )
        self.models = [
            (lam, self._to_raw_space(m))
            for lam, m in zip(self.trained.weights, self.trained.models)
        ]
        for lam, res in zip(self.trained.weights, self.trained.results):
            self.logger.info(f"lambda={lam:g}: {summarize_result(res)}")
            if p.enable_optimization_state_tracker:
                hist = res.value_history.detach().cpu().numpy()
                hist = hist[~np.isnan(hist)]
                self.logger.debug(
                    f"lambda={lam:g} value history: " + " ".join(f"{v:.6g}" for v in hist)
                )
        write_models_in_text(
            self.models, os.path.join(p.output_dir, LEARNED_MODELS_TEXT), self.index_map
        )
        self._advance(DriverStage.TRAINED)

    # -- stage: validate -----------------------------------------------------
    def validate(self) -> None:
        self._assert_stage(DriverStage.TRAINED)
        best_lam, best_model, all_metrics = select_best_model(self.models, self.validation_batch)
        self.best_reg_weight = best_lam
        self.best_model = best_model
        self.validation_metrics = all_metrics
        for lam in sorted(all_metrics):
            for name, value in sorted(all_metrics[lam].items()):
                self.logger.info(f"lambda={lam:g} {name}: {value:.6g}")
        if self.params.validate_per_iteration:
            self._validate_per_iteration()
        self.logger.info(f"best model: lambda={best_lam:g}")
        write_models_in_text(
            [(best_lam, best_model)], os.path.join(self.params.output_dir, "best"), self.index_map
        )
        self._advance(DriverStage.VALIDATED)

    def _validate_per_iteration(self) -> None:
        """Validation metrics for every iteration's coefficient snapshot
        (Driver.scala:292-361); row 0 of a history is w0, row k the model
        after iteration k."""
        p = self.params
        sel_metric = selection_metric_for(p.task_type)
        self.per_iteration_metrics = {}
        for lam, res in zip(self.trained.weights, self.trained.results):
            hist = res.coefficient_history
            if hist is None:
                continue
            iters = int(res.iterations)
            per_iter = []
            for it in range(1, iters + 1):
                if it == iters and lam in self.validation_metrics:
                    m = self.validation_metrics[lam]
                else:
                    snap = GeneralizedLinearModel(Coefficients(hist[it]), p.task_type)
                    m = metrics_mod.evaluate(self._to_raw_space(snap), self.validation_batch)
                per_iter.append(m)
                self.logger.info(
                    f"lambda={lam:g} iteration {it}/{iters} {sel_metric}: {m[sel_metric]:.6g}"
                )
            self.per_iteration_metrics[lam] = per_iter


def _concat_datasets(a: HostDataset, b: HostDataset) -> HostDataset:
    if a.dim != b.dim:
        raise ValueError(f"feature dims differ: {a.dim} vs {b.dim}")

    def cat(x, y, fill):
        # fill matches to_batch's default for a missing column
        if x is None and y is None:
            return None
        x = x if x is not None else np.full(a.num_rows, fill, np.float32)
        y = y if y is not None else np.full(b.num_rows, fill, np.float32)
        return np.concatenate([x, y])

    return HostDataset(
        labels=np.concatenate([a.labels, b.labels]),
        indptr=np.concatenate([a.indptr, b.indptr[1:] + a.indptr[-1]]),
        indices=np.concatenate([a.indices, b.indices]),
        values=np.concatenate([a.values, b.values]),
        dim=a.dim,
        offsets=cat(a.offsets, b.offsets, 0.0),
        weights=cat(a.weights, b.weights, 1.0),
    )


def main(argv: Optional[List[str]] = None) -> Driver:
    enable_determinism()
    driver = Driver(parse_from_command_line(argv))
    driver.run()
    return driver


if __name__ == "__main__":
    main()
