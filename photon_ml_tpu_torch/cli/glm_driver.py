"""GLM training driver: preprocess -> train -> validate -> diagnose (port of
photon_ml_tpu/cli/glm_driver.py).

Reference spec: Driver.scala:69-598 — stages INIT -> PREPROCESSED -> TRAINED
-> VALIDATED -> DIAGNOSED (DriverStage.scala): preprocess loads, validates
and summarizes data (Avro through the native decoder, or LIBSVM; selected
features, off-heap index maps, ``--summarization-output-dir``), train runs
the warm-started lambda grid (box constraints from
``--coefficient-box-constraints``), validate computes metric maps and
selects the best lambda, diagnose (``--diagnostic-mode``) writes
``model-diagnostic.html`` and the ``diagnostics/`` Avro records. Models are
written in text form (``output/`` per lambda, ``best/`` for the selection).
With ``--streaming-chunk-rows`` preprocess spills dense row chunks to disk
(``stream-chunks/``, or a ``--tensor-cache`` entry a warm run reuses
without decoding) and train streams them through the optimizer
(``training.train_glm_grid_streaming``); ``--shape-canonicalization`` pads
every chunk's rows up the ladder. Same flag names, log lines and output
layout as the JAX driver; tensors live on ``--device`` (default cuda). Batches up to ``DENSE_DIM_THRESHOLD``
features are dense, and on the card their value+gradient pass is the fused
CUDA kernel; wider batches are padded-COO ``SparseFeatures``.

    python -m photon_ml_tpu_torch.cli.glm_driver \\
      --training-data-directory data/train --validating-data-directory data/val \\
      --output-directory out --task LOGISTIC_REGRESSION \\
      --regularization-weights 0.1,1,10 --normalization-type STANDARDIZATION \\
      --diagnostic-mode VALIDATE
"""

from __future__ import annotations

import dataclasses
import enum
import os
import shutil
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.cli.glm_params import (
    FieldNamesType,
    GLMParams,
    InputFormatType,
    parse_from_command_line,
)
from photon_ml_tpu_torch.compile.canonical import resolve_bucketer
from photon_ml_tpu_torch.data.validators import sanity_check_data
from photon_ml_tpu_torch.device import enable_determinism, resolve_device
from photon_ml_tpu_torch.diagnostics import (
    avro_reports,
    bootstrap_diagnostic,
    feature_importance,
    fitting,
    hosmer_lemeshow,
    independence,
    render_html,
)
from photon_ml_tpu_torch.diagnostics.reports import (
    ModelDiagnosticReport,
    SystemReport,
    assemble_document,
)
from photon_ml_tpu_torch.evaluation import metrics as metrics_mod
from photon_ml_tpu_torch.io import avro as avro_io
from photon_ml_tpu_torch.io import avro_data
from photon_ml_tpu_torch.io.index_map import DELIMITER, IndexMap
from photon_ml_tpu_torch.io.libsvm import HostDataset, read_libsvm, to_batch
from photon_ml_tpu_torch.io.offheap import load_index_map
from photon_ml_tpu_torch.model_selection import select_best_model, selection_metric_for
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMBatch
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.ops.stats import BasicStatisticalSummary, summarize
from photon_ml_tpu_torch.optim.common import OptimizerConfig, summarize_result
from photon_ml_tpu_torch.optim.constraints import BoxConstraints, parse_constraint_string
from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.training import (
    TrainedModelList,
    train_glm_grid,
    train_glm_grid_streaming,
)
from photon_ml_tpu_torch.types import (
    ConvergenceReason,
    NormalizationType,
    RegularizationType,
    TaskType,
)
from photon_ml_tpu_torch.utils.io_utils import (
    prepare_output_dir,
    write_basic_statistics,
    write_models_in_text,
)
from photon_ml_tpu_torch.utils.logging import PhotonLogger
from photon_ml_tpu_torch.utils.profiling import maybe_trace
from photon_ml_tpu_torch.utils.timer import Timer

# above this width batches stay sparse, as in the JAX driver
DENSE_DIM_THRESHOLD = 4096
LEARNED_MODELS_TEXT = "output"  # Driver.LEARNED_MODELS_TEXT parity
REPORT_FILE = "model-diagnostic.html"
#: input files decoded and chunks written by streaming preprocesses in this
#: process (a warm --tensor-cache run adds nothing)
spill_counts = {"files": 0, "chunks": 0}


class DriverStage(enum.IntEnum):
    INIT = 0
    PREPROCESSED = 1
    TRAINED = 2
    VALIDATED = 3
    DIAGNOSED = 4


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
        # out-of-core mode: the chunk source replaces train_batch
        self.streaming_source = None

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
            if p.diagnostic_mode.runs_train or p.diagnostic_mode.runs_validate:
                with self.timer.measure("diagnose"):
                    self.diagnose()
            self.logger.info(self.timer.summary())
            if p.tensor_cache_dir:
                from photon_ml_tpu_torch.io.tensor_cache import cache_stats

                self.logger.info(cache_stats.summary())
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

    def _selected_features(self) -> Optional[set]:
        """Whitelist of feature keys (GLMSuite.scala:141-180 parity: a file
        of name/term entries; text lines 'name<TAB>term' or 'name', or Avro
        records with ``name`` and ``term``)."""
        path = self.params.selected_features_file
        if not path:
            return None
        keys = set()
        if path.endswith(".avro"):
            for rec in avro_io.read_container(path):
                keys.add(f"{rec['name']}{DELIMITER}{rec.get('term') or ''}")
        else:
            with open(path) as f:
                for line in f:
                    line = line.rstrip("\n")
                    if not line:
                        continue
                    if DELIMITER in line:
                        keys.add(line)
                    elif "\t" in line:
                        name, term = line.split("\t", 1)
                        keys.add(f"{name}{DELIMITER}{term}")
                    else:
                        keys.add(f"{line}{DELIMITER}")
        return keys

    def _read_avro(self, directory: str) -> HostDataset:
        label_field = (
            "response"
            if self.params.field_names_type == FieldNamesType.RESPONSE_PREDICTION
            else "label"
        )
        return avro_data.read_training_examples(
            self._input_paths(directory),
            self.index_map,
            add_intercept=self.params.add_intercept,
            label_field=label_field,
        )

    def _build_index_map(self):
        p = self.params
        if p.offheap_indexmap_dir:
            return load_index_map(p.offheap_indexmap_dir)
        keys = avro_data.collect_feature_keys(self._input_paths(p.training_data_dir))
        selected = self._selected_features()
        if selected is not None:
            keys = [k for k in keys if k in selected]
        return IndexMap.build(
            keys,
            add_intercept=p.add_intercept,
            num_partitions=max(p.offheap_indexmap_num_partitions, 1),
        )

    def _preprocess_streaming(self) -> None:
        """Out-of-core preprocess: decode the input file by file and spill
        dense row chunks of ``--streaming-chunk-rows`` rows, never building
        the whole batch (StorageLevel.scala:22-24's DISK_ONLY). Rows are
        re-chunked across file boundaries, so every chunk but the tail has
        one shape. With ``--tensor-cache`` the chunks are a cache entry a
        warm run memory-maps, skipping decode, sanity checks and spill;
        otherwise they go to ``<output>/stream-chunks/``, purged first. The
        summary accumulates over the chunks."""
        import shutil

        from photon_ml_tpu_torch.optim.streaming import (
            ChunkedGLMSource,
            streaming_summarize,
            write_chunk,
        )

        p = self.params
        paths = self._input_paths(p.training_data_dir)
        file_ds = {}
        if p.input_file_format == InputFormatType.LIBSVM:
            if p.feature_dimension > 0:
                # the width is given: no file is read before the cache lookup
                n_feat = p.feature_dimension
            else:
                first = read_libsvm(paths[0], dim=None, add_intercept=p.add_intercept)
                n_feat = first.dim - int(p.add_intercept)
                file_ds[paths[0]] = first
            self.index_map = IndexMap.for_libsvm(n_feat, p.add_intercept)
            read_file = lambda path: read_libsvm(path, dim=n_feat, add_intercept=p.add_intercept)
        else:
            self.index_map = self._build_index_map()
            read_file = lambda path: self._read_avro(path)

        dim = len(self.index_map)
        if dim > DENSE_DIM_THRESHOLD:
            raise ValueError(
                f"--streaming-chunk-rows spills DENSE chunks; {dim} features "
                f"exceeds the dense threshold ({DENSE_DIM_THRESHOLD}). The "
                "wide-sparse regime streams through the in-memory sparse "
                "layout instead (sparse chunk spilling is not implemented)."
            )

        def spill_chunks(chunk_dir: str) -> None:
            """Decode file by file into ``chunk_dir``; rows carried across
            file boundaries so every chunk but the tail has one shape."""
            chunk_i, total_rows, buf, buf_rows = 0, 0, [], 0

            def flush(final=False):
                nonlocal chunk_i, buf, buf_rows
                while buf_rows >= p.streaming_chunk_rows or (final and buf_rows > 0):
                    take = min(buf_rows, p.streaming_chunk_rows)
                    parts, got = [], 0
                    while got < take:
                        head = buf[0]
                        n_h = len(head["y"])
                        if got + n_h <= take:
                            parts.append(buf.pop(0))
                            got += n_h
                        else:
                            split = take - got
                            parts.append({k: v[:split] for k, v in head.items()})
                            buf[0] = {k: v[split:] for k, v in head.items()}
                            got = take
                    write_chunk(chunk_dir, chunk_i,
                                {k: np.concatenate([q[k] for q in parts]) for k in parts[0]})
                    chunk_i += 1
                    buf_rows -= take

            for path in paths:
                ds = file_ds.pop(path, None) or read_file(path)
                batch = to_batch(ds, dense=True, device="cpu")
                sanity_check_data(batch, p.task_type, p.data_validation_type)
                buf.append({
                    "x": batch.features.matrix.numpy()[: ds.num_rows],
                    "y": np.asarray(ds.labels),
                    "offsets": (np.asarray(ds.offsets) if ds.offsets is not None
                                else np.zeros(ds.num_rows, np.float32)),
                    "weights": (np.asarray(ds.weights) if ds.weights is not None
                                else np.ones(ds.num_rows, np.float32)),
                })
                buf_rows += ds.num_rows
                total_rows += ds.num_rows
                flush()
            flush(final=True)
            spill_counts["files"] += len(paths)
            spill_counts["chunks"] += chunk_i
            self.logger.info(
                f"streaming mode: {total_rows} rows x {dim} features spilled "
                f"to {chunk_i} chunks of {p.streaming_chunk_rows} rows (+ tail)"
            )

        source_dir = None
        if p.tensor_cache_dir:
            from photon_ml_tpu_torch.io.tensor_cache import TensorCache, index_map_digest
            from photon_ml_tpu_torch.resilience import RetryError

            cache = TensorCache(p.tensor_cache_dir)
            cache_key = cache.key_for(paths, {
                "kind": "glm_stream_chunks",
                "chunk_rows": p.streaming_chunk_rows,
                "format": p.input_file_format,
                "fields": p.field_names_type,
                "intercept": p.add_intercept,
                "index_map": index_map_digest(self.index_map),
            })
            source_dir = cache.get_dir(cache_key)
            if source_dir is not None:
                self.logger.info(f"tensor cache HIT {cache_key[:12]}: decode + spill skipped")
            else:
                try:
                    source_dir = cache.build_dir(cache_key, spill_chunks)
                    self.logger.info(f"tensor cache stored {cache_key[:12]}")
                except RetryError as e:
                    self.logger.info(f"tensor cache unusable (uncached): {e}")
                    source_dir = None
        if source_dir is None:
            source_dir = os.path.join(p.output_dir, "stream-chunks")
            # stale chunks of an aborted run must never be trained on, and a
            # failed purge raises
            if os.path.exists(source_dir):
                shutil.rmtree(source_dir)
            os.makedirs(source_dir)
            spill_chunks(source_dir)
        self.streaming_source = ChunkedGLMSource.from_chunk_dir(source_dir)

        if p.normalization_type != NormalizationType.NONE or p.summarization_output_dir:
            self.summary = streaming_summarize(self.streaming_source, device=self.device)
            if p.summarization_output_dir:
                write_basic_statistics(self.summary, p.summarization_output_dir, self.index_map)
        if p.normalization_type != NormalizationType.NONE:
            intercept = self.index_map.intercept_index
            self.norm = NormalizationContext.build(
                p.normalization_type,
                mean=self.summary.mean,
                std=self.summary.std,
                max_magnitude=self.summary.max_magnitude,
                intercept_id=intercept if intercept >= 0 else None,
            )

        if p.validating_data_dir:
            if p.input_file_format == InputFormatType.LIBSVM:
                vds = read_libsvm(self._input_paths(p.validating_data_dir)[0],
                                  dim=dim - int(p.add_intercept), add_intercept=p.add_intercept)
            else:
                vds = self._read_avro(p.validating_data_dir)
            self.validation_batch = to_batch(vds, dense=True, device=self.device)
            sanity_check_data(self.validation_batch, p.task_type, p.data_validation_type)
        self._advance(DriverStage.PREPROCESSED)

    def preprocess(self) -> None:
        self._assert_stage(DriverStage.INIT)
        p = self.params
        if p.streaming_chunk_rows > 0:
            self._preprocess_streaming()
            return
        if p.input_file_format == InputFormatType.LIBSVM:
            paths = self._input_paths(p.training_data_dir)
            dim = p.feature_dimension if p.feature_dimension > 0 else None
            ds = read_libsvm(paths[0], dim=dim, add_intercept=p.add_intercept)
            for extra in paths[1:]:
                more = read_libsvm(extra, dim=ds.dim - int(p.add_intercept),
                                   add_intercept=p.add_intercept)
                ds = _concat_datasets(ds, more)
            self.index_map = IndexMap.for_libsvm(ds.dim - int(p.add_intercept), p.add_intercept)
        else:
            self.index_map = self._build_index_map()
            ds = self._read_avro(p.training_data_dir)
        self.train_ds = ds
        dense = ds.dim <= DENSE_DIM_THRESHOLD
        self.train_batch = to_batch(ds, dense=dense, device=self.device)
        self.logger.info(
            f"training data: {ds.num_rows} rows x {ds.dim} features "
            f"({'dense' if dense else 'sparse'} layout)"
        )
        sanity_check_data(self.train_batch, p.task_type, p.data_validation_type)

        needs_summary = (
            p.normalization_type != NormalizationType.NONE
            or p.summarization_output_dir is not None
            or p.diagnostic_mode.runs_train
            or p.diagnostic_mode.runs_validate
        )
        if needs_summary:
            self.summary = summarize(self.train_batch)
            if p.summarization_output_dir:
                write_basic_statistics(self.summary, p.summarization_output_dir, self.index_map)

        if p.normalization_type != NormalizationType.NONE:
            intercept = self.index_map.intercept_index
            self.norm = NormalizationContext.build(
                p.normalization_type,
                mean=self.summary.mean,
                std=self.summary.std,
                max_magnitude=self.summary.max_magnitude,
                intercept_id=intercept if intercept >= 0 else None,
            )

        if p.validating_data_dir:
            if p.input_file_format == InputFormatType.LIBSVM:
                vds = read_libsvm(
                    self._input_paths(p.validating_data_dir)[0],
                    dim=ds.dim - int(p.add_intercept),
                    add_intercept=p.add_intercept,
                )
            else:
                vds = self._read_avro(p.validating_data_dir)
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

    def _constraints(self) -> Optional[BoxConstraints]:
        p = self.params
        if not p.coefficient_box_constraints:
            return None
        cmap = parse_constraint_string(
            p.coefficient_box_constraints, self.index_map.name_to_index
        )
        if not cmap:
            return None
        return BoxConstraints.from_map(len(self.index_map), cmap, device=self.device)

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
            constraints=self._constraints(),
            track_coefficients=p.validate_per_iteration,
        )
        with maybe_trace("glm-train"):
            if self.streaming_source is not None:
                self.trained = train_glm_grid_streaming(
                    self.problem, self.streaming_source, self.norm, p.regularization_weights,
                    bucketer=resolve_bucketer(p.shape_canonicalization), device=self.device,
                )
                # the spilled chunks are dead weight once training is done
                shutil.rmtree(os.path.join(p.output_dir, "stream-chunks"), ignore_errors=True)
            else:
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

    # -- stage: diagnose -----------------------------------------------------
    def diagnose(self) -> None:
        """The diagnostic report (Driver.scala:484-511, writer :577-597):
        fitting curves (TRAIN), feature importance, prediction/error
        independence and Hosmer-Lemeshow per model (VALIDATE), the bootstrap
        at the best lambda (TRAIN, with validation data), one
        EvaluationResultAvro per model and the feature summaries. Each
        diagnostic is a timer span ``diagnose/<name>``."""
        p = self.params
        span = lambda name: self.timer.measure(f"diagnose/{name}")
        feature_names = [
            (self.index_map.get_feature_name(j) or str(j)).replace(DELIMITER, ":")
            for j in range(len(self.index_map))
        ]
        model_reports: List[ModelDiagnosticReport] = []
        # diagnostics never read coefficient histories: no per-iteration
        # snapshots through the prefix and bootstrap solves
        diag_problem = dataclasses.replace(self.problem, track_coefficients=False)

        fitting_reports = {}
        if p.diagnostic_mode.runs_train:
            with span("fitting"):
                fitting_reports = fitting.diagnose(
                    diag_problem, self.train_batch, self.norm, p.regularization_weights
                )

        results_by_lam = dict(zip(self.trained.weights, self.trained.results))
        host = lambda t: t.detach().cpu().numpy()
        eval_records = []
        on_validation = p.diagnostic_mode.runs_validate and self.validation_batch is not None
        for lam, model in self.models:
            sections = []
            if on_validation:
                metrics = self.validation_metrics.get(lam)
                if metrics is None:
                    metrics = metrics_mod.evaluate(model, self.validation_batch)
                with span("feature importance"):
                    sections.append(feature_importance.to_section(
                        feature_importance.diagnose(model, self.summary,
                                                    feature_names=feature_names)))
                with span("independence"):
                    sections.append(independence.to_section(
                        independence.diagnose(model, self.validation_batch)))
                if p.task_type == TaskType.LOGISTIC_REGRESSION:
                    with span("hosmer-lemeshow"):
                        sections.append(hosmer_lemeshow.to_section(
                            hosmer_lemeshow.diagnose(model, self.validation_batch)))
            else:
                metrics = metrics_mod.evaluate(model, self.train_batch)
            if p.diagnostic_mode.runs_train and lam in fitting_reports:
                sections.append(fitting.to_section({lam: fitting_reports[lam]}))
            model_reports.append(ModelDiagnosticReport(model, lam, metrics, sections))

            # one EvaluationResultAvro per model, on the batch `metrics` came from
            with span("evaluation records"):
                res = results_by_lam.get(lam)
                reg = self._regularization_context().with_weight(lam)
                eval_batch = self.validation_batch if on_validation else self.train_batch
                with_curves = p.task_type in (
                    TaskType.LOGISTIC_REGRESSION,
                    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM,
                )
                eval_records.append(avro_reports.evaluation_result(
                    model_id=f"{p.job_name}-lambda-{lam:g}",
                    model_path=os.path.join(p.output_dir, LEARNED_MODELS_TEXT),
                    data_path=p.validating_data_dir if on_validation else p.training_data_dir,
                    train_ctx=avro_reports.training_context(
                        p.task_type,
                        reg.l1_weight,
                        reg.l2_weight,
                        p.normalization_type != NormalizationType.NONE,
                        p.optimizer_type.value,
                        p.tolerance,
                        p.max_num_iterations,
                        ConvergenceReason(int(res.reason)) if res is not None else None,
                        p.training_data_dir,
                    ),
                    scalar_metrics=metrics,
                    # score only when the curves will consume it
                    scores=host(model.compute_mean_functions(eval_batch)) if with_curves else None,
                    labels=host(eval_batch.labels),
                    weights=host(eval_batch.weights),
                    with_curves=with_curves,
                ))

        if p.diagnostic_mode.runs_train and self.validation_batch is not None:
            # dataset-level bootstrap at the best (or first) lambda
            lam0 = self.best_reg_weight if self.best_reg_weight is not None else self.models[0][0]
            boot_problem = dataclasses.replace(
                diag_problem, regularization=self.problem.regularization.with_weight(lam0)
            )
            with span("bootstrap"):
                boot = bootstrap_diagnostic.diagnose(
                    boot_problem, self.train_batch, self.norm, self.validation_batch,
                    feature_names=feature_names,
                )
            model_reports[0].sections.append(bootstrap_diagnostic.to_section(boot))

        with span("report"):
            doc = assemble_document(
                f"{p.job_name} model diagnostics",
                SystemReport(
                    {
                        "task": p.task_type.value,
                        "optimizer": p.optimizer_type.value,
                        "regularization": p.regularization_type.value,
                        "lambdas": p.regularization_weights,
                        "normalization": p.normalization_type.value,
                        "training data": p.training_data_dir,
                        "validating data": p.validating_data_dir or "(none)",
                    },
                    self.summary,
                    feature_names,
                ),
                model_reports,
            )
            with open(os.path.join(p.output_dir, REPORT_FILE), "w") as f:
                f.write(render_html(doc))
            self.logger.info(f"wrote {REPORT_FILE}")

            diag_dir = os.path.join(p.output_dir, "diagnostics")
            avro_reports.write_evaluation_results(diag_dir, eval_records)
            avro_reports.write_feature_summaries(
                diag_dir, avro_reports.feature_summaries(feature_names, self.summary)
            )
        self.logger.info(
            f"wrote {len(eval_records)} EvaluationResultAvro + feature summaries "
            f"to {diag_dir}"
        )
        if self.stage == DriverStage.TRAINED:
            self._advance(DriverStage.VALIDATED)  # keep ordering monotone
        self._advance(DriverStage.DIAGNOSED)


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
