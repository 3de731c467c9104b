"""GLM driver parameters + command-line parser (port of
photon_ml_tpu/cli/glm_params.py).

Reference spec: Params.scala:42-205 and OptionNames.scala:24-59. Flag names
are the JAX driver's, plus ``--device`` (default ``cuda``). The out-of-core
flags ``--streaming-chunk-rows``, ``--tensor-cache`` and
``--shape-canonicalization`` run; ``--persistent-cache DIR`` builds and
loads the port's compiled code (the CUDA kernels and host libraries) in DIR,
the counterpart of XLA's compilation cache (native_build.use_persistent_cache).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

from photon_ml_tpu_torch.diagnostics.types import DiagnosticMode
from photon_ml_tpu_torch.types import (
    DataValidationType,
    NormalizationType,
    OptimizerType,
    RegularizationType,
    TaskType,
)

DEFAULT_MAX_ITERATIONS = 80
DEFAULT_TOLERANCE = 1e-6  # Params.scala:74 driver default


class InputFormatType:
    AVRO = "AVRO"
    LIBSVM = "LIBSVM"


class FieldNamesType:
    TRAINING_EXAMPLE = "TRAINING_EXAMPLE"
    RESPONSE_PREDICTION = "RESPONSE_PREDICTION"


@dataclasses.dataclass
class GLMParams:
    """Typed param container (Params.scala:42-205 parity)."""

    training_data_dir: str = ""
    output_dir: str = ""
    task_type: TaskType = TaskType.LOGISTIC_REGRESSION
    validating_data_dir: Optional[str] = None
    job_name: str = "photon-ml-tpu"
    regularization_weights: List[float] = dataclasses.field(default_factory=lambda: [0.1, 1.0, 10.0, 100.0])
    regularization_type: RegularizationType = RegularizationType.L2
    elastic_net_alpha: Optional[float] = None
    add_intercept: bool = True
    max_num_iterations: int = DEFAULT_MAX_ITERATIONS
    tolerance: float = DEFAULT_TOLERANCE
    field_names_type: str = FieldNamesType.TRAINING_EXAMPLE
    optimizer_type: OptimizerType = OptimizerType.LBFGS
    enable_optimization_state_tracker: bool = True
    validate_per_iteration: bool = False
    summarization_output_dir: Optional[str] = None
    normalization_type: NormalizationType = NormalizationType.NONE
    coefficient_box_constraints: Optional[str] = None
    data_validation_type: DataValidationType = DataValidationType.VALIDATE_FULL
    diagnostic_mode: DiagnosticMode = DiagnosticMode.NONE
    selected_features_file: Optional[str] = None
    offheap_indexmap_dir: Optional[str] = None
    offheap_indexmap_num_partitions: int = 1
    delete_output_dirs_if_exist: bool = False
    input_file_format: str = InputFormatType.AVRO
    feature_dimension: int = -1
    compute_variance: bool = False
    streaming_chunk_rows: int = 0
    tensor_cache_dir: Optional[str] = None
    persistent_cache_dir: Optional[str] = None
    shape_canonicalization: str = "off"
    # obsolete Spark-era knobs, accepted for CLI compatibility and ignored
    tree_aggregate_depth: int = 1
    use_kryo: bool = True
    min_num_partitions: int = 1
    # where tensors live: "cuda" (default) or "cpu"
    device: str = "cuda"

    def validate(self) -> None:
        """Cross-field validation (Params.scala:175-197 parity)."""
        errors = []
        if not self.training_data_dir:
            errors.append("--training-data-directory is required")
        if not self.output_dir:
            errors.append("--output-directory is required")
        if self.optimizer_type == OptimizerType.TRON and self.regularization_type in (
            RegularizationType.L1,
            RegularizationType.ELASTIC_NET,
        ):
            errors.append(
                f"TRON optimizer does not support {self.regularization_type.value} "
                "regularization"
            )
        if self.task_type == TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM and (
            self.optimizer_type == OptimizerType.TRON
        ):
            errors.append("smoothed hinge loss is first-order only; use LBFGS")
        if self.regularization_type == RegularizationType.ELASTIC_NET:
            a = self.elastic_net_alpha
            if a is not None and not (0.0 <= a <= 1.0):
                errors.append(f"elastic net alpha must be in [0, 1], got {a}")
        for w in self.regularization_weights:
            if w < 0:
                errors.append(f"negative regularization weight {w}")
        if self.validate_per_iteration and self.validating_data_dir is None:
            errors.append("--validate-per-iteration requires --validating-data-directory")
        if self.streaming_chunk_rows > 0:
            if self.validate_per_iteration:
                errors.append(
                    "--streaming-chunk-rows does not keep per-iteration "
                    "coefficient snapshots (--validate-per-iteration)"
                )
            if self.diagnostic_mode != DiagnosticMode.NONE:
                errors.append(
                    "--streaming-chunk-rows does not support --diagnostic-mode "
                    "(diagnostics need the in-memory batch)"
                )
        try:
            from photon_ml_tpu_torch.compile import resolve_bucketer

            resolve_bucketer(self.shape_canonicalization)
        except ValueError as e:
            errors.append(f"--shape-canonicalization: {e}")
        if self.diagnostic_mode.runs_validate and self.validating_data_dir is None:
            errors.append(
                f"diagnostic mode {self.diagnostic_mode.value} requires "
                "--validating-data-directory"
            )
        if self.device not in ("cuda", "cpu"):
            errors.append(f"--device must be cuda or cpu, got {self.device!r}")
        if errors:
            raise ValueError("; ".join(errors))


def _bool_flag(v: str) -> bool:
    return v.strip().lower() in ("true", "1", "yes")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photon-ml-tpu-torch glm",
        description="Train a generalized linear model on the card (reference Driver parity)",
    )
    a = p.add_argument
    a("--training-data-directory", dest="training_data_dir", required=True)
    a("--output-directory", dest="output_dir", required=True)
    a("--task", dest="task_type", required=True, choices=[t.value for t in TaskType])
    a("--validating-data-directory", dest="validating_data_dir", default=None)
    a("--job-name", dest="job_name", default="photon-ml-tpu")
    a("--regularization-weights", dest="regularization_weights",
      default="0.1,1,10,100", help="comma-separated lambda list")
    a("--regularization-type", dest="regularization_type", default="L2",
      choices=[t.value for t in RegularizationType])
    a("--elastic-net-alpha", dest="elastic_net_alpha", type=float, default=None)
    a("--intercept", dest="add_intercept", type=_bool_flag, default=True)
    a("--num-iterations", dest="max_num_iterations", type=int, default=DEFAULT_MAX_ITERATIONS)
    a("--convergence-tolerance", dest="tolerance", type=float, default=DEFAULT_TOLERANCE)
    a("--format", dest="field_names_type", default=FieldNamesType.TRAINING_EXAMPLE,
      choices=[FieldNamesType.TRAINING_EXAMPLE, FieldNamesType.RESPONSE_PREDICTION])
    a("--optimizer", dest="optimizer_type", default="LBFGS",
      choices=[t.value for t in OptimizerType])
    a("--optimization-tracker", dest="enable_optimization_state_tracker",
      type=_bool_flag, default=True)
    a("--validate-per-iteration", dest="validate_per_iteration", type=_bool_flag, default=False)
    a("--summarization-output-dir", dest="summarization_output_dir", default=None)
    a("--normalization-type", dest="normalization_type", default="NONE",
      choices=[t.value for t in NormalizationType])
    a("--coefficient-box-constraints", dest="coefficient_box_constraints", default=None)
    a("--data-validation-type", dest="data_validation_type", default="VALIDATE_FULL",
      choices=[t.value for t in DataValidationType])
    a("--diagnostic-mode", dest="diagnostic_mode", default="NONE",
      choices=[m.value for m in DiagnosticMode])
    a("--selected-features-file", dest="selected_features_file", default=None)
    a("--offheap-indexmap-dir", dest="offheap_indexmap_dir", default=None)
    a("--offheap-indexmap-num-partitions", dest="offheap_indexmap_num_partitions",
      type=int, default=1)
    a("--delete-output-dirs-if-exist", dest="delete_output_dirs_if_exist",
      type=_bool_flag, default=False)
    a("--input-file-format", dest="input_file_format", default=InputFormatType.AVRO,
      choices=[InputFormatType.AVRO, InputFormatType.LIBSVM])
    a("--feature-dimension", dest="feature_dimension", type=int, default=-1)
    a("--compute-variance", dest="compute_variance", type=_bool_flag, default=False)
    a("--kryo", dest="use_kryo", type=_bool_flag, default=True)
    a("--min-partitions", dest="min_num_partitions", type=int, default=1)
    a("--tree-aggregate-depth", dest="tree_aggregate_depth", type=int, default=1)
    a("--streaming-chunk-rows", dest="streaming_chunk_rows", type=int, default=0)
    a("--tensor-cache", dest="tensor_cache_dir", default=None)
    a("--persistent-cache", dest="persistent_cache_dir", default=None)
    a("--shape-canonicalization", dest="shape_canonicalization", default="off")
    a("--device", dest="device", default="cuda", choices=["cuda", "cpu"],
      help="where tensors live and the solve runs (default cuda; cuda without "
           "a card raises)")
    return p


def parse_from_command_line(argv: Optional[List[str]] = None) -> GLMParams:
    ns = build_parser().parse_args(argv)
    params = GLMParams(
        training_data_dir=ns.training_data_dir,
        output_dir=ns.output_dir,
        task_type=TaskType(ns.task_type),
        validating_data_dir=ns.validating_data_dir,
        job_name=ns.job_name,
        regularization_weights=[float(w) for w in str(ns.regularization_weights).split(",") if w],
        regularization_type=RegularizationType(ns.regularization_type),
        elastic_net_alpha=ns.elastic_net_alpha,
        add_intercept=ns.add_intercept,
        max_num_iterations=ns.max_num_iterations,
        tolerance=ns.tolerance,
        field_names_type=ns.field_names_type,
        optimizer_type=OptimizerType(ns.optimizer_type),
        enable_optimization_state_tracker=ns.enable_optimization_state_tracker,
        validate_per_iteration=ns.validate_per_iteration,
        summarization_output_dir=ns.summarization_output_dir,
        normalization_type=NormalizationType(ns.normalization_type),
        coefficient_box_constraints=ns.coefficient_box_constraints,
        data_validation_type=DataValidationType(ns.data_validation_type),
        diagnostic_mode=DiagnosticMode(ns.diagnostic_mode),
        selected_features_file=ns.selected_features_file,
        offheap_indexmap_dir=ns.offheap_indexmap_dir,
        offheap_indexmap_num_partitions=ns.offheap_indexmap_num_partitions,
        delete_output_dirs_if_exist=ns.delete_output_dirs_if_exist,
        input_file_format=ns.input_file_format,
        feature_dimension=ns.feature_dimension,
        compute_variance=ns.compute_variance,
        streaming_chunk_rows=ns.streaming_chunk_rows,
        tensor_cache_dir=ns.tensor_cache_dir,
        persistent_cache_dir=ns.persistent_cache_dir,
        shape_canonicalization=ns.shape_canonicalization,
        use_kryo=ns.use_kryo,
        min_num_partitions=ns.min_num_partitions,
        tree_aggregate_depth=ns.tree_aggregate_depth,
        device=ns.device,
    )
    params.validate()
    return params
