"""Core enums and the framework-wide real dtype (port of photon_ml_tpu/types.py).

Reference parity: TaskType mirrors supervised/TaskType.scala:28 of photon-ml;
OptimizerType, RegularizationType and NormalizationType mirror their
optimization/ and normalization/ counterparts. String values are identical to
the JAX package's, so configurations and enum values convert by ``.value``.
"""

from __future__ import annotations

import enum
import os

import torch

DTYPE_ENV = "PHOTON_ML_TPU_DTYPE"


class TaskType(enum.Enum):
    LINEAR_REGRESSION = "LINEAR_REGRESSION"
    POISSON_REGRESSION = "POISSON_REGRESSION"
    LOGISTIC_REGRESSION = "LOGISTIC_REGRESSION"
    SMOOTHED_HINGE_LOSS_LINEAR_SVM = "SMOOTHED_HINGE_LOSS_LINEAR_SVM"


class OptimizerType(enum.Enum):
    LBFGS = "LBFGS"
    TRON = "TRON"


class RegularizationType(enum.Enum):
    NONE = "NONE"
    L1 = "L1"
    L2 = "L2"
    ELASTIC_NET = "ELASTIC_NET"


class NormalizationType(enum.Enum):
    NONE = "NONE"
    SCALE_WITH_MAX_MAGNITUDE = "SCALE_WITH_MAX_MAGNITUDE"
    SCALE_WITH_STANDARD_DEVIATION = "SCALE_WITH_STANDARD_DEVIATION"
    STANDARDIZATION = "STANDARDIZATION"


class DataValidationType(enum.Enum):
    VALIDATE_FULL = "VALIDATE_FULL"
    VALIDATE_SAMPLE = "VALIDATE_SAMPLE"
    VALIDATE_DISABLED = "VALIDATE_DISABLED"


class ModelOutputMode(enum.Enum):
    ALL = "ALL"
    BEST = "BEST"
    NONE = "NONE"


class ProjectorType(enum.Enum):
    """projector/ProjectorType.scala:22-30 parity."""

    RANDOM = "RANDOM"
    INDEX_MAP = "INDEX_MAP"
    IDENTITY = "IDENTITY"


class ConvergenceReason(enum.IntEnum):
    """Why an optimizer stopped (AbstractOptimizer.scala:47-61 parity).

    Integer-coded so it can live in a tensor of the solver state.
    """

    NOT_CONVERGED = 0
    MAX_ITERATIONS = 1
    FUNCTION_VALUES_CONVERGED = 2
    GRADIENT_CONVERGED = 3
    OBJECTIVE_NOT_IMPROVING = 4


def real_dtype() -> torch.dtype:
    """Framework-wide real dtype for features, labels and coefficients.

    float32 by default; ``PHOTON_ML_TPU_DTYPE=float64`` selects reference
    precision (the reference is JVM doubles throughout). Anything else is
    rejected loudly.
    """
    name = os.environ.get(DTYPE_ENV, "float32").strip() or "float32"
    if name == "float32":
        return torch.float32
    if name == "float64":
        return torch.float64
    raise ValueError(f"{DTYPE_ENV}={name!r}: only float32/float64 are supported")
