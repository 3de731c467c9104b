"""Shape canonicalization and capture telemetry (port of
photon_ml_tpu/compile/: the ladder, ``ShapeBucketer`` and the masked padding
of random-effect datasets; the CUDA-graph counters of ``stats``; the
environment gate, the planner's cost model and the execution plan)."""

from __future__ import annotations

from photon_ml_tpu_torch.compile.canonical import (
    ShapeBucketer,
    canonicalize_re_arrays,
    canonicalize_re_dataset,
    pad_axis,
    pad_glm_chunk,
    resolve_bucketer,
)
from photon_ml_tpu_torch.compile.cost import CostModel, WorkloadProfile
from photon_ml_tpu_torch.compile.overrides import Overrides, resolve_overrides
from photon_ml_tpu_torch.compile.stats import (
    CompileStats,
    CompileWatermark,
    compile_stats,
    instrumented_capture,
)

__all__ = [
    "CompileStats",
    "CompileWatermark",
    "CostModel",
    "Overrides",
    "ShapeBucketer",
    "WorkloadProfile",
    "canonicalize_re_arrays",
    "compile_stats",
    "instrumented_capture",
    "canonicalize_re_dataset",
    "pad_axis",
    "pad_glm_chunk",
    "resolve_bucketer",
    "resolve_overrides",
]
