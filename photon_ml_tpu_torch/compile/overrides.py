"""The environment gate (port of photon_ml_tpu/compile/overrides.py):
``env_read``, the planner mode (``--plan`` / ``PHOTON_PLAN``) and the
``Overrides`` snapshot an execution plan carries beside its decisions.

The snapshot holds what the port has of the JAX package's knobs, each read
by its own reader: the precision knob by ``types.dtype_name`` and the
sparse-transpose knob by ``ops/features.sparse_transpose_forced``.
``donate`` keeps the JAX package's field list and drives nothing here:
PyTorch has no buffer donation, so nothing reads ``PHOTON_DONATE``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

__all__ = [
    "PLAN_ENV",
    "SOLVE_CHUNK_ENV",
    "Overrides",
    "env_read",
    "resolve_overrides",
    "resolve_plan_mode",
    "solve_chunk_spec",
]

PLAN_ENV = "PHOTON_PLAN"
SOLVE_CHUNK_ENV = "PHOTON_SOLVE_CHUNK"

_FALSEY = ("0", "false", "off", "no")


def env_read(name: str, default: Optional[str] = None) -> Optional[str]:
    """The one place the plan's knobs are read from the environment."""
    return os.environ.get(name, default)


def resolve_plan_mode(spec: Optional[str] = None) -> str:
    """Effective planner mode: explicit value wins; ``None`` falls back to
    ``PHOTON_PLAN``. Returns ``"off"`` (today's behavior, bitwise) or
    ``"auto"`` (cost-model-driven choices for unset knobs)."""
    if spec is None:
        spec = env_read(PLAN_ENV)
    if spec is None:
        return "off"
    text = str(spec).strip().lower()
    if text in ("", *_FALSEY, "none"):
        return "off"
    if text in ("on", "auto", "1", "true"):
        return "auto"
    raise ValueError(f"bad --plan / {PLAN_ENV} spec {spec!r} (want off | auto)")


def solve_chunk_spec() -> Optional[str]:
    """Raw ``PHOTON_SOLVE_CHUNK`` value (grammar — ``off`` | ``on`` |
    ``CHUNK`` | ``device[:CHUNK]`` — parsed by scheduler.resolve_schedule,
    which owns the schedule vocabulary)."""
    return env_read(SOLVE_CHUNK_ENV)


@dataclasses.dataclass(frozen=True)
class Overrides:
    """The environment knobs as resolved once by
    :meth:`ExecutionPlan.resolve`, carried beside the plan's decisions.
    ``donate`` is always True and drives nothing in the port (no buffer
    donation in PyTorch); it keeps the JAX package's field list."""

    plan_mode: str = "off"
    dtype: str = "float32"
    sparse_transpose: bool = True
    donate: bool = True


def resolve_overrides(plan: Optional[str] = None) -> Overrides:
    """Read every knob exactly once into a frozen snapshot."""
    from photon_ml_tpu_torch.ops.features import sparse_transpose_forced
    from photon_ml_tpu_torch.types import dtype_name

    return Overrides(
        plan_mode=resolve_plan_mode(plan),
        dtype=dtype_name(),
        sparse_transpose=sparse_transpose_forced(),
    )
