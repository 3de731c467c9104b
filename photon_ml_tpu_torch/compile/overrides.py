"""The environment gate (port of photon_ml_tpu/compile/overrides.py, the
part the solve schedule needs): ``env_read`` and ``PHOTON_SOLVE_CHUNK``.

The JAX module also resolves the planner mode, the dtype, the transpose
and donation knobs into one ``Overrides`` snapshot for ``--plan``; that
part waits for the planner's port. Standard library only.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["SOLVE_CHUNK_ENV", "env_read", "solve_chunk_spec"]

SOLVE_CHUNK_ENV = "PHOTON_SOLVE_CHUNK"


def env_read(name: str, default: Optional[str] = None) -> Optional[str]:
    """The one place the schedule's knobs are read from the environment."""
    return os.environ.get(name, default)


def solve_chunk_spec() -> Optional[str]:
    """Raw ``PHOTON_SOLVE_CHUNK`` value (grammar — ``off`` | ``on`` |
    ``CHUNK`` | ``device[:CHUNK]`` — parsed by scheduler.resolve_schedule,
    which owns the schedule vocabulary)."""
    return env_read(SOLVE_CHUNK_ENV)
