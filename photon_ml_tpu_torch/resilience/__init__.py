"""Resilience: fault injection, retry/backoff I/O, divergence guards and
cooperative preemption (port of photon_ml_tpu/resilience/__init__.py).

  * :mod:`faults` — deterministic fault injection at the named sites of
    :mod:`sites`, driven by :func:`fault_scope` or ``PHOTON_FAULTS``;
  * :mod:`retry` — backoff + jitter + deadline retry policies for Avro
    reads, index-map loads and checkpoint commits;
  * :mod:`guards` — non-finite detection in coordinate descent with
    last-good-state rollback;
  * :mod:`preemption` — SIGTERM/SIGINT (or ``PHOTON_PREEMPT_AT`` / a
    ``preempt.signal`` fault) set a flag coordinate descent polls between
    updates; it writes an emergency checkpoint and unwinds with
    :class:`Preempted`.

:class:`ResilienceConfig` is consulted by the ingest layer (``io/avro.py``
block reads, the native whole-file reads of ``io/avro_data.py``, index-map
and off-heap store loads) and by checkpoint commits. The CLI drivers install
it from their ``--on-corrupt`` / ``--corrupt-skip-budget`` / ``--io-retries``
flags with :func:`resilience_scope`.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Optional

from photon_ml_tpu_torch.resilience import faults, guards, preemption, retry, sites
from photon_ml_tpu_torch.resilience.faults import (
    FaultPlan,
    FaultSpec,
    InjectedFatalError,
    InjectedIOError,
    fault_scope,
)
from photon_ml_tpu_torch.resilience.guards import DivergenceGuard, GuardEvent, tree_all_finite
from photon_ml_tpu_torch.resilience.preemption import PREEMPT_EXIT_CODE, Preempted
from photon_ml_tpu_torch.resilience.retry import RetryError, RetryPolicy, call_with_retry
from photon_ml_tpu_torch.resilience.sites import FAULT_SITES, PREEMPT_SITES

__all__ = [
    "faults",
    "guards",
    "preemption",
    "retry",
    "sites",
    "FAULT_SITES",
    "PREEMPT_SITES",
    "PREEMPT_EXIT_CODE",
    "Preempted",
    "FaultPlan",
    "FaultSpec",
    "InjectedIOError",
    "InjectedFatalError",
    "fault_scope",
    "DivergenceGuard",
    "GuardEvent",
    "tree_all_finite",
    "ON_CORRUPT_MODES",
    "ResilienceConfig",
    "RetryError",
    "RetryPolicy",
    "call_with_retry",
    "current_config",
    "resilience_scope",
]

ON_CORRUPT_MODES = ("raise", "skip")


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Process-wide ingest resilience settings.

    ``on_corrupt="skip"`` lets Avro container reads drop corrupt blocks
    (resynchronizing on the sync marker) up to ``corrupt_skip_budget`` blocks
    per file before raising; ``io_policy`` is the retry policy every
    filesystem read uses.
    """

    on_corrupt: str = "raise"
    corrupt_skip_budget: int = 16
    io_policy: RetryPolicy = dataclasses.field(default_factory=RetryPolicy.io_default)

    def __post_init__(self):
        if self.on_corrupt not in ON_CORRUPT_MODES:
            raise ValueError(
                f"on_corrupt must be one of {ON_CORRUPT_MODES}, got {self.on_corrupt!r}"
            )
        if self.corrupt_skip_budget < 0:
            raise ValueError(
                f"corrupt_skip_budget must be >= 0, got {self.corrupt_skip_budget}"
            )


_config: Optional[ResilienceConfig] = None


def current_config() -> ResilienceConfig:
    """The installed config, else defaults (raise on corrupt, env-tuned retry)."""
    return _config if _config is not None else ResilienceConfig()


@contextlib.contextmanager
def resilience_scope(config: ResilienceConfig) -> Iterator[ResilienceConfig]:
    """``with resilience_scope(cfg):`` installs ``cfg`` for the duration."""
    global _config
    prev = _config
    _config = config
    try:
        yield config
    finally:
        _config = prev
