"""Ingest resilience: the process-wide corrupt-shard and retry settings
(port of the configuration part of photon_ml_tpu/resilience/__init__.py).

:class:`ResilienceConfig` is consulted by the ingest layer (``io/avro.py``
block reads, the native whole-file reads of ``io/avro_data.py``, index-map
and off-heap store loads). The CLI drivers install it from their
``--on-corrupt`` / ``--corrupt-skip-budget`` / ``--io-retries`` flags with
:func:`resilience_scope`. Fault injection, divergence guards and preemption
are not yet ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Optional

from photon_ml_tpu_torch.resilience.retry import RetryError, RetryPolicy, call_with_retry

__all__ = [
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
