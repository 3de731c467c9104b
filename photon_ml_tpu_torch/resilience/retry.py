"""Retry policies: exponential backoff + deterministic jitter + deadline
(a copy of photon_ml_tpu/resilience/retry.py).

The reference leans on Spark's task re-execution for transient I/O failures
(a failed partition read is simply recomputed from lineage); this package
reads Avro shards and index maps directly from the filesystem, so transient
failures are retried in-process. One policy object serves every I/O layer:

  * Avro part-file block reads and native whole-file reads (io/avro.py,
    io/avro_data.py)
  * index-map / off-heap store loads (io/index_map.py, io/offheap.py)

Delays follow ``base_delay * multiplier**attempt`` capped at ``max_delay``,
with proportional jitter drawn from a seeded RNG (deterministic in tests),
and an optional wall-clock ``deadline`` that bounds total retry time.

Environment overrides (read by :func:`RetryPolicy.io_default`):
``PHOTON_IO_RETRIES``, ``PHOTON_IO_RETRY_BASE_DELAY``,
``PHOTON_IO_RETRY_MAX_DELAY``, ``PHOTON_IO_RETRY_DEADLINE``.
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import Any, Callable, Optional, Tuple, Type

__all__ = ["RetryPolicy", "RetryError", "call_with_retry"]


class RetryError(OSError):
    """All attempts failed; chains the last underlying error via __cause__."""


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name} must be a number, got {raw!r}")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Immutable retry configuration (shareable across call sites)."""

    max_attempts: int = 4
    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.1  # +/- fraction of the computed delay
    deadline: Optional[float] = None  # total seconds across all attempts
    retryable: Tuple[Type[BaseException], ...] = (OSError,)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.multiplier < 1.0:
            raise ValueError(f"multiplier must be >= 1, got {self.multiplier}")
        if not (0.0 <= self.jitter <= 1.0):
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")

    def delay_for(self, attempt: int, rng: random.Random) -> float:
        """Backoff before retry number ``attempt`` (0-based failed attempt)."""
        d = min(self.base_delay * (self.multiplier ** attempt), self.max_delay)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(d, 0.0)

    @staticmethod
    def io_default() -> "RetryPolicy":
        """The default filesystem policy, with env overrides applied."""
        return RetryPolicy(
            max_attempts=int(_env_float("PHOTON_IO_RETRIES", 4)),
            base_delay=_env_float("PHOTON_IO_RETRY_BASE_DELAY", 0.05),
            max_delay=_env_float("PHOTON_IO_RETRY_MAX_DELAY", 2.0),
            deadline=(
                _env_float("PHOTON_IO_RETRY_DEADLINE", 0.0) or None
            ),
        )

    @staticmethod
    def no_retry() -> "RetryPolicy":
        return RetryPolicy(max_attempts=1)


def call_with_retry(
    fn: Callable[[], Any],
    policy: Optional[RetryPolicy] = None,
    describe: str = "",
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
    rng: Optional[random.Random] = None,
    clock: Callable[[], float] = time.monotonic,
) -> Any:
    """Call ``fn`` under ``policy``; raise :class:`RetryError` when exhausted.

    Only exceptions in ``policy.retryable`` are retried — anything else
    (e.g. a corrupt-data ValueError, where retrying cannot help) propagates
    immediately. ``on_retry(attempt, error, delay)`` observes each retry
    (used for warning logs). ``sleep``/``rng``/``clock`` are injectable so
    tests run instantly and deterministically.
    """
    if policy is None:
        policy = RetryPolicy.io_default()
    if rng is None:
        rng = random.Random(0)
    start = clock()
    last: Optional[BaseException] = None
    for attempt in range(policy.max_attempts):
        try:
            return fn()
        except policy.retryable as e:
            last = e
            if attempt + 1 >= policy.max_attempts:
                break
            delay = policy.delay_for(attempt, rng)
            if policy.deadline is not None and (
                clock() - start + delay > policy.deadline
            ):
                break
            if on_retry is not None:
                on_retry(attempt, e, delay)
            if delay > 0:
                sleep(delay)
    what = describe or getattr(fn, "__name__", "operation")
    raise RetryError(
        f"{what} failed after {policy.max_attempts} attempt(s): {last}"
    ) from last

