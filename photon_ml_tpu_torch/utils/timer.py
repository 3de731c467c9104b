"""Wall-clock span timer used throughout the drivers.

(A copy of photon_ml_tpu/utils/timer.py.) Reference spec: util/Timer.scala:32-235 — start/stop/measure named spans;
every driver phase and every coordinate update is timed and logged.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional


class Timer:
    """Named wall-clock spans with cumulative totals."""

    def __init__(self, log_fn: Optional[Callable[[str], None]] = None):
        self._starts: Dict[str, float] = {}
        self.totals: Dict[str, float] = {}
        self._log = log_fn

    def start(self, name: str) -> None:
        if name in self._starts:
            raise RuntimeError(f"timer '{name}' already started")
        self._starts[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        if name not in self._starts:
            raise RuntimeError(f"timer '{name}' was not started")
        elapsed = time.perf_counter() - self._starts.pop(name)
        self.totals[name] = self.totals.get(name, 0.0) + elapsed
        if self._log:
            self._log(f"{name}: {elapsed:.3f}s")
        return elapsed

    @contextlib.contextmanager
    def measure(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    def summary(self) -> str:
        return "\n".join(f"{k}: {v:.3f}s" for k, v in sorted(self.totals.items()))
