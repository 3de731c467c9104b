"""Capture telemetry: per-site CUDA-graph captures and replays (port of
photon_ml_tpu/compile/stats.py).

The JAX module counts ``jax.jit`` traces (a cache miss: the body runs only
while traced) and calls per named site, and harvests XLA's persistent-cache
events. The port runs eagerly; what it compiles once and reuses is a CUDA
graph. So here a **trace** is a capture of a site's graph (the body runs
while the stream records it) and a **call** is a replay:

  * :func:`instrumented_capture` is ``instrumented_jit``'s counterpart: a
    site that captures its body once per key and replays the graph after
    that, counting both and the seconds the capturing calls took;
  * :class:`CompileStats` keeps the counters under the JAX names
    (``traces``, ``calls``, ``cache_hits`` = replays of an existing graph,
    ``compile_seconds`` = seconds in capturing calls).

XLA's persistent compilation cache has no counterpart: the port builds its
kernels with nvcc (``native_build``) and keeps no compiled-graph cache
across processes. ``install_xla_listeners`` returns False and the summary
says so.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Hashable

__all__ = ["CompileStats", "CompileWatermark", "SiteStats", "compile_stats",
           "instrumented_capture"]


@dataclasses.dataclass
class SiteStats:
    """Counters for one capture site: ``calls`` replays and captures in
    all, ``traces`` captures, ``compile_seconds`` in capturing calls."""

    calls: int = 0
    traces: int = 0
    compile_seconds: float = 0.0

    @property
    def cache_hits(self) -> int:
        return self.calls - self.traces


class CompileStats:
    """Process-wide capture-telemetry registry (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sites: Dict[str, SiteStats] = {}
        # XLA's persistent-cache counters: nothing feeds them in the port
        self.xla_cache_hits = 0
        self.xla_cache_misses = 0
        self.backend_compile_seconds = 0.0

    def site(self, name: str) -> SiteStats:
        with self._lock:
            return self._sites.setdefault(name, SiteStats())

    def record_trace(self, name: str) -> None:
        with self._lock:
            self._sites.setdefault(name, SiteStats()).traces += 1

    def record_call(self, name: str, seconds: float, traced: bool) -> None:
        with self._lock:
            s = self._sites.setdefault(name, SiteStats())
            s.calls += 1
            if traced:
                s.compile_seconds += seconds

    def snapshot(self) -> Dict[str, dict]:
        """{site: {calls, traces, cache_hits, compile_seconds}} copy."""
        with self._lock:
            return {
                name: {
                    "calls": s.calls,
                    "traces": s.traces,
                    "cache_hits": s.cache_hits,
                    "compile_seconds": round(s.compile_seconds, 4),
                }
                for name, s in sorted(self._sites.items())
            }

    def traces_of(self, name: str) -> int:
        with self._lock:
            s = self._sites.get(name)
            return s.traces if s is not None else 0

    def total_traces(self) -> int:
        with self._lock:
            return sum(s.traces for s in self._sites.values())

    def reset(self) -> None:
        """Zero every counter (tests, and a run's own accounting)."""
        with self._lock:
            self._sites.clear()
            self.xla_cache_hits = 0
            self.xla_cache_misses = 0
            self.backend_compile_seconds = 0.0

    def summary(self) -> str:
        """One-line-per-site driver-log summary."""
        snap = self.snapshot()
        lines = [
            f"compile stats: {len(snap)} capture sites, "
            f"{sum(v['traces'] for v in snap.values())} CUDA-graph captures / "
            f"{sum(v['calls'] for v in snap.values())} calls (captures and replays); "
            "XLA cache: no counterpart in the port (kernels built by nvcc, no "
            "cross-process graph cache)"
        ]
        for name, v in snap.items():
            lines.append(
                f"  {name}: {v['traces']} captures / {v['calls']} calls "
                f"({v['compile_seconds']:.2f}s in capturing calls)"
            )
        return "\n".join(lines)

    def watermark(self) -> "CompileWatermark":
        """The current counters; the watermark reports the captures made
        since."""
        with self._lock:
            return CompileWatermark(
                self,
                sum(s.traces for s in self._sites.values()),
                self.xla_cache_misses,
            )

    def install_xla_listeners(self) -> bool:
        """XLA's compilation-cache events have no counterpart in the port:
        always False (telemetry covers capture sites only)."""
        return False


@dataclasses.dataclass(frozen=True)
class CompileWatermark:
    """A point-in-time snapshot of the capture counters (see
    :meth:`CompileStats.watermark`)."""

    stats: CompileStats
    traces0: int
    xla_misses0: int

    def new_traces(self) -> int:
        return self.stats.total_traces() - self.traces0

    def new_xla_misses(self) -> int:
        return self.stats.xla_cache_misses - self.xla_misses0

    def clean(self) -> bool:
        """True when nothing was captured since the watermark."""
        return self.new_traces() == 0 and self.new_xla_misses() == 0


#: THE process-wide registry every capture site reports into.
compile_stats = CompileStats()


def instrumented_capture(site: str, key: Hashable, cache: dict,
                         capture: Callable[[], object], replay: Callable[[object], object]):
    """``instrumented_jit``'s counterpart: ``capture()`` builds the site's
    graph for ``key`` once (counted as a trace) and ``replay(graph)`` runs
    it (every call counted). Returns what ``replay`` returns."""
    t0 = time.perf_counter()
    traced = key not in cache
    if traced:
        compile_stats.record_trace(site)
        cache[key] = capture()
    out = replay(cache[key])
    compile_stats.record_call(site, time.perf_counter() - t0, traced=traced)
    return out
