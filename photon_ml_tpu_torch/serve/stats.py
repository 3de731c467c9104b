"""Serving telemetry: request latency percentiles, batch fill, QPS (port of
photon_ml_tpu/serve/stats.py).

The registry mirrors :mod:`photon_ml_tpu_torch.compile.stats` — a thread-safe
process-wide instance (``serve_stats``) every server records into, a
``snapshot()`` the tests/bench assert on, and a one-screen ``summary()``
the serve driver logs next to ``compile_stats.summary()``.

What gets recorded:

  * per REQUEST: end-to-end latency (submit -> response ready), row count.
    Latencies feed a bounded-memory streaming digest
    (:class:`photon_ml_tpu_torch.slo.quantiles.StreamingQuantileDigest`):
    exact nearest-rank percentiles up to ``max_samples`` raw samples
    (bit-identical to the old sorted-deque accounting), then O(1) P²
    estimation over EVERY sample since the last reset — a day-long
    million-request run keeps honest p50/p99 without holding a latency
    per request or silently windowing to the newest samples.
  * per BATCH: real rows vs ladder-padded rows (the fill ratio — how much
    of each canonical batch shape's work was real) and the number of
    requests coalesced into it (avg requests/batch is THE number the
    micro-batcher exists to raise).
  * swaps: count + the new batch shapes each one's probe met.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from photon_ml_tpu_torch.slo.quantiles import StreamingQuantileDigest


class ServeStats:
    """Thread-safe serving-telemetry registry (batcher worker, responder
    threads, and in-process callers all record concurrently)."""

    def __init__(self, max_samples: int = 100_000):
        self._lock = threading.Lock()
        # max_samples bounds the EXACT regime: up to that many raw
        # latencies are kept (and percentiles are exact nearest-rank,
        # the historical behavior); past it the digest flips to P²
        # markers seeded from the exact sample and memory stays O(1)
        self._latencies = StreamingQuantileDigest(
            (0.50, 0.99), exact_limit=max_samples
        )
        self.requests = 0
        self.rows = 0
        self.batches = 0
        self.batch_rows_real = 0
        self.batch_rows_padded = 0
        self.batch_requests = 0
        self.errors = 0
        self.swaps = 0
        self.swap_compiles = 0
        # store-footprint gauges (set at bundle install, overwritten by a
        # swap — they always describe the CURRENTLY serving store)
        self.store_slab_bytes = 0
        self.store_mapped_bytes = 0
        self.store_dtype: Optional[str] = None
        self._first_ts: Optional[float] = None
        self._last_ts: Optional[float] = None

    # -- recording ----------------------------------------------------------
    def record_request(self, latency_s: float, num_rows: int = 1) -> None:
        now = time.monotonic()
        with self._lock:
            self._latencies.add(latency_s)
            self.requests += 1
            self.rows += num_rows
            if self._first_ts is None:
                self._first_ts = now
            self._last_ts = now

    def record_batch(self, rows_real: int, rows_padded: int, num_requests: int) -> None:
        with self._lock:
            self.batches += 1
            self.batch_rows_real += rows_real
            self.batch_rows_padded += rows_padded
            self.batch_requests += num_requests

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    def record_swap(self, new_compiles: int) -> None:
        with self._lock:
            self.swaps += 1
            self.swap_compiles += new_compiles

    def record_store_footprint(
        self, slab_bytes_disk: int, mapped_bytes: int, store_dtype: str
    ) -> None:
        """Gauge update from :meth:`ModelStore.footprint` — recorded at
        every bundle install so the summary always shows the bytes and
        dtype of the store actually serving."""
        with self._lock:
            self.store_slab_bytes = int(slab_bytes_disk)
            self.store_mapped_bytes = int(mapped_bytes)
            self.store_dtype = store_dtype

    # -- reading ------------------------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            span = (
                (self._last_ts - self._first_ts)
                if self._first_ts is not None and self._last_ts is not None
                else 0.0
            )
            return {
                "requests": self.requests,
                "rows": self.rows,
                "errors": self.errors,
                "batches": self.batches,
                "p50_ms": round(self._latencies.quantile(0.50) * 1e3, 3),
                "p99_ms": round(self._latencies.quantile(0.99) * 1e3, 3),
                "qps": round(self.requests / span, 1) if span > 0 else 0.0,
                "rows_per_sec": round(self.rows / span, 1) if span > 0 else 0.0,
                "batch_fill_ratio": (
                    round(self.batch_rows_real / self.batch_rows_padded, 4)
                    if self.batch_rows_padded
                    else 0.0
                ),
                "avg_batch_rows": (
                    round(self.batch_rows_real / self.batches, 2)
                    if self.batches
                    else 0.0
                ),
                "avg_requests_per_batch": (
                    round(self.batch_requests / self.batches, 2)
                    if self.batches
                    else 0.0
                ),
                "swaps": self.swaps,
                "swap_compiles": self.swap_compiles,
                "store_slab_bytes": self.store_slab_bytes,
                "store_mapped_bytes": self.store_mapped_bytes,
                "store_dtype": self.store_dtype or "",
            }

    def reset(self) -> None:
        with self._lock:
            self._latencies.reset()
            self.requests = 0
            self.rows = 0
            self.batches = 0
            self.batch_rows_real = 0
            self.batch_rows_padded = 0
            self.batch_requests = 0
            self.errors = 0
            self.swaps = 0
            self.swap_compiles = 0
            # store footprint gauges survive reset: they describe the
            # store currently serving, not traffic since the last reset
            self._first_ts = None
            self._last_ts = None

    def summary(self) -> str:
        """One-screen driver-log summary (the compile_stats.summary shape)."""
        s = self.snapshot()
        return (
            f"serve stats: {s['requests']} requests / {s['rows']} rows in "
            f"{s['batches']} batches; latency p50 {s['p50_ms']:.3f}ms / "
            f"p99 {s['p99_ms']:.3f}ms; {s['qps']:.1f} req/s "
            f"({s['rows_per_sec']:.1f} rows/s); batch fill "
            f"{s['batch_fill_ratio']:.2%} (avg {s['avg_batch_rows']} rows / "
            f"{s['avg_requests_per_batch']} requests per batch); "
            f"{s['errors']} errors; {s['swaps']} swaps "
            f"({s['swap_compiles']} swap compiles); store "
            f"{s['store_dtype'] or 'n/a'}: "
            f"{s['store_slab_bytes'] / 1e6:.2f}MB slabs on disk / "
            f"{s['store_mapped_bytes'] / 1e6:.2f}MB mapped"
        )


class FleetStats(ServeStats):
    """Router-side fleet telemetry on top of the per-server registry:
    scatter fan-out, hedges, routed retries, degraded rows (a dead owner's
    random-effect contribution replaced by the cold-entity 0), and
    fleet-swap accounting. The request/latency/QPS surface is inherited so
    the serve driver's stats command works unchanged against a router. The
    fleet that records into it is not yet ported."""

    def __init__(self, max_samples: int = 100_000):
        super().__init__(max_samples)
        self.scatter_calls = 0
        self.hedges = 0
        self.reroutes = 0
        self.routed_retries = 0
        self.stale_rescores = 0
        self.degraded_rows = 0
        self.dead_replica_skips = 0

    def record_scatter(self, num_subrequests: int) -> None:
        with self._lock:
            self.scatter_calls += num_subrequests

    def record_hedge(self) -> None:
        with self._lock:
            self.hedges += 1

    def record_reroute(self) -> None:
        with self._lock:
            self.reroutes += 1

    def record_routed_retry(self) -> None:
        with self._lock:
            self.routed_retries += 1

    def record_stale_rescore(self) -> None:
        with self._lock:
            self.stale_rescores += 1

    def record_degraded_rows(self, n: int) -> None:
        with self._lock:
            self.degraded_rows += n

    def record_dead_replica_skip(self) -> None:
        with self._lock:
            self.dead_replica_skips += 1

    def snapshot(self) -> Dict[str, float]:
        snap = super().snapshot()
        with self._lock:
            snap.update(
                {
                    "scatter_calls": self.scatter_calls,
                    "hedges": self.hedges,
                    "reroutes": self.reroutes,
                    "routed_retries": self.routed_retries,
                    "stale_rescores": self.stale_rescores,
                    "degraded_rows": self.degraded_rows,
                    "dead_replica_skips": self.dead_replica_skips,
                }
            )
        return snap

    def reset(self) -> None:
        super().reset()
        with self._lock:
            self.scatter_calls = 0
            self.hedges = 0
            self.reroutes = 0
            self.routed_retries = 0
            self.stale_rescores = 0
            self.degraded_rows = 0
            self.dead_replica_skips = 0


#: process-wide default registry (servers may carry their own instance)
serve_stats = ServeStats()
