"""Bounded-memory streaming quantile estimation (the P² algorithm; port of
photon_ml_tpu/slo/quantiles.py, the same arithmetic in the same order).

The serving stats registry (:mod:`photon_ml_tpu_torch.serve.stats`) needs
p50/p99 over request latencies. The exact approach — keep every sample,
sort at snapshot — holds a deque of 100k floats and pays an O(n log n)
sort under the stats lock, and past the deque cap it silently *windows*
(percentiles describe only the newest samples). A day-long run at a few
thousand QPS sees millions of requests; the estimator here keeps the
percentiles over ALL of them in O(1) memory per quantile.

Hybrid contract (what the tests pin):

  * while ``count <= exact_limit`` the digest buffers raw samples and
    :meth:`quantile` is EXACTLY the nearest-rank percentile the old
    sorted-deque path computed — small-sample behavior is bit-identical,
    so every existing percentile assertion keeps holding.
  * past ``exact_limit`` the buffer seeds five P² markers per tracked
    quantile (positions/heights from the exact sample, a far better
    start than the textbook first-five-observations init) and the buffer
    is dropped; from then on each sample is absorbed in O(1) with the
    parabolic marker update of Jain & Chlamtac (1985).

Thread safety is the CALLER's job (ServeStats holds a lock around every
record) — the digest itself is lock-free.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

__all__ = ["P2Quantile", "StreamingQuantileDigest", "exact_percentile"]


def exact_percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted sequence — THE
    reference the estimator must agree with on small samples (the exact
    formula :mod:`photon_ml_tpu_torch.serve.stats` uses)."""
    if not sorted_vals:
        return 0.0
    idx = min(int(q * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
    return sorted_vals[idx]


class P2Quantile:
    """One quantile's five P² markers, seeded from an exact sample.

    Construct via :meth:`from_sorted` (the digest's handoff) — the
    classic first-five-observations bootstrap is deliberately not offered
    because the hybrid digest always has ``exact_limit`` real samples to
    seed from, and seeding from the full exact sample is strictly more
    accurate.
    """

    def __init__(self, q: float, heights: List[float], positions: List[float]):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = float(q)
        self._h = list(heights)  # marker heights (5)
        self._n = list(positions)  # marker positions (5), 1-based
        # desired positions + their per-observation increments
        self._np = [float(p) for p in positions]
        self._dn = [0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0]

    @classmethod
    def from_sorted(cls, q: float, sorted_vals: Sequence[float]) -> "P2Quantile":
        """Seed the five markers at the exact [0, q/2, q, (1+q)/2, 1]
        quantiles of ``sorted_vals`` (which must hold >= 5 samples)."""
        m = len(sorted_vals)
        if m < 5:
            raise ValueError(f"P² seeding needs >= 5 samples, got {m}")
        fracs = (0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0)
        # strictly increasing integer positions: the P² invariants
        # (n[i] < n[i+1]) must hold from the first update
        positions: List[float] = []
        for i, f in enumerate(fracs):
            p = round(1 + f * (m - 1))
            lo = positions[-1] + 1 if positions else 1
            positions.append(float(min(max(p, lo), m - (4 - i))))
        heights = [sorted_vals[int(p) - 1] for p in positions]
        return cls(q, heights, positions)

    @property
    def count(self) -> float:
        return self._n[4]

    def add(self, x: float) -> None:
        h, n, np_, dn = self._h, self._n, self._np, self._dn
        # locate the cell; extremes update the end markers
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while k < 3 and x >= h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            n[i] += 1.0
        for i in range(5):
            np_[i] += dn[i]
        # adjust the three interior markers toward their desired positions
        for i in (1, 2, 3):
            d = np_[i] - n[i]
            if (d >= 1.0 and n[i + 1] - n[i] > 1.0) or (
                d <= -1.0 and n[i - 1] - n[i] < -1.0
            ):
                s = 1.0 if d >= 0 else -1.0
                hp = self._parabolic(i, s)
                if h[i - 1] < hp < h[i + 1]:
                    h[i] = hp
                else:  # parabolic overshoot: linear fallback
                    j = i + int(s)
                    h[i] = h[i] + s * (h[j] - h[i]) / (n[j] - n[i])
                n[i] += s

    def _parabolic(self, i: int, s: float) -> float:
        h, n = self._h, self._n
        return h[i] + s / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + s) * (h[i + 1] - h[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - s) * (h[i] - h[i - 1]) / (n[i] - n[i - 1])
        )

    def value(self) -> float:
        return self._h[2]


class StreamingQuantileDigest:
    """Several tracked quantiles over one stream, exact-then-P².

    ``exact_limit`` bounds memory: up to that many raw samples are
    buffered (and :meth:`quantile` is exact nearest-rank); the next
    sample flips the digest to P² markers seeded from the buffer, after
    which memory is O(1) and every sample still counts.
    """

    def __init__(
        self,
        quantiles: Tuple[float, ...] = (0.50, 0.99),
        exact_limit: int = 100_000,
    ):
        if exact_limit < 5:
            raise ValueError(f"exact_limit must be >= 5, got {exact_limit}")
        self.quantiles = tuple(float(q) for q in quantiles)
        self.exact_limit = int(exact_limit)
        self._buffer: List[float] = []
        self._estimators: Dict[float, P2Quantile] = {}
        self._count = 0
        self._min = 0.0
        self._max = 0.0

    @property
    def count(self) -> int:
        return self._count

    @property
    def exact(self) -> bool:
        """True while quantiles are still computed from raw samples."""
        return self._count <= self.exact_limit

    def add(self, x: float) -> None:
        x = float(x)
        if self._count == 0:
            self._min = self._max = x
        else:
            self._min = min(self._min, x)
            self._max = max(self._max, x)
        self._count += 1
        if self._estimators:
            for est in self._estimators.values():
                est.add(x)
            return
        self._buffer.append(x)
        if len(self._buffer) > self.exact_limit:
            srt = sorted(self._buffer)
            self._estimators = {
                q: P2Quantile.from_sorted(q, srt) for q in self.quantiles
            }
            self._buffer = []

    def quantile(self, q: float) -> float:
        """Exact nearest-rank while buffered; the P² marker estimate
        after. ``q`` must be one of the tracked quantiles once the
        estimator regime starts (any q is fine while exact)."""
        if self._count == 0:
            return 0.0
        if not self._estimators:
            return exact_percentile(sorted(self._buffer), q)
        est = self._estimators.get(float(q))
        if est is None:
            raise KeyError(
                f"quantile {q} was not tracked (streaming regime only "
                f"knows {sorted(self._estimators)})"
            )
        return est.value()

    def reset(self) -> None:
        self._buffer = []
        self._estimators = {}
        self._count = 0
        self._min = 0.0
        self._max = 0.0
