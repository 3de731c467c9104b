"""Request micro-batching onto the canonical shape ladder (port of
photon_ml_tpu/serve/batcher.py).

Per-request dispatch would hand the card a new shape per request or a
batch of one (a device call running at 1/B fill). The micro-batcher sits
between the request threads and the device: concurrent requests coalesce —
bounded by ``max_batch_rows`` and a ``max_wait_ms`` window — into ONE
batch whose row count and nnz width are rounded up the
:class:`~photon_ml_tpu_torch.compile.ShapeBucketer` ladder, so every batch
has one of a small fixed set of shapes that warmup has already seen;
responses are sliced back per request. The first request in an idle window pays at most
``max_wait_ms``; a saturated queue never waits (the batch fills first).

The batcher is model-agnostic: it coalesces :class:`RowBatch` values and
calls a ``score_batch`` function; featurization (name/term -> index,
entity id -> slab row) happened in the server before ``submit``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from photon_ml_tpu_torch.compile import ShapeBucketer, pad_axis
from photon_ml_tpu_torch.serve.stats import ServeStats


@dataclasses.dataclass
class RowBatch:
    """Host-side featurized rows (one request's worth, or a coalesced
    batch). Per-shard COO uses the scoring driver's padding convention:
    pad column 0 with value 0 (a gather-safe exact no-op)."""

    offset: np.ndarray  # (n,) f32
    shard_idx: Dict[str, np.ndarray]  # shard -> (n, k) int32
    shard_val: Dict[str, np.ndarray]  # shard -> (n, k) f32
    ent_row: Dict[str, np.ndarray]  # RE coordinate name -> (n,) int32

    @property
    def num_rows(self) -> int:
        return len(self.offset)

    @staticmethod
    def concat(batches: List["RowBatch"]) -> "RowBatch":
        """Row-concatenate request batches (shared shard/coordinate keys);
        per-shard nnz widths equalize to the widest member (zero padding)."""
        first = batches[0]
        if len(batches) == 1:
            return first
        shard_idx, shard_val = {}, {}
        for s in first.shard_idx:
            k = max(b.shard_idx[s].shape[1] for b in batches)
            shard_idx[s] = np.concatenate(
                [pad_axis(b.shard_idx[s], 1, k, 0) for b in batches]
            )
            shard_val[s] = np.concatenate(
                [pad_axis(b.shard_val[s], 1, k, 0.0) for b in batches]
            )
        return RowBatch(
            offset=np.concatenate([b.offset for b in batches]),
            shard_idx=shard_idx,
            shard_val=shard_val,
            ent_row={
                c: np.concatenate([b.ent_row[c] for b in batches])
                for c in first.ent_row
            },
        )

    def padded(self, bucketer: Optional[ShapeBucketer]) -> "RowBatch":
        """Rows and nnz widths rounded up the ladder. Padded rows carry
        offset 0, entity row -1 (scores 0, sliced off before response);
        padded nnz slots are index 0 / value 0 no-ops."""
        if bucketer is None:
            return self
        n = self.num_rows
        n_pad = bucketer.canon(n)
        return RowBatch(
            offset=pad_axis(self.offset, 0, n_pad, 0.0),
            shard_idx={
                s: pad_axis(
                    pad_axis(a, 1, bucketer.canon(a.shape[1]), 0), 0, n_pad, 0
                )
                for s, a in self.shard_idx.items()
            },
            shard_val={
                s: pad_axis(
                    pad_axis(a, 1, bucketer.canon(a.shape[1]), 0.0), 0, n_pad, 0.0
                )
                for s, a in self.shard_val.items()
            },
            ent_row={
                c: pad_axis(a, 0, n_pad, -1) for c, a in self.ent_row.items()
            },
        )


@dataclasses.dataclass
class _Pending:
    batch: RowBatch
    future: Future
    submitted: float
    # per-request scoring closure (model-swap correctness: a request
    # featurized against model generation G must score against G's slabs —
    # its entity rows index THAT slab layout); None = the batcher default
    score_fn: Optional[Callable[[RowBatch], np.ndarray]]


class MicroBatcher:
    """Background coalescing loop: ``submit`` returns a Future; a single
    worker drains the queue, pads the coalesced batch up the ladder, scores
    once, slices per request."""

    def __init__(
        self,
        score_batch: Callable[[RowBatch], np.ndarray],
        max_batch_rows: int = 128,
        max_wait_ms: float = 2.0,
        bucketer: Optional[ShapeBucketer] = None,
        stats: Optional[ServeStats] = None,
    ):
        if max_batch_rows < 1:
            raise ValueError("max_batch_rows must be >= 1")
        self._score_batch = score_batch
        self.max_batch_rows = max_batch_rows
        self.max_wait_s = max(max_wait_ms, 0.0) / 1e3
        self.bucketer = bucketer
        self.stats = stats if stats is not None else ServeStats()
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._carry: Optional[_Pending] = None  # worker-thread only
        self._closed = False
        self._outstanding = 0
        self._outstanding_lock = threading.Lock()
        self._idle = threading.Event()
        self._idle.set()

    # ------------------------------------------------------------------
    def start(self) -> "MicroBatcher":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._worker, name="photon-serve-batcher", daemon=True
            )
            self._thread.start()
        return self

    def submit(
        self,
        batch: RowBatch,
        score_fn: Optional[Callable[[RowBatch], np.ndarray]] = None,
    ) -> Future:
        """Enqueue one request's rows; the Future resolves to its (n,)
        score slice (or raises the batch's scoring error). ``score_fn``
        pins the request to a specific model generation — requests pinned
        to different generations coalesce into separate device calls."""
        fut: Future = Future()
        fut.add_done_callback(self._on_done)
        # closed-check, bookkeeping, and the put share one lock so a submit
        # can never slip its item in AFTER close()'s shutdown sentinel
        # (which would strand the Future unresolved forever)
        with self._outstanding_lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._outstanding += 1
            self._idle.clear()
            self._queue.put(_Pending(batch, fut, time.monotonic(), score_fn))
        return fut

    def _on_done(self, _fut: Future) -> None:
        with self._outstanding_lock:
            self._outstanding -= 1
            if self._outstanding == 0:
                self._idle.set()

    def outstanding(self) -> int:
        with self._outstanding_lock:
            return self._outstanding

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted request has resolved (the model
        swapper's fence before retiring an old store). True on success."""
        return self._idle.wait(timeout)

    def close(self) -> None:
        """Drain outstanding requests, then stop the worker."""
        with self._outstanding_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)  # sentinel ordered after every submit
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ------------------------------------------------------------------
    def _collect(self, first: _Pending) -> Tuple[List[_Pending], bool]:
        """Coalesce: wait up to the window for more requests, stop early at
        ``max_batch_rows``. A request that would push the batch PAST the
        cap is carried to the next batch instead (an overshot batch would
        pad to a ladder rung warmup never saw — a request-path
        first sight). Returns (members, saw_shutdown)."""
        members = [first]
        rows = first.batch.num_rows
        deadline = time.monotonic() + self.max_wait_s
        while rows < self.max_batch_rows:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                return members, True
            if rows + item.batch.num_rows > self.max_batch_rows:
                self._carry = item
                break
            members.append(item)
            rows += item.batch.num_rows
        return members, False

    def _process(self, members: List[_Pending]) -> None:
        # group by scoring closure, preserving submit order: mid-swap, old-
        # and new-generation requests must not share one gather (their
        # entity rows index different slab layouts); steady state is one
        # group, transiently two
        groups: List[Tuple[Optional[Callable], List[_Pending]]] = []
        for m in members:
            if groups and groups[-1][0] is m.score_fn:
                groups[-1][1].append(m)
            else:
                groups.append((m.score_fn, [m]))
        for score_fn, group in groups:
            self._score_group(score_fn or self._score_batch, group)

    def _score_group(self, score_fn: Callable, members: List[_Pending]) -> None:
        try:
            merged = RowBatch.concat([m.batch for m in members])
            n_real = merged.num_rows
            padded = merged.padded(self.bucketer)
            scores = np.asarray(score_fn(padded))[:n_real]
            self.stats.record_batch(n_real, padded.num_rows, len(members))
        except Exception as e:  # noqa: BLE001 — fan the failure to every caller
            self.stats.record_error()
            for m in members:
                if not m.future.cancelled():
                    m.future.set_exception(e)
            return
        done = time.monotonic()
        lo = 0
        for m in members:
            hi = lo + m.batch.num_rows
            self.stats.record_request(done - m.submitted, m.batch.num_rows)
            if not m.future.cancelled():
                m.future.set_result(scores[lo:hi])
            lo = hi

    def _worker(self) -> None:
        while True:
            if self._carry is not None:
                item, self._carry = self._carry, None
            else:
                item = self._queue.get()
            if item is None:
                return
            members, shutdown = self._collect(item)
            self._process(members)
            if shutdown:
                return
