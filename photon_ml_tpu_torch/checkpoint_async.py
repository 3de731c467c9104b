"""Asynchronous checkpoint commits: snapshot now, write in the background
(port of photon_ml_tpu/checkpoint_async.py).

:class:`AsyncCheckpointer` wraps a
:class:`~photon_ml_tpu_torch.checkpoint.CoordinateDescentCheckpointer`,
takes the host snapshot synchronously (``_prepare``: the device→host copy
of every tensor happens there, while the state is live) and runs the SAME
retry + atomic-rename commit (``_commit``) on one background thread.

Contracts:

  * **in-order failure propagation** — a commit that exhausts its retries
    surfaces on the NEXT ``save()`` / :meth:`wait` / :meth:`close`, and
    commits queued AFTER the failing one are dropped (never committed past
    a hole).
  * **wait() fences** — :meth:`wait` blocks until every enqueued commit is
    durable (and re-raises a pending failure) before model save, process
    exit or a supervised relaunch.
  * **no tmp-dir interleaving** — commits are serialized on one worker.

``save()`` blocks once ``MAX_PENDING`` snapshots are in flight, so a slow
disk applies backpressure instead of piling up host copies of the state.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Optional

from photon_ml_tpu_torch.checkpoint import (
    STEP_PREFIX,
    CheckpointState,
    CoordinateDescentCheckpointer,
)

__all__ = ["AsyncCheckpointer"]

logger = logging.getLogger(__name__)

MAX_PENDING = 2  # host snapshots queued behind the commit thread


class AsyncCheckpointer:
    """Background-commit wrapper around a CoordinateDescentCheckpointer.

    Drop-in for every call site that takes a checkpointer (save / restore /
    latest_step); only the durability point moves: ``save()``
    returns once the host snapshot exists, :meth:`wait` is the fence that
    makes everything durable.
    """

    def __init__(self, inner: CoordinateDescentCheckpointer):
        self.inner = inner
        self._queue: "queue.Queue[Optional[tuple]]" = queue.Queue(maxsize=MAX_PENDING)
        self._error: Optional[BaseException] = None
        self._error_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    # -- delegation ----------------------------------------------------
    @property
    def directory(self) -> str:
        return self.inner.directory

    def latest_step(self):
        return self.inner.latest_step()

    def restore(self, *args, **kwargs):
        return self.inner.restore(*args, **kwargs)

    # -- worker --------------------------------------------------------
    def _ensure_worker(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="ckpt-async-commit", daemon=True
            )
            self._thread.start()

    def _run(self) -> None:
        while True:
            job = self._queue.get()
            try:
                if job is None:
                    return
                step, arrays, meta = job
                with self._error_lock:
                    pending = self._error
                if pending is not None:
                    # in-order: a commit after a failed one is DROPPED, not
                    # committed past the hole — the caller sees the first
                    # failure on its next save()/wait()
                    logger.warning(
                        "dropping async checkpoint step %d (pending commit "
                        "failure: %s)", step, pending
                    )
                    continue
                try:
                    self.inner._commit(step, arrays, meta)
                except BaseException as e:  # noqa: BLE001 — crossing the
                    # thread boundary, re-raised in the caller (the
                    # Prefetcher contract); never swallowed
                    with self._error_lock:
                        if self._error is None:
                            self._error = e
            finally:
                self._queue.task_done()

    def _raise_pending(self) -> None:
        with self._error_lock:
            e, self._error = self._error, None
        if e is not None:
            raise e

    # -- the checkpointer protocol --------------------------------------
    def save(self, state: CheckpointState) -> str:
        """Snapshot synchronously, commit in the background. Raises a
        PENDING commit failure first — in order — so a broken checkpoint
        directory is never papered over by later successful-looking saves."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        self._raise_pending()
        # the host snapshot must happen NOW, while the state tensors are live
        # (and, multihost, together on every rank: the sharded-leaf gather)
        arrays, meta = self.inner._prepare(state)
        final_dir = f"{self.inner.directory}/{STEP_PREFIX}{state.step}"
        if not self.inner.writes():
            # only the coordinator commits; the fence is wait()/close()
            return final_dir
        self._ensure_worker()
        self._queue.put((state.step, arrays, meta))
        return final_dir

    def wait(self) -> None:
        """Fence: block until every enqueued commit is durable; re-raise a
        commit failure."""
        self._queue.join()
        self._fence()
        self._raise_pending()

    def _fence(self) -> None:
        """Multihost: no rank passes a fence before the coordinator's
        queued commits are durable."""
        if self.inner.multihost is not None:
            self.inner.multihost.barrier("ckpt-async-fence")

    def close(self) -> None:
        """Drain, stop the worker, surface any pending failure."""
        if self._closed:
            return
        self._queue.join()
        if self._thread is not None and self._thread.is_alive():
            self._queue.put(None)
            self._thread.join()
        self._closed = True
        self._fence()
        self._raise_pending()

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
        return None


def maybe_async(checkpointer: Optional[CoordinateDescentCheckpointer], enabled: bool):
    """Driver convenience: wrap when ``--checkpoint-async`` is on."""
    if checkpointer is None or not enabled:
        return checkpointer
    return AsyncCheckpointer(checkpointer)
