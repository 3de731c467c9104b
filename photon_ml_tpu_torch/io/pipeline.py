"""Pipelined data path: bounded block prefetch and double-buffered H2D
(port of photon_ml_tpu/io/pipeline.py).

The streaming coordinates (algorithm/streaming_random_effect.py, and the
chunked GLM passes of optim/streaming.py) read one block or chunk at a time
from disk. Synchronously, the card idles while the host reads the next
block and the host idles while the card solves. This module overlaps them:

  * :class:`Prefetcher` / :func:`prefetched`: a background thread produces
    up to ``depth`` items ahead of the consumer (disk read, page faults,
    slab assembly). Items arrive in source order, and a producer exception
    is re-raised at the position the failing item would have had.
  * :func:`device_pipelined`: the NEXT block's placement is issued while
    the CURRENT block is consumed, and the stage drops its own reference
    to a block once it is handed out.
  * :class:`PinnedH2D` and :func:`pipelined_to_device`: on the card,
    placement is a copy into pinned host memory on the prefetch thread,
    then the H2D copy with ``non_blocking=True`` on a side CUDA stream,
    issued from the consumer's thread. Before the consumer gets a block,
    the current stream waits on that copy's event, and every tensor is
    marked with ``record_stream`` for the current stream, so the caching
    allocator does not reuse its memory while a kernel still reads it.
    A failed pin, copy or event raises; nothing falls back to the
    synchronous loop or to the host.

Pipelining never changes what is computed: blocks arrive in source order
and the consumer's arithmetic is untouched, so results are bitwise equal
with the pipeline on or off. ``PHOTON_PREFETCH_DEPTH`` sets the default
depth (2); ``0`` makes every pipelined loop synchronous.
"""

from __future__ import annotations

import collections
import os
import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

__all__ = [
    "DEFAULT_DEPTH",
    "PinnedH2D",
    "Prefetcher",
    "device_pipelined",
    "pipelined_to_device",
    "prefetched",
    "resolve_depth",
]

DEFAULT_DEPTH = 2
# how long Prefetcher.close waits for its worker to finish the item in hand
CLOSE_JOIN_S = 60.0
_DEPTH_ENV = "PHOTON_PREFETCH_DEPTH"


def resolve_depth(depth: Optional[int]) -> int:
    """Effective prefetch depth: an explicit ``depth`` wins; ``None`` reads
    ``PHOTON_PREFETCH_DEPTH`` (default 2). Depth <= 0 is synchronous."""
    if depth is not None:
        return int(depth)
    raw = os.environ.get(_DEPTH_ENV)
    if raw is None:
        return DEFAULT_DEPTH
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{_DEPTH_ENV} must be an integer, got {raw!r}")


class _EndOfStream:
    pass


_END = _EndOfStream()


class Prefetcher:
    """Bounded background-thread prefetcher over an iterable factory.

    ``source`` is a zero-argument callable returning an iterable (called
    once, in the worker thread) or a plain iterable. At most ``depth``
    produced, unconsumed items are buffered. Items are yielded in
    production order; a source exception is re-raised to the consumer at
    the failing item's position, after everything produced before it.
    ``depth <= 0`` is a synchronous passthrough with no thread.
    """

    def __init__(self, source: "Callable[[], Iterable[Any]] | Iterable[Any]",
                 depth: Optional[int] = None, name: str = "prefetch"):
        self._depth = resolve_depth(depth)
        self._factory = source if callable(source) else (lambda: source)
        self._queue: Optional[queue.Queue] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._name = name
        self._consumed = False

    def _put(self, item) -> bool:
        """Queue ``item`` unless the consumer stopped; False once stopped."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        try:
            for item in self._factory():
                if not self._put(("item", item)):
                    return
        except BaseException as e:  # noqa: BLE001 — not swallowed: re-raised in the consumer at the failing item's position
            self._put(("error", e))
            return
        self._put(("end", _END))

    def __iter__(self) -> Iterator[Any]:
        if self._consumed:
            raise RuntimeError("Prefetcher is single-pass; build a new one")
        self._consumed = True
        return self._iterate()

    def _iterate(self) -> Iterator[Any]:
        if self._depth <= 0:
            yield from self._factory()
            return
        self._queue = queue.Queue(maxsize=self._depth)
        self._thread = threading.Thread(target=self._run, name=self._name, daemon=True)
        self._thread.start()
        try:
            while True:
                kind, payload = self._queue.get()
                if kind == "item":
                    yield payload
                elif kind == "error":
                    raise payload
                else:
                    return
        finally:
            self.close()

    def close(self) -> None:
        """Stop the worker (idempotent) and wait for it: it exits at its
        next queue call, so no worker is left inside a block read or a
        pinned copy when the consumer unwinds (a process that exits with a
        worker still in a CUDA call can abort at teardown)."""
        self._stop.set()
        if self._queue is not None:
            try:  # unblock a worker waiting on a full queue
                self._queue.get_nowait()
            except queue.Empty:
                pass
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=CLOSE_JOIN_S)

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def prefetched(source: "Callable[[], Iterable[Any]] | Iterable[Any]",
               depth: Optional[int] = None, name: str = "prefetch") -> Iterator[Any]:
    """Iterate ``source`` with up to ``depth`` items produced ahead."""
    return iter(Prefetcher(source, depth=depth, name=name))


def device_pipelined(blocks: Iterable[Any], place: Callable[[Any], Any], depth: int = 1,
                     ready: Optional[Callable[[Any], Any]] = None) -> Iterator[Any]:
    """Double-buffered placement over a host-block stream: the next
    ``depth`` blocks' ``place`` calls are issued before the current block
    is yielded (through ``ready`` when given). The stage holds no reference
    to a block it has handed out. ``depth <= 0`` places lazily, one block
    at a time."""
    finish = ready if ready is not None else (lambda b: b)
    it = iter(blocks)
    if depth <= 0:
        for b in it:
            yield finish(place(b))
        return
    pending: "collections.deque[Any]" = collections.deque()
    exhausted = False
    while True:
        while not exhausted and len(pending) < depth + 1:
            try:
                pending.append(place(next(it)))
            except StopIteration:
                exhausted = True
        if not pending:
            return
        yield finish(pending.popleft())


def _map_arrays(fn, block):
    """``fn`` over the numpy arrays and tensors of a dict or tuple block;
    other values pass through."""
    if isinstance(block, dict):
        return {k: _map_arrays(fn, v) for k, v in block.items()}
    if isinstance(block, tuple):
        return tuple(_map_arrays(fn, v) for v in block)
    if isinstance(block, (np.ndarray, torch.Tensor)):
        return fn(block)
    return block


def _tensor(a) -> torch.Tensor:
    """A host tensor over ``a``: a writable numpy array is shared, a
    read-only one (a memory map) is copied first."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(a if a.flags.writeable else np.array(a))


def _pinned(a) -> torch.Tensor:
    """``a`` copied once into pinned host memory (a memory map is read
    straight into it)."""
    if isinstance(a, torch.Tensor):
        return a.pin_memory()
    out = torch.empty(a.shape, dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype,
                      pin_memory=True)
    out.numpy()[...] = a
    return out


class PinnedH2D:
    """Pinned-memory H2D copies on a side CUDA stream.

    ``pin`` runs on the prefetch thread (it sets the device there first);
    ``place`` and ``ready`` run on the consumer's thread, so every stream
    operation stays on it."""

    def __init__(self, device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"PinnedH2D needs a CUDA device, got {device}")
        # an indexed device: the prefetch thread sets it before pinning
        self.device = (device if device.index is not None
                       else torch.device("cuda", torch.cuda.current_device()))
        self.stream = torch.cuda.Stream(device=self.device)

    def pin(self, block):
        torch.cuda.set_device(self.device)
        return _map_arrays(_pinned, block)

    def place(self, pinned):
        with torch.cuda.stream(self.stream):
            out = _map_arrays(lambda t: t.to(self.device, non_blocking=True), pinned)
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def ready(self, handle):
        out, event = handle
        current = torch.cuda.current_stream(self.device)
        current.wait_event(event)

        def mark(t):
            t.record_stream(current)
            return t

        return _map_arrays(mark, out)


def pipelined_to_device(source: Callable[[], Iterable[Any]], to_host: Callable[[Any], Any],
                        device, depth: Optional[int] = None,
                        name: str = "prefetch") -> Iterator[Any]:
    """Blocks of ``source`` through ``to_host`` (numpy arrays in a dict or
    tuple, run on the prefetch thread; read-only memory maps are copied
    where they are placed) and onto ``device``, in source order.

    Depth <= 0 is the synchronous loop: read, copy, consume. Otherwise a
    :class:`Prefetcher` runs ``to_host`` up to ``depth`` blocks ahead and
    :func:`device_pipelined` issues the next block's copy while the current
    one is consumed; on the card the copy is :class:`PinnedH2D`'s."""
    dev = torch.device(device)
    depth = resolve_depth(depth)
    plain = lambda block: _map_arrays(lambda a: _tensor(a).to(dev), block)
    if depth <= 0:
        for item in source():
            yield plain(to_host(item))
        return
    if dev.type == "cuda":
        stage = PinnedH2D(dev)
        host = Prefetcher(lambda: (stage.pin(to_host(x)) for x in source()), depth, name)
        yield from device_pipelined(host, stage.place, depth=1, ready=stage.ready)
        return
    host = Prefetcher(lambda: (to_host(x) for x in source()), depth, name)
    yield from device_pipelined(host, plain, depth=1)
