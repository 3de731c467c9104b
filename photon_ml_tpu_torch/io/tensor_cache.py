"""Content-addressed on-disk cache for built ingest tensors (port of
photon_ml_tpu/io/tensor_cache.py: the same keys, the same entry layout).

Re-running Avro decode, entity grouping and padded-tensor assembly over
unchanged inputs is the host's largest cost in the drivers. This module
caches the BUILT arrays, keyed by content:

  key = SHA-256( cache format version
               + source file stats (path, size, mtime_ns)
               + canonical JSON of the ingest config
               [+ shard scope] )

so any change to the inputs or to the ingest configuration is a miss. A
stale entry is simply never addressed again. The keys equal the JAX
package's for the same files and the same config dict, so the two packages
can share a cache directory.

Two entry shapes:

  * array entries (:meth:`TensorCache.put` / :meth:`TensorCache.get`):
    named numpy arrays as individual ``.npy`` files (memory-mapped on
    read) plus a ``meta.json`` manifest;
  * directory entries (:meth:`TensorCache.get_dir` /
    :meth:`TensorCache.build_dir`): a directory a build callback fills
    (the streaming random effect's entity blocks).

Both commit atomically: the entry is assembled in a temp directory beside
it and ``os.replace``d into place. Every filesystem touch goes through the
port's retry policy and carries the fault sites ``io.cache_read``,
``io.cache_write`` and ``io.cache_invalidate``. A read that stays broken
after retries degrades to a miss (the entry is swept and rebuilt); a write
that stays broken raises :class:`RetryError` to the caller, who may go on
uncached (the drivers log it and do).

Arrays of a hit are read-only memory maps. Copy one (``np.array``) before
``torch.from_numpy`` hands it to a device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import threading
from typing import Callable, Dict, Iterable, Optional

import numpy as np

from photon_ml_tpu_torch import resilience
from photon_ml_tpu_torch.resilience import RetryError, RetryPolicy, call_with_retry, faults

__all__ = [
    "CACHE_FORMAT",
    "CacheEntry",
    "CacheStats",
    "TensorCache",
    "cache_stats",
    "content_key",
    "file_stat_token",
    "index_map_digest",
    "process_shard_scope",
]

CACHE_FORMAT = 1
_META = "meta.json"


class CacheStats:
    """Process-wide tensor-cache counters; the drivers log :meth:`summary`.

    ``bytes_reused`` counts the on-disk bytes a hit served instead of a
    rebuild; ``broken`` counts entries that degraded to a miss after
    retries (swept, then rebuilt)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.hits = 0
            self.misses = 0
            self.writes = 0
            self.invalidations = 0
            self.broken = 0
            self.bytes_reused = 0
            self.bytes_written = 0

    def record_hit(self, nbytes: int = 0) -> None:
        with self._lock:
            self.hits += 1
            self.bytes_reused += int(nbytes)

    def record_miss(self) -> None:
        with self._lock:
            self.misses += 1

    def record_broken(self) -> None:
        with self._lock:
            self.broken += 1

    def record_write(self, nbytes: int = 0) -> None:
        with self._lock:
            self.writes += 1
            self.bytes_written += int(nbytes)

    def record_invalidation(self) -> None:
        with self._lock:
            self.invalidations += 1

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "writes": self.writes,
                "invalidations": self.invalidations,
                "broken": self.broken,
                "bytes_reused": self.bytes_reused,
                "bytes_written": self.bytes_written,
            }

    def summary(self) -> str:
        s = self.snapshot()
        total = s["hits"] + s["misses"]
        rate = (100.0 * s["hits"] / total) if total else 0.0
        return (
            f"tensor cache: {s['hits']} hits / {s['misses']} misses "
            f"({rate:.0f}% hit rate), {s['writes']} writes, "
            f"{s['invalidations']} invalidations, {s['broken']} broken "
            f"entries, {s['bytes_reused']}B reused / "
            f"{s['bytes_written']}B written"
        )


#: the process-wide registry every TensorCache reports to unless given ``stats=``
cache_stats = CacheStats()


def _tree_bytes(path: str) -> int:
    """Total file bytes under ``path`` (telemetry only)."""
    total = 0
    for root, _, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total


def file_stat_token(paths: Iterable[str]) -> list:
    """[path, size, mtime_ns] per source file, sorted by path: the identity
    of the inputs, taken before the build reads them."""
    out = []
    for p in sorted(paths):
        st = os.stat(p)
        out.append([os.path.abspath(p), int(st.st_size), int(st.st_mtime_ns)])
    return out


def _canonical(config: Dict) -> str:
    return json.dumps(config, sort_keys=True, separators=(",", ":"), default=str)


def content_key(sources: Iterable[str], config: Dict,
                shard_scope: Optional[str] = None) -> str:
    """SHA-256 content address of (source file stats, ingest config[, shard
    scope]); ``shard_scope=None`` hashes nothing for the scope."""
    h = hashlib.sha256()
    h.update(f"format={CACHE_FORMAT}\n".encode())
    h.update(_canonical(file_stat_token(sources)).encode())
    h.update(b"\n")
    h.update(_canonical(config).encode())
    if shard_scope is not None:
        h.update(b"\nshard_scope=")
        h.update(str(shard_scope).encode())
    return h.hexdigest()


def process_shard_scope(process_index: int, num_processes: int,
                        spec: Optional[str] = None) -> str:
    """Shard-scope token of a per-process entry: its coordinates and an
    optional shard spec, so a topology change addresses new entries."""
    base = f"process={process_index}/{num_processes}"
    return base if spec is None else f"{base};{spec}"


def index_map_digest(index_map) -> str:
    """SHA-256 of an index map's feature names in index order, through the
    shared protocol (``__len__`` + ``get_feature_name``); the in-memory list
    is read directly when the map has one."""
    h = hashlib.sha256()
    names = getattr(index_map, "index_to_name", None)
    if names is None:
        names = (index_map.get_feature_name(i) for i in range(len(index_map)))
    for name in names:
        h.update((name or "").encode())
        h.update(b"\x00")
    return h.hexdigest()


@dataclasses.dataclass
class CacheEntry:
    """A hit: read-only memory-mapped arrays and the meta stored with them."""

    arrays: Dict[str, np.ndarray]
    meta: Dict


class TensorCache:
    """Content-addressed tensor cache rooted at ``root``.

    ``policy=None`` resolves the retry policy at call time from the
    installed resilience config, so ``--io-retries`` governs cache I/O like
    every other filesystem path. ``shard_scope`` is folded into every key
    this instance addresses."""

    def __init__(self, root: str, policy: Optional[RetryPolicy] = None,
                 shard_scope: Optional[str] = None,
                 stats: Optional[CacheStats] = None):
        self.root = root
        self.policy = policy
        self.shard_scope = shard_scope
        self.stats = stats if stats is not None else cache_stats
        os.makedirs(root, exist_ok=True)

    @property
    def _policy(self) -> RetryPolicy:
        if self.policy is not None:
            return self.policy
        return resilience.current_config().io_policy

    # -- addressing ---------------------------------------------------------
    def key_for(self, sources: Iterable[str], config: Dict) -> str:
        return content_key(sources, config, shard_scope=self.shard_scope)

    def entry_dir(self, key: str) -> str:
        return os.path.join(self.root, key[:2], key)

    def has(self, key: str) -> bool:
        return os.path.exists(os.path.join(self.entry_dir(key), _META))

    # -- array entries -------------------------------------------------------
    def get(self, key: str) -> Optional[CacheEntry]:
        """The entry at ``key`` with memory-mapped arrays, or None. A broken
        entry (a read failure that survives retries, a truncated file)
        degrades to a miss and is swept so the rebuild can commit."""
        entry = self.entry_dir(key)
        meta_path = os.path.join(entry, _META)
        if not os.path.exists(meta_path):
            self.stats.record_miss()
            return None
        try:
            def read():
                faults.inject("io.cache_read", key=key, entry=entry)
                with open(meta_path) as f:
                    meta = json.load(f)
                arrays = {name: np.load(os.path.join(entry, f"{name}.npy"), mmap_mode="r")
                          for name in meta.get("arrays", [])}
                return CacheEntry(arrays=arrays, meta=meta.get("meta", {}))

            hit = call_with_retry(read, self._policy, describe=f"tensor-cache read {key[:12]}")
            self.stats.record_hit(sum(a.nbytes for a in hit.arrays.values()))
            return hit
        except (RetryError, OSError, ValueError):
            shutil.rmtree(entry, ignore_errors=True)
            self.stats.record_broken()
            self.stats.record_miss()
            return None

    def put(self, key: str, arrays: Dict[str, np.ndarray], meta: Optional[Dict] = None) -> str:
        """Commit named arrays and ``meta`` under ``key``; returns the entry
        directory. Raises :class:`RetryError` if the write stays broken."""

        def build(tmp: str) -> None:
            manifest = {"format": CACHE_FORMAT, "key": key,
                        "arrays": sorted(arrays), "meta": meta or {}}
            for name, arr in arrays.items():
                if "/" in name or name.startswith("."):
                    raise ValueError(f"bad cache array name {name!r}")
                np.save(os.path.join(tmp, f"{name}.npy"), np.asarray(arr))
            with open(os.path.join(tmp, _META), "w") as f:
                json.dump(manifest, f)

        return self.build_dir(key, build)

    # -- directory entries ---------------------------------------------------
    def get_dir(self, key: str) -> Optional[str]:
        """The committed directory entry for ``key``, or None; a read fault
        that survives retries degrades to a miss."""
        entry = self.entry_dir(key)
        if not os.path.exists(os.path.join(entry, _META)):
            self.stats.record_miss()
            return None
        try:
            def probe():
                faults.inject("io.cache_read", key=key, entry=entry)
                with open(os.path.join(entry, _META)) as f:
                    json.load(f)
                return entry

            out = call_with_retry(probe, self._policy, describe=f"tensor-cache probe {key[:12]}")
            self.stats.record_hit(_tree_bytes(entry))
            return out
        except (RetryError, OSError, ValueError):
            shutil.rmtree(entry, ignore_errors=True)
            self.stats.record_broken()
            self.stats.record_miss()
            return None

    def invalidate(self, key: str) -> bool:
        """Drop the entry at ``key``; True when one was removed. A removal
        that stays broken after retries is a no-op, never an error: content
        addressing means a leftover entry can never serve stale data."""
        entry = self.entry_dir(key)
        if not os.path.exists(os.path.join(entry, _META)):
            return False
        try:
            def drop():
                faults.inject("io.cache_invalidate", key=key, entry=entry)
                shutil.rmtree(entry)

            call_with_retry(drop, self._policy, describe=f"tensor-cache invalidate {key[:12]}")
            self.stats.record_invalidation()
            return True
        except (RetryError, OSError):
            return False

    def build_dir(self, key: str, build: Callable[[str], None]) -> str:
        """Fill a fresh directory through ``build(tmp_dir)`` and commit it
        under ``key``; returns the final directory. A commit that loses a
        race to another process keeps the winner's entry."""
        entry = self.entry_dir(key)
        os.makedirs(os.path.dirname(entry), exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=f".tmp-{key[:12]}-", dir=os.path.dirname(entry))
        try:
            def write():
                faults.inject("io.cache_write", key=key, entry=entry)
                build(tmp)
                if not os.path.exists(os.path.join(tmp, _META)):
                    with open(os.path.join(tmp, _META), "w") as f:
                        json.dump({"format": CACHE_FORMAT, "key": key}, f)

            call_with_retry(write, self._policy, describe=f"tensor-cache write {key[:12]}")
            try:
                os.replace(tmp, entry)
            except OSError:
                if not os.path.exists(os.path.join(entry, _META)):
                    raise
            self.stats.record_write(_tree_bytes(entry))
            return entry
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
