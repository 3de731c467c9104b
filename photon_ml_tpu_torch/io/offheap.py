"""Off-heap partitioned feature index store (PalDB analogue; port of
photon_ml_tpu/io/offheap.py, same file format).

Reference spec: util/PalDBIndexMap.scala:43-230 + FeatureIndexingJob.scala
:148-174 — feature names are hash-partitioned; each partition is an off-heap
key-value store shared across processes; a feature's global index is its
partition's global offset + its local index, and reverse lookup binary-
searches the offsets (PalDBIndexMap.scala:105-130).

This build keeps those exact semantics over a native memory-mapped store
(native/pmix_store.cpp, C API via ctypes): open is one mmap (the page cache
is the share mechanism — no JVM, no JSON parse), name->index is a hash-table
probe in mapped memory, index->name is an offset slice. Partitioning and
within-partition sort match IndexMap.build exactly, so the off-heap store
and the in-memory map assign identical indices for the same key set.

The native library is built from the checkout's ``native/`` with g++ on
first use (``native_build.build_host``; a failed build raises). The
pure-Python reader and writer of the same format run with
``PHOTON_ML_TPU_NATIVE=0`` or ``force_python=True``: the writers emit the
same bytes, and each reader opens the other's files.
"""

from __future__ import annotations

import ctypes
import json
import logging
import mmap as mmap_mod
import os
import struct
import zlib
from typing import Dict, Iterable, List, Optional

import numpy as np

from photon_ml_tpu_torch import native_build, resilience
from photon_ml_tpu_torch.io.index_map import INTERCEPT_KEY, IndexMap, partition_keys

logger = logging.getLogger(__name__)

META_FILE = "meta.json"
PARTITION_PREFIX = "partition-"
PARTITION_SUFFIX = ".pmix"

_HEADER = struct.Struct("<IIQQQ")  # magic, version, num_keys, capacity, blob size
_MAGIC = 0x58494D50
_VERSION = 1
_SLOT = struct.Struct("<IQ")  # local index + 1, fnv1a hash

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_U64 = 0xFFFFFFFFFFFFFFFF


def _fnv1a(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _U64
    return h


def _next_pow2(v: int) -> int:
    c = 1
    while c < v:
        c <<= 1
    return c


# ---------------------------------------------------------------------------
# native library (built from native/pmix_store.cpp, ctypes)
# ---------------------------------------------------------------------------


def _load_native():
    """The store library, built on first use; None when
    ``PHOTON_ML_TPU_NATIVE=0`` asks for the pure-Python reader and writer.
    A failed build raises."""
    if not native_build.native_enabled():
        return None

    def configure(lib):
        lib.pmix_open.restype = ctypes.c_void_p
        lib.pmix_open.argtypes = [ctypes.c_char_p]
        lib.pmix_close.argtypes = [ctypes.c_void_p]
        lib.pmix_size.restype = ctypes.c_long
        lib.pmix_size.argtypes = [ctypes.c_void_p]
        lib.pmix_get_index.restype = ctypes.c_long
        lib.pmix_get_index.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long]
        lib.pmix_get_name.restype = ctypes.c_long
        lib.pmix_get_name.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_long,
        ]
        lib.pmix_build.restype = ctypes.c_int
        lib.pmix_build.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_long,
        ]

    return native_build.load_host("pmix_store.cpp", configure)


# ---------------------------------------------------------------------------
# single-partition access (native or pure-Python, same file format)
# ---------------------------------------------------------------------------


def _build_partition_file(path: str, keys: List[str], force_python: bool = False) -> None:
    """Write one partition; key i gets local index i.

    The native (g++/ctypes) and pure-Python writers emit IDENTICAL bytes
    (tests/test_torch_offheap.py), so a store opens with either reader.
    """
    encoded = [k.encode("utf-8") for k in keys]
    blob = b"".join(encoded)
    offsets = np.zeros(len(keys) + 1, np.uint64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    lib = None if force_python else _load_native()
    if lib is not None:
        err = lib.pmix_build(
            path.encode(),
            blob,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(keys),
        )
        if err != 0:
            raise IOError(f"pmix_build failed with code {err} for {path}")
        return
    # pure-Python writer (identical bytes)
    n = len(keys)
    cap = _next_pow2(n * 2 if n else 1)
    table = bytearray(cap * _SLOT.size)
    mask = cap - 1
    for i, e in enumerate(encoded):
        h = _fnv1a(e)
        slot = h & mask
        while _SLOT.unpack_from(table, slot * _SLOT.size)[0] != 0:
            slot = (slot + 1) & mask
        _SLOT.pack_into(table, slot * _SLOT.size, i + 1, h)
    with open(path, "wb") as f:
        f.write(_HEADER.pack(_MAGIC, _VERSION, n, cap, len(blob)))
        f.write(bytes(table))
        f.write(offsets.tobytes())
        f.write(blob)


class _NativePartition:
    """ctypes wrapper over one mapped partition."""

    def __init__(self, path: str, lib):
        self._lib = lib
        self._handle = lib.pmix_open(path.encode())
        if not self._handle:
            raise IOError(f"cannot open pmix store {path}")
        self.num_keys = int(lib.pmix_size(self._handle))
        self._buf = ctypes.create_string_buffer(4096)

    def get_index(self, key: bytes) -> int:
        return int(self._lib.pmix_get_index(self._handle, key, len(key)))

    def get_name(self, idx: int) -> Optional[str]:
        n = int(self._lib.pmix_get_name(self._handle, idx, self._buf, len(self._buf)))
        if n < 0:
            return None
        if n > len(self._buf):
            self._buf = ctypes.create_string_buffer(n)
            n = int(self._lib.pmix_get_name(self._handle, idx, self._buf, len(self._buf)))
        return self._buf.raw[:n].decode("utf-8")

    def close(self) -> None:
        if self._handle:
            self._lib.pmix_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except OSError as e:
            # interpreter-shutdown close can fail; never raise from __del__
            logger.warning("pmix partition close failed during GC: %s", e)


class _PythonPartition:
    """mmap + struct reader of the same format (no native lib needed)."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self._mm = mmap_mod.mmap(self._f.fileno(), 0, access=mmap_mod.ACCESS_READ)
        magic, version, self.num_keys, self._cap, blob_size = _HEADER.unpack_from(
            self._mm, 0
        )
        if magic != _MAGIC or version != _VERSION:
            raise IOError(f"bad pmix store {path}")
        self._table_off = _HEADER.size
        self._offsets_off = self._table_off + self._cap * _SLOT.size
        self._blob_off = self._offsets_off + (self.num_keys + 1) * 8
        self._offsets = np.frombuffer(
            self._mm, np.uint64, self.num_keys + 1, self._offsets_off
        )

    def get_index(self, key: bytes) -> int:
        if self.num_keys == 0:
            return -1
        h = _fnv1a(key)
        mask = self._cap - 1
        for probe in range(self._cap):
            slot = (h + probe) & mask
            idx1, slot_hash = _SLOT.unpack_from(
                self._mm, self._table_off + slot * _SLOT.size
            )
            if idx1 == 0:
                return -1
            if slot_hash == h:
                i = idx1 - 1
                s, e = int(self._offsets[i]), int(self._offsets[i + 1])
                if self._mm[self._blob_off + s : self._blob_off + e] == key:
                    return i
        return -1

    def get_name(self, idx: int) -> Optional[str]:
        if not (0 <= idx < self.num_keys):
            return None
        s, e = int(self._offsets[idx]), int(self._offsets[idx + 1])
        return self._mm[self._blob_off + s : self._blob_off + e].decode("utf-8")

    def close(self) -> None:
        self._offsets = None
        self._mm.close()
        self._f.close()


def _open_partition(path: str, force_python: bool = False):
    lib = None if force_python else _load_native()
    if lib is not None:
        return _NativePartition(path, lib)
    return _PythonPartition(path)


# ---------------------------------------------------------------------------
# partitioned store: build + load
# ---------------------------------------------------------------------------


def build_offheap_store(
    output_dir: str,
    feature_keys: Iterable[str],
    add_intercept: bool = True,
    num_partitions: int = 1,
    force_python: bool = False,
) -> None:
    """Hash-partition keys (IndexMap.build parity: crc32 % P, sorted within
    partition), write one pmix file per partition + meta.json."""
    os.makedirs(output_dir, exist_ok=True)
    parts = partition_keys(feature_keys, num_partitions)
    offsets = []
    total = 0
    for i, p in enumerate(parts):
        offsets.append(total)
        total += len(p)
        _build_partition_file(
            os.path.join(output_dir, f"{PARTITION_PREFIX}{i}{PARTITION_SUFFIX}"),
            p,
            force_python=force_python,
        )
    meta = {
        "format": "pmix",
        "version": _VERSION,
        "num_partitions": num_partitions,
        "partition_offsets": offsets,
        "num_features": total + (1 if add_intercept else 0),
        "intercept": add_intercept,
    }
    with open(os.path.join(output_dir, META_FILE), "w") as f:
        json.dump(meta, f)


def is_offheap_store(path: str) -> bool:
    try:
        with open(os.path.join(path, META_FILE)) as f:
            return json.load(f).get("format") == "pmix"
    except (OSError, ValueError):
        return False


class OffHeapIndexMap:
    """Drop-in IndexMap replacement backed by mapped partition files.

    Global index scheme (PalDBIndexMap.scala:105-130 parity): partition p's
    keys occupy [offset_p, offset_p + size_p); the intercept, when present,
    is the final index. Reverse lookup binary-searches the offsets.
    """

    def __init__(self, store_dir: str, force_python: bool = False):
        policy = resilience.current_config().io_policy

        def read_meta() -> dict:
            with open(os.path.join(store_dir, META_FILE)) as f:
                return json.load(f)

        self._meta = resilience.call_with_retry(
            read_meta, policy, describe=f"load {store_dir} meta"
        )
        if self._meta.get("format") != "pmix":
            raise IOError(f"{store_dir} is not a pmix off-heap store")
        self._partitions = [
            resilience.call_with_retry(
                lambda p=os.path.join(
                    store_dir, f"{PARTITION_PREFIX}{i}{PARTITION_SUFFIX}"
                ): _open_partition(p, force_python),
                policy,
                describe=f"open {store_dir} partition {i}",
            )
            for i in range(self._meta["num_partitions"])
        ]
        self._offsets = list(self._meta["partition_offsets"])
        self._num_features = int(self._meta["num_features"])
        self._intercept = bool(self._meta["intercept"])
        self._name_to_index_cache: Optional[Dict[str, int]] = None

    # -- IndexMap protocol --------------------------------------------------
    def __len__(self) -> int:
        return self._num_features

    @property
    def intercept_index(self) -> int:
        return self._num_features - 1 if self._intercept else -1

    def get_index(self, key: str) -> int:
        if key == INTERCEPT_KEY:
            return self.intercept_index
        p = zlib.crc32(key.encode()) % len(self._partitions)
        local = self._partitions[p].get_index(key.encode("utf-8"))
        return self._offsets[p] + local if local >= 0 else -1

    def get_feature_name(self, idx: int) -> Optional[str]:
        if idx < 0 or idx >= self._num_features:
            return None
        if self._intercept and idx == self._num_features - 1:
            return INTERCEPT_KEY
        # binary search over partition offsets (:105-130)
        lo, hi = 0, len(self._offsets) - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self._offsets[mid] <= idx:
                lo = mid
            else:
                hi = mid - 1
        return self._partitions[lo].get_name(idx - self._offsets[lo])

    def __contains__(self, key: str) -> bool:
        return self.get_index(key) >= 0

    @property
    def name_to_index(self) -> Dict[str, int]:
        """Materialized dict view (built on demand — used only by host-side
        config parsing like box constraints, never by the ingest hot path)."""
        if self._name_to_index_cache is None:
            self._name_to_index_cache = {
                self.get_feature_name(i): i for i in range(self._num_features)
            }
        return self._name_to_index_cache

    def close(self) -> None:
        for p in self._partitions:
            p.close()
        self._partitions = []


def load_index_map(path: str):
    """Auto-detect loader: pmix store dir, else JSON IndexMap file/dir."""
    if os.path.isdir(path) and is_offheap_store(path):
        return OffHeapIndexMap(path)
    if os.path.isdir(path):
        return IndexMap.load(os.path.join(path, "feature-index.json"))
    return IndexMap.load(path)


def load_shard_index_map(base_dir: str, shard: str):
    """Per-feature-shard loader used by the GAME drivers: a pmix store at
    ``<base>/<shard>/`` wins over ``<base>/feature-index-<shard>.json``."""
    candidate = os.path.join(base_dir, shard)
    if os.path.isdir(candidate) and is_offheap_store(candidate):
        return OffHeapIndexMap(candidate)
    return IndexMap.load(os.path.join(base_dir, f"feature-index-{shard}.json"))
