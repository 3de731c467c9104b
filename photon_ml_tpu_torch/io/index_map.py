"""Feature index maps: feature name <-> dense column index (port of
photon_ml_tpu/io/index_map.py).

Reference spec: util/IndexMap.scala:25-49 (two-way map, feature key
"name\\x01term"). Built indices equal the JAX package's (the same
crc32-partitioned, sorted order); the JSON file of ``save``/``load`` is the
JAX package's too. The partitioned off-heap store is io/offheap.py.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Dict, Iterable, List, Optional

from photon_ml_tpu_torch import resilience

DELIMITER = "\x01"  # reference feature key separator (Utils.scala getFeatureKey)
INTERCEPT_KEY = "(INTERCEPT)"  # reference constant GLMSuite.INTERCEPT_NAME_TERM


def feature_key(name: str, term: str = "") -> str:
    return f"{name}{DELIMITER}{term}"


def partition_keys(feature_keys: Iterable[str], num_partitions: int) -> List[List[str]]:
    """Canonical index-assignment order: dedup, drop the intercept key,
    crc32-hash-partition, sort within each partition. Both index layouts
    (IndexMap.build and the off-heap store) take their order from here, so
    they always agree (FeatureIndexingJob hash-partition parity)."""
    keys = set(feature_keys)
    keys.discard(INTERCEPT_KEY)
    parts: List[List[str]] = [[] for _ in range(num_partitions)]
    for k in keys:
        parts[zlib.crc32(k.encode()) % num_partitions].append(k)
    for p in parts:
        p.sort()
    return parts


@dataclasses.dataclass
class IndexMap:
    """Two-way feature index. Immutable once built."""

    name_to_index: Dict[str, int]
    index_to_name: List[str]

    def __len__(self) -> int:
        return len(self.index_to_name)

    def get_index(self, key: str) -> int:
        return self.name_to_index.get(key, -1)

    def __contains__(self, key: str) -> bool:
        return key in self.name_to_index

    def get_feature_name(self, idx: int) -> Optional[str]:
        return self.index_to_name[idx] if 0 <= idx < len(self.index_to_name) else None

    @property
    def intercept_index(self) -> int:
        return self.name_to_index.get(INTERCEPT_KEY, -1)

    @staticmethod
    def for_libsvm(num_features: int, add_intercept: bool) -> "IndexMap":
        """LIBSVM columns are named by their 0-based index; the intercept,
        when added, is the last column."""
        names = [str(i) for i in range(num_features)]
        if add_intercept:
            names.append(INTERCEPT_KEY)
        return IndexMap({k: i for i, k in enumerate(names)}, names)

    @staticmethod
    def build(feature_keys: Iterable[str], add_intercept: bool = True,
              num_partitions: int = 1) -> "IndexMap":
        """Deterministic build: hash-partitioned names, sorted within each
        partition, concatenated; the intercept, when added, last."""
        ordered: List[str] = []
        for p in partition_keys(feature_keys, num_partitions):
            ordered.extend(p)
        if add_intercept:
            ordered.append(INTERCEPT_KEY)
        return IndexMap({k: i for i, k in enumerate(ordered)}, ordered)

    def save(self, path: str) -> None:
        """The names in index order, as one JSON list."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.index_to_name, f)

    @staticmethod
    def load(path: str) -> "IndexMap":
        """Read a ``save``d map, retrying under the active I/O policy."""
        def read() -> list:
            with open(path) as f:
                return json.load(f)

        names = resilience.call_with_retry(
            read, resilience.current_config().io_policy, describe=f"load {path}"
        )
        return IndexMap({k: i for i, k in enumerate(names)}, names)
