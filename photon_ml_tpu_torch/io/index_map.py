"""Feature index maps: feature name <-> dense column index (port of the
in-memory part of photon_ml_tpu/io/index_map.py).

Reference spec: util/IndexMap.scala:25-49 (two-way map, feature key
"name\\x01term"). The partitioned off-heap store is not yet ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

DELIMITER = "\x01"  # reference feature key separator (Utils.scala getFeatureKey)
INTERCEPT_KEY = "(INTERCEPT)"  # reference constant GLMSuite.INTERCEPT_NAME_TERM


@dataclasses.dataclass
class IndexMap:
    """Two-way feature index. Immutable once built."""

    name_to_index: Dict[str, int]
    index_to_name: List[str]

    def __len__(self) -> int:
        return len(self.index_to_name)

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
