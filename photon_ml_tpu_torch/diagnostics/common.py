"""Small shared helpers for the diagnostics package (port of
photon_ml_tpu/diagnostics/common.py)."""

from __future__ import annotations

from typing import List, Optional, Sequence


def feature_names_or_indices(
    names: Optional[Sequence[str]], dim: int
) -> List[str]:
    """Feature display names, falling back to stringified indices; a short
    name list is padded with indices rather than erroring."""
    if names is None:
        return [str(i) for i in range(dim)]
    out = [str(n) for n in names[:dim]]
    out.extend(str(i) for i in range(len(out), dim))
    return out
