"""Shape canonicalization (port of photon_ml_tpu/compile/, its ladder only):
``ShapeBucketer`` and the masked padding of random-effect datasets."""

from __future__ import annotations

from photon_ml_tpu_torch.compile.canonical import (
    ShapeBucketer,
    canonicalize_re_arrays,
    canonicalize_re_dataset,
    pad_axis,
    resolve_bucketer,
)

__all__ = [
    "ShapeBucketer",
    "canonicalize_re_arrays",
    "canonicalize_re_dataset",
    "pad_axis",
    "resolve_bucketer",
]
