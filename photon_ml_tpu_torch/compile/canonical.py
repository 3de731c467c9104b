"""Shape canonicalization: round dynamic dims up a geometric ladder (port of
photon_ml_tpu/compile/canonical.py).

A :class:`ShapeBucketer` rounds each dynamic dim up the ladder
``base * growth^k``, so N distinct natural shapes collapse onto about
log(N) canonical ones. On the card that is what lets kernels, launch plans
and (later) captured CUDA graphs be shared between random-effect buckets.

Padding is masked with the conventions every consumer already honours:
``weights == 0`` rows are no-ops in every weighted reduction, and
``row_index / entity_pos / feat_idx / local_to_global == -1`` are masked
gathers; padded entity lanes are all-zero problems whose solve stops at
iteration zero. Appended zeros add exactly +0.0 to every sum. The local
feature dim is never padded here (``pad_local_dim`` is off, as in the JAX
package's datasets).

``PHOTON_SHAPE_LADDER`` = ``off`` (default) | ``on`` | ``BASE:GROWTH``,
read by :func:`resolve_bucketer` when it is given ``None``.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import numpy as np
import torch

LADDER_ENV = "PHOTON_SHAPE_LADDER"
DEFAULT_BASE = 8
DEFAULT_GROWTH = 2.0


@dataclasses.dataclass(frozen=True)
class ShapeBucketer:
    """Rounds sizes up to the geometric ladder base * growth^k."""

    base: int = DEFAULT_BASE
    growth: float = DEFAULT_GROWTH

    def __post_init__(self):
        if self.base < 1:
            raise ValueError(f"ladder base must be >= 1, got {self.base}")
        if self.growth <= 1.0:
            raise ValueError(
                f"ladder growth must be > 1 (the ladder must climb), got {self.growth}"
            )

    def canon(self, n: int) -> int:
        """Smallest ladder rung >= n (n <= 0 passes through unchanged)."""
        if n <= 0:
            return n
        size = self.base
        while size < n:
            # ceil keeps the ladder strictly climbing for any growth > 1
            size = max(int(math.ceil(size * self.growth)), size + 1)
        return size

    def describe(self) -> str:
        return f"ladder(base={self.base}, growth={self.growth:g})"

    def spec(self) -> str:
        """The ``BASE:GROWTH`` spelling (the drivers' ``retrain.json``)."""
        return f"{self.base}:{self.growth:g}"


def resolve_bucketer(bucketer=None) -> Optional[ShapeBucketer]:
    """Effective bucketer: an explicit value wins; ``None`` falls back to
    ``PHOTON_SHAPE_LADDER``. Returns None when canonicalization is off.

    Spellings (flag values and the env var share them): ``off``/``false``/
    ``0``/``none``/empty -> None; ``on``/``true``/``1``/``default`` -> the
    defaults; ``BASE:GROWTH`` (e.g. ``16:1.5``) -> that ladder.
    """
    if isinstance(bucketer, ShapeBucketer):
        return bucketer
    if bucketer is None:
        raw = os.environ.get(LADDER_ENV)
        return None if raw is None else resolve_bucketer(raw)
    if isinstance(bucketer, bool):
        return ShapeBucketer() if bucketer else None
    text = str(bucketer).strip().lower()
    if text in ("", "off", "false", "0", "none"):
        return None
    if text in ("on", "true", "1", "default"):
        return ShapeBucketer()
    if ":" in text:
        base_s, growth_s = text.split(":", 1)
        try:
            return ShapeBucketer(base=int(base_s), growth=float(growth_s))
        except ValueError as e:
            raise ValueError(
                f"bad shape-ladder spec {bucketer!r} (want BASE:GROWTH, e.g. 8:2): {e}"
            ) from e
    raise ValueError(f"bad shape-ladder spec {bucketer!r} (want off | on | BASE:GROWTH)")


def pad_axis(a: np.ndarray, axis: int, size: int, fill) -> np.ndarray:
    """``a`` grown to ``size`` along ``axis`` with ``fill`` (unchanged when
    already there). Host numpy: canonicalization happens at build time."""
    a = np.asarray(a)
    have = a.shape[axis]
    if have >= size:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, size - have)
    return np.pad(a, widths, constant_values=fill)


# fill per RandomEffectDataset field: -1 marks masked index slots, 0.0 is
# the no-op value and weight
_RE_FIELD_FILL = {
    "row_index": -1,
    "x": 0.0,
    "labels": 0.0,
    "base_offsets": 0.0,
    "weights": 0.0,
    "entity_pos": -1,
    "feat_idx": -1,
    "feat_val": 0.0,
    "local_to_global": -1,
}


def canonicalize_re_arrays(arrays: dict, bucketer: ShapeBucketer) -> dict:
    """A new dict of host random-effect arrays with the entity lanes E,
    the active samples M (axis 1 of the entity-major stacks), the scoring
    rows N and the nnz width K rounded up the ladder. Padded lanes are
    all-zero problems, padded slots carry weight 0 and row_index -1, padded
    scoring rows entity_pos -1 (consumers slice scores back to the real
    rows)."""
    out = dict(arrays)
    e_pad = bucketer.canon(arrays["x"].shape[0])
    m_pad = bucketer.canon(arrays["x"].shape[1])
    for f in ("row_index", "x", "labels", "base_offsets", "weights"):
        out[f] = pad_axis(out[f], 0, e_pad, _RE_FIELD_FILL[f])
        out[f] = pad_axis(out[f], 1, m_pad, _RE_FIELD_FILL[f])
    out["local_to_global"] = pad_axis(out["local_to_global"], 0, e_pad, -1)
    n_pad = bucketer.canon(arrays["entity_pos"].shape[0])
    k_pad = bucketer.canon(arrays["feat_idx"].shape[1])
    out["entity_pos"] = pad_axis(out["entity_pos"], 0, n_pad, -1)
    for f in ("feat_idx", "feat_val"):
        out[f] = pad_axis(out[f], 0, n_pad, _RE_FIELD_FILL[f])
        out[f] = pad_axis(out[f], 1, k_pad, _RE_FIELD_FILL[f])
    return out


def canonicalize_re_dataset(ds, bucketer: Optional[ShapeBucketer], device=None):
    """A ``RandomEffectDataset`` with every dynamic dim rounded up the
    ladder, its tensors on ``device`` (default: where ``ds`` lies).
    ``num_entities`` grows to the padded lane count: padded lanes scatter
    nothing (``local_to_global`` all -1, no ``entity_pos`` points at them).
    A None bucketer only moves the tensors. Byte-equal to the JAX package's
    canonicalization."""
    from photon_ml_tpu_torch.data.game import RandomEffectDataset

    device = ds.device if device is None else torch.device(device)
    fields = RandomEffectDataset.TENSOR_FIELDS
    if bucketer is None:
        return dataclasses.replace(ds, **{f: getattr(ds, f).to(device) for f in fields})
    if ds.projection_matrix is not None:
        # RANDOM-projected local dims are uniform already (= the projection's
        # k); padding would desync the stored projection matrix
        raise ValueError(
            "shape canonicalization supports INDEX_MAP/IDENTITY datasets "
            "(a RANDOM projection fixes the local dim already)"
        )
    out = canonicalize_re_arrays({f: getattr(ds, f).cpu().numpy() for f in fields}, bucketer)
    return RandomEffectDataset(
        **{f: torch.from_numpy(np.ascontiguousarray(out[f])).to(device) for f in fields},
        num_entities=int(out["x"].shape[0]),
        global_dim=ds.global_dim,
    )


def pad_glm_chunk(host: tuple, bucketer: Optional[ShapeBucketer]) -> tuple:
    """A host ``(x, y, offsets, weights)`` GLM chunk with its row count
    rounded up the ladder with weight-0 rows (exact no-ops in the additive
    value, gradient, Hessian-vector and diagonal passes); a None bucketer
    is the identity. Every chunk of a ladder-sized stream then has one
    shape, so the tail chunk shares the others' launch plans."""
    if bucketer is None:
        return host
    x, y, off, wt = host
    n = x.shape[0]
    n_pad = bucketer.canon(n)
    if n_pad == n:
        return host
    return (
        pad_axis(x, 0, n_pad, 0.0),
        pad_axis(y, 0, n_pad, 0.0),
        pad_axis(off, 0, n_pad, 0.0),
        pad_axis(wt, 0, n_pad, 0.0),
    )
