"""Feature normalization folded into the objective (port of
photon_ml_tpu/ops/normalization.py).

A normalized example is ``x' = (x - shift) * factor`` with the intercept
column exempt. The raw data is never normalized in memory: the objective
works with ``w_eff = w * factor`` and the margin shift ``-w_eff . shift``
(NormalizationContext.scala:41-163).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_tpu_torch.types import NormalizationType

Tensor = torch.Tensor


@dataclasses.dataclass
class NormalizationContext:
    """(factors, shifts); either may be None (= identity)."""

    factors: Optional[Tensor]  # (D,) or None
    shifts: Optional[Tensor]  # (D,) or None
    intercept_id: Optional[int] = None

    def model_to_original_space(self, w: Tensor) -> Tensor:
        """Coefficients trained in normalized space -> raw space
        (NormalizationContext.scala:72-90): ``w * factor``, and the intercept
        absorbs ``-sum(w * factor * shift)``."""
        out = w * self.factors if self.factors is not None else w.clone()
        if self.shifts is not None:
            if self.intercept_id is None:
                raise ValueError("shift normalization requires an intercept column")
            out[self.intercept_id] -= torch.sum(out * self.shifts)
        return out

    def effective_coefficients(self, w: Tensor) -> Tensor:
        return w * self.factors if self.factors is not None else w

    def margin_shift(self, w_eff: Tensor) -> Tensor:
        if self.shifts is None:
            return torch.zeros((), dtype=w_eff.dtype, device=w_eff.device)
        return -torch.sum(w_eff * self.shifts)

    @property
    def is_identity(self) -> bool:
        return self.factors is None and self.shifts is None

    def to(self, device) -> "NormalizationContext":
        move = lambda t: None if t is None else t.to(device)
        return NormalizationContext(move(self.factors), move(self.shifts), self.intercept_id)

    @staticmethod
    def identity() -> "NormalizationContext":
        return NormalizationContext(None, None, None)

    @staticmethod
    def build(
        norm_type: NormalizationType,
        *,
        mean: Optional[Tensor] = None,
        std: Optional[Tensor] = None,
        max_magnitude: Optional[Tensor] = None,
        intercept_id: Optional[int] = None,
    ) -> "NormalizationContext":
        """Factory mirroring NormalizationContext.scala:109-160."""

        def _protect(v):
            # zero-variance / zero-magnitude columns get factor 1
            return torch.where(v == 0.0, torch.ones_like(v), v)

        def _except_intercept(arr, fill):
            if intercept_id is not None and arr is not None:
                arr = arr.clone()
                arr[intercept_id] = fill
            return arr

        if norm_type == NormalizationType.NONE:
            return NormalizationContext(None, None, intercept_id)
        if norm_type == NormalizationType.SCALE_WITH_MAX_MAGNITUDE:
            if max_magnitude is None:
                raise ValueError("SCALE_WITH_MAX_MAGNITUDE requires max_magnitude")
            f = 1.0 / _protect(max_magnitude)
            return NormalizationContext(_except_intercept(f, 1.0), None, intercept_id)
        if norm_type == NormalizationType.SCALE_WITH_STANDARD_DEVIATION:
            if std is None:
                raise ValueError("SCALE_WITH_STANDARD_DEVIATION requires std")
            f = 1.0 / _protect(std)
            return NormalizationContext(_except_intercept(f, 1.0), None, intercept_id)
        if norm_type == NormalizationType.STANDARDIZATION:
            if std is None or mean is None:
                raise ValueError("STANDARDIZATION requires mean and std")
            if intercept_id is None:
                raise ValueError(
                    "STANDARDIZATION requires an intercept column "
                    "(NormalizationContext.scala:150-156 parity)"
                )
            f = 1.0 / _protect(std)
            return NormalizationContext(
                _except_intercept(f, 1.0), _except_intercept(mean, 0.0), intercept_id
            )
        raise ValueError(f"unknown normalization type {norm_type}")
