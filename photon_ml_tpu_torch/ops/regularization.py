"""Regularization contexts: NONE / L1 / L2 / ELASTIC_NET (port of
photon_ml_tpu/ops/regularization.py).

A total weight ``lambda`` plus, for elastic net, ``alpha`` splitting it into
an L1 part ``alpha * lambda`` and an L2 part ``(1 - alpha) * lambda``. The L2
part is added to the smooth objective; the L1 part is handled by OWL-QN's
orthant-wise machinery (DiffFunction.scala:206-282 behavior).
"""

from __future__ import annotations

import dataclasses

from photon_ml_tpu_torch.types import RegularizationType


@dataclasses.dataclass(frozen=True)
class RegularizationContext:
    reg_type: RegularizationType = RegularizationType.NONE
    reg_weight: float = 0.0
    elastic_net_alpha: float = 0.5  # fraction of the weight on L1 for ELASTIC_NET

    @property
    def l1_weight(self) -> float:
        if self.reg_type == RegularizationType.L1:
            return self.reg_weight
        if self.reg_type == RegularizationType.ELASTIC_NET:
            return self.elastic_net_alpha * self.reg_weight
        return 0.0

    @property
    def l2_weight(self) -> float:
        if self.reg_type == RegularizationType.L2:
            return self.reg_weight
        if self.reg_type == RegularizationType.ELASTIC_NET:
            return (1.0 - self.elastic_net_alpha) * self.reg_weight
        return 0.0

    def with_weight(self, reg_weight: float) -> "RegularizationContext":
        return dataclasses.replace(self, reg_weight=reg_weight)

    @staticmethod
    def none() -> "RegularizationContext":
        return RegularizationContext(RegularizationType.NONE, 0.0)

    @staticmethod
    def l2(weight: float) -> "RegularizationContext":
        return RegularizationContext(RegularizationType.L2, weight)

    @staticmethod
    def l1(weight: float) -> "RegularizationContext":
        return RegularizationContext(RegularizationType.L1, weight)

    @staticmethod
    def elastic_net(weight: float, alpha: float) -> "RegularizationContext":
        return RegularizationContext(RegularizationType.ELASTIC_NET, weight, alpha)
