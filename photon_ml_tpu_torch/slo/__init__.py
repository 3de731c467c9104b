"""Service-level machinery (port of photon_ml_tpu/slo/): so far the
bounded-memory streaming p50/p99 estimation (:mod:`quantiles`) the serving
stats registry needs. The declared objectives and the phase ledger are
not yet ported. Dependency-free."""

from photon_ml_tpu_torch.slo.quantiles import (
    P2Quantile,
    StreamingQuantileDigest,
    exact_percentile,
)

__all__ = ["P2Quantile", "StreamingQuantileDigest", "exact_percentile"]
