"""Service-level machinery (port of photon_ml_tpu/slo/): declared
per-phase objectives (:mod:`spec`), a phase-attributed ledger with a hard
enforce gate (:mod:`ledger`), and bounded-memory streaming p50/p99
estimation (:mod:`quantiles`) suitable for millions of requests.

Dependency-free: the ledger rides along serving traffic and operator
tooling (``tools/fleetctl.py status --slo`` reads the sidecar), neither of
which may drag in a device runtime. The two packages' sidecars are the
same JSON.
"""

from photon_ml_tpu_torch.slo.ledger import (
    FLEET_COUNTER_KINDS,
    SLO_LEDGER_FILE,
    SLO_LEDGER_FORMAT,
    SLOLedger,
    SLOViolation,
)
from photon_ml_tpu_torch.slo.quantiles import (
    P2Quantile,
    StreamingQuantileDigest,
    exact_percentile,
)
from photon_ml_tpu_torch.slo.spec import DEGRADATION_KINDS, PhaseSLO, SLOSpec

__all__ = [
    "DEGRADATION_KINDS",
    "FLEET_COUNTER_KINDS",
    "P2Quantile",
    "PhaseSLO",
    "SLO_LEDGER_FILE",
    "SLO_LEDGER_FORMAT",
    "SLOLedger",
    "SLOSpec",
    "SLOViolation",
    "StreamingQuantileDigest",
    "exact_percentile",
]
