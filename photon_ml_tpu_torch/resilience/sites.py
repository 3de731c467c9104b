"""Registry of the port's resilience site names (the port's counterpart of
photon_ml_tpu/resilience/sites.py, holding the sites the port wires).

Every site string handed to :func:`faults.inject` / ``corrupt`` / ``flag``
and every preemption poll boundary of :func:`preemption.check` in
``photon_ml_tpu_torch`` is registered here, and every entry is used:
``tests/test_torch_checkpoint.py`` holds both directions. Dependency-free.
"""

from __future__ import annotations

from typing import Dict, Tuple

__all__ = ["FAULT_SITES", "PREEMPT_SITES"]

#: site -> where it fires; keys are the exact literals production code passes
FAULT_SITES: Dict[str, str] = {
    "io.checkpoint_write": "per checkpoint save attempt (checkpoint.py)",
    "optim.step": "coordinate-descent updates, NaN corruption (algorithm/coordinate_descent.py)",
    "preempt.signal": "preemption polls; flags instead of raising (resilience/preemption.py)",
}

#: preemption poll boundaries (the safe drain points) accepted by
#: ``preemption.check`` and the ``PHOTON_PREEMPT_AT`` grammar
PREEMPT_SITES: Tuple[str, ...] = (
    "cycle",  # coordinate-descent update boundary
)
