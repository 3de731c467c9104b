"""Device traces of driver stages (port of photon_ml_tpu/utils/profiling.py,
``torch.profiler`` in place of ``jax.profiler``).

The reference's tracing is wall-clock timers and per-iteration trackers
(utils/timer.py, optim/common.py histories). The device side comes from

    PHOTON_ML_TPU_PROFILE=/path/to/tracedir

under which every CLI driver wraps its train stage in a ``torch.profiler``
trace of the host and, where the stage runs on the card, of the card:
``<tracedir>/<stage>/trace.json`` (a Chrome trace, viewable in Perfetto)
and ``<tracedir>/<stage>/kernels.txt`` (time by kernel and op). Without the
variable the hooks do nothing.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch

PROFILE_ENV = "PHOTON_ML_TPU_PROFILE"


def profile_dir() -> Optional[str]:
    return os.environ.get(PROFILE_ENV) or None


@contextlib.contextmanager
def maybe_trace(stage: str) -> Iterator[None]:
    """Trace ``stage`` into ``$PHOTON_ML_TPU_PROFILE/<stage>/`` when the env
    var is set; otherwise a no-op."""
    base = profile_dir()
    if not base:
        yield
        return
    out = os.path.join(base, stage)
    os.makedirs(out, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
    sort_by = "cuda_time_total" if len(activities) > 1 else "cpu_time_total"
    with open(os.path.join(out, "kernels.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort_by, row_limit=60))
