"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. Asking for
``cuda`` on a machine without a usable card raises: the port never carries
on silently on the CPU.

``enable_determinism`` makes every later op of the process deterministic:
two runs of one command on one card give the same bits, which a resumed
checkpoint relies on.
"""

from __future__ import annotations

import os
from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev


def enable_determinism() -> None:
    """Deterministic algorithms for the rest of the process.

    cuBLAS needs a fixed workspace before its first handle is made, so the
    entry points call this before any CUDA work. An op with no deterministic
    algorithm then raises instead of running (no ``warn_only``): the port
    has no silent fallback.
    """
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    # The mode would also fill every torch.empty with NaN, a memset launch
    # before each kernel call; the port's kernels write every element of the
    # outputs they are handed (chip_smoke.py holds them element by element
    # and checks one launch per call), so the fill adds work and no bits.
    torch.utils.deterministic.fill_uninitialized_memory = False
