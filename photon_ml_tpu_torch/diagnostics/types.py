"""Diagnostic mode flags (DiagnosticMode.scala:22 parity; a copy of photon_ml_tpu/diagnostics/types.py)."""

from __future__ import annotations

import enum


class DiagnosticMode(enum.Enum):
    ALL = "ALL"
    TRAIN = "TRAIN"
    VALIDATE = "VALIDATE"
    NONE = "NONE"

    @property
    def runs_train(self) -> bool:
        return self in (DiagnosticMode.ALL, DiagnosticMode.TRAIN)

    @property
    def runs_validate(self) -> bool:
        return self in (DiagnosticMode.ALL, DiagnosticMode.VALIDATE)
