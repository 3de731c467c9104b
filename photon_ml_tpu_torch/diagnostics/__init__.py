"""Model/training diagnostics and the report pipeline (port of
photon_ml_tpu/diagnostics/).

Reference spec: diagnostics/ (SURVEY.md §2.10) — diagnostics produce typed
logical reports; transformers map them into a physical report tree
(Document/Chapter/Section/Plot/Text); renderers emit HTML or text.
"""

from photon_ml_tpu_torch.diagnostics.reporting import (
    BulletedListReport,
    ChapterReport,
    DocumentReport,
    NumberedListReport,
    PlotReport,
    SectionReport,
    SimpleTextReport,
    TableReport,
    render_html,
    render_text,
)
from photon_ml_tpu_torch.diagnostics.types import DiagnosticMode

__all__ = [
    "BulletedListReport",
    "ChapterReport",
    "DiagnosticMode",
    "DocumentReport",
    "NumberedListReport",
    "PlotReport",
    "SectionReport",
    "SimpleTextReport",
    "TableReport",
    "render_html",
    "render_text",
]
