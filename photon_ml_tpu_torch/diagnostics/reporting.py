"""Physical report tree + HTML / plain-text renderers (port of
photon_ml_tpu/diagnostics/reporting.py).

Reference spec: diagnostics/reporting/ (SURVEY.md §2.10) — the reference
models rendered output as a typed tree (DocumentPhysicalReport →
ChapterPhysicalReport → SectionPhysicalReport → {SimpleText, BulletedList,
NumberedList, Plot} physical reports; reporting/html/*.scala renderers walk
the tree emitting HTML with chapter/section numbering; reporting/text/*.scala
emit plain text).

The tree, the HTML page around it and the text renderer are the JAX
package's, so one tree renders to the same bytes in both packages. Plots
differ: the JAX package draws them with matplotlib, whose SVG carries the
time of drawing and a random id salt; here ``PlotReport.to_svg`` writes the
SVG itself (axes, ticks, one polyline per series), so two runs of one
report write the same bytes and no plotting library is needed.
"""

from __future__ import annotations

import dataclasses
import html as _html
import math
from typing import Dict, List, Sequence, Tuple, Union


# ---------------------------------------------------------------------------
# Physical report tree
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SimpleTextReport:
    """One paragraph (SimpleTextPhysicalReport.scala parity)."""

    text: str


@dataclasses.dataclass
class BulletedListReport:
    items: List[str]


@dataclasses.dataclass
class NumberedListReport:
    items: List[str]


@dataclasses.dataclass
class TableReport:
    """Header + rows of stringifiable cells.

    The reference renders tables as preformatted text blocks inside
    SimpleTextPhysicalReports; a first-class table node renders better HTML.
    """

    header: List[str]
    rows: List[List[object]]
    caption: str = ""


@dataclasses.dataclass
class PlotReport:
    """An XY plot (PlotPhysicalReport.scala parity, written as SVG).

    ``series``: name -> (x, y) arrays. Rendered lazily to SVG so building a
    report tree stays cheap when the text renderer is used.
    """

    title: str
    x_label: str
    y_label: str
    series: Dict[str, Tuple[Sequence[float], Sequence[float]]]
    log_x: bool = False
    log_y: bool = False
    caption: str = ""

    def to_svg(self) -> str:
        return _svg_plot(self)


# ---------------------------------------------------------------------------
# SVG plot writer
# ---------------------------------------------------------------------------

_SVG_W, _SVG_H = 672, 403  # the JAX package's 7.0 x 4.2 in figure at 96 dpi
_PLOT_BOX = (70.0, 20.0, 40.0, 50.0)  # left, right, top, bottom margins
_COLORS = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b")


def _nice_ticks(lo: float, hi: float, count: int = 5) -> List[float]:
    """Round tick values covering [lo, hi] at a 1-2-5 step."""
    raw = (hi - lo) / count
    mag = 10.0 ** math.floor(math.log10(raw))
    step = mag * next(s for s in (1.0, 2.0, 5.0, 10.0) if s * mag >= raw)
    first = math.ceil(lo / step)
    return [k * step for k in range(first, int(math.floor(hi / step)) + 1)]


def _axis(values: List[float], log: bool) -> Tuple[float, float, List[float]]:
    lo, hi = (min(values), max(values)) if values else (0.0, 1.0)
    if hi <= lo:
        lo, hi = lo - 0.5, hi + 0.5
    pad = 0.05 * (hi - lo)
    lo, hi = lo - pad, hi + pad
    ticks = [float(t) for t in range(math.ceil(lo), math.floor(hi) + 1)] if log else []
    return lo, hi, ticks or _nice_ticks(lo, hi)


def _svg_plot(plot: "PlotReport") -> str:
    left, right, top, bottom = _PLOT_BOX
    x0, x1, y0, y1 = left, _SVG_W - right, top, _SVG_H - bottom
    tx = (lambda v: math.log10(v)) if plot.log_x else float
    ty = (lambda v: math.log10(v)) if plot.log_y else float

    def usable(v: float, log: bool) -> bool:
        return math.isfinite(v) and (v > 0.0 or not log)

    series = {
        name: [(tx(x), ty(y)) for x, y in zip(xs, ys)
               if usable(float(x), plot.log_x) and usable(float(y), plot.log_y)]
        for name, (xs, ys) in plot.series.items()
    }
    xlo, xhi, xticks = _axis([p[0] for pts in series.values() for p in pts], plot.log_x)
    ylo, yhi, yticks = _axis([p[1] for pts in series.values() for p in pts], plot.log_y)
    px = lambda v: x0 + (v - xlo) / (xhi - xlo) * (x1 - x0)
    py = lambda v: y1 - (v - ylo) / (yhi - ylo) * (y1 - y0)
    label = lambda v, log: f"{10.0 ** v:g}" if log else f"{v:g}"

    out = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{_SVG_W}" height="{_SVG_H}" '
           f'viewBox="0 0 {_SVG_W} {_SVG_H}" font-family="sans-serif" font-size="11">',
           f'<text x="{(x0 + x1) / 2:.2f}" y="{top - 6:.2f}" text-anchor="middle" '
           f'font-size="13">{_esc(plot.title)}</text>']
    for t in xticks:
        out.append(f'<line x1="{px(t):.2f}" y1="{y0:.2f}" x2="{px(t):.2f}" y2="{y1:.2f}" '
                   f'stroke="#ddd"/><text x="{px(t):.2f}" y="{y1 + 15:.2f}" '
                   f'text-anchor="middle">{label(t, plot.log_x)}</text>')
    for t in yticks:
        out.append(f'<line x1="{x0:.2f}" y1="{py(t):.2f}" x2="{x1:.2f}" y2="{py(t):.2f}" '
                   f'stroke="#ddd"/><text x="{x0 - 6:.2f}" y="{py(t) + 4:.2f}" '
                   f'text-anchor="end">{label(t, plot.log_y)}</text>')
    out.append(f'<rect x="{x0:.2f}" y="{y0:.2f}" width="{x1 - x0:.2f}" height="{y1 - y0:.2f}" '
               'fill="none" stroke="#444"/>')
    out.append(f'<text x="{(x0 + x1) / 2:.2f}" y="{_SVG_H - 12:.2f}" '
               f'text-anchor="middle">{_esc(plot.x_label)}</text>')
    out.append(f'<text transform="translate(16 {(y0 + y1) / 2:.2f}) rotate(-90)" '
               f'text-anchor="middle">{_esc(plot.y_label)}</text>')
    for i, (name, pts) in enumerate(series.items()):
        color = _COLORS[i % len(_COLORS)]
        coords = " ".join(f"{px(x):.2f},{py(y):.2f}" for x, y in pts)
        out.append(f'<polyline points="{coords}" fill="none" stroke="{color}" '
                   'stroke-width="1.5"/>')
        out.extend(f'<circle cx="{px(x):.2f}" cy="{py(y):.2f}" r="3" fill="{color}"/>'
                   for x, y in pts)
        if len(series) > 1:
            ly = y0 + 14 + 14 * i
            out.append(f'<line x1="{x1 - 150:.2f}" y1="{ly - 4:.2f}" x2="{x1 - 130:.2f}" '
                       f'y2="{ly - 4:.2f}" stroke="{color}" stroke-width="1.5"/>'
                       f'<text x="{x1 - 125:.2f}" y="{ly:.2f}">{_esc(name)}</text>')
    out.append("</svg>")
    return "\n".join(out)


LeafReport = Union[SimpleTextReport, BulletedListReport, NumberedListReport, TableReport, PlotReport]


@dataclasses.dataclass
class SectionReport:
    """SectionPhysicalReport.scala parity: titled list of leaves/subsections."""

    title: str
    items: List[Union[LeafReport, "SectionReport"]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ChapterReport:
    title: str
    sections: List[SectionReport] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class DocumentReport:
    title: str
    chapters: List[ChapterReport] = dataclasses.field(default_factory=list)


# ---------------------------------------------------------------------------
# HTML renderer (reporting/html/*.scala parity)
# ---------------------------------------------------------------------------

_CSS = """
body { font-family: -apple-system, 'Segoe UI', Helvetica, Arial, sans-serif;
       margin: 2em auto; max-width: 70em; color: #1a1a1a; }
h1 { border-bottom: 2px solid #444; padding-bottom: .3em; }
h2 { border-bottom: 1px solid #999; padding-bottom: .2em; margin-top: 2em; }
h3 { margin-top: 1.5em; }
table { border-collapse: collapse; margin: 1em 0; }
th, td { border: 1px solid #bbb; padding: .3em .7em; text-align: right; }
th { background: #eee; }
td:first-child, th:first-child { text-align: left; }
caption { caption-side: top; font-weight: bold; text-align: left; }
pre { background: #f6f6f6; padding: .8em; overflow-x: auto; }
nav ul { list-style: none; }
.plot svg { max-width: 100%; height: auto; }
"""


def _esc(s: object) -> str:
    return _html.escape(str(s))


def _fmt_cell(v: object) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def _render_leaf_html(item: LeafReport, out: List[str]) -> None:
    if isinstance(item, SimpleTextReport):
        out.append(f"<p>{_esc(item.text)}</p>")
    elif isinstance(item, BulletedListReport):
        out.append("<ul>" + "".join(f"<li>{_esc(i)}</li>" for i in item.items) + "</ul>")
    elif isinstance(item, NumberedListReport):
        out.append("<ol>" + "".join(f"<li>{_esc(i)}</li>" for i in item.items) + "</ol>")
    elif isinstance(item, TableReport):
        out.append("<table>")
        if item.caption:
            out.append(f"<caption>{_esc(item.caption)}</caption>")
        out.append(
            "<thead><tr>" + "".join(f"<th>{_esc(h)}</th>" for h in item.header) + "</tr></thead>"
        )
        out.append("<tbody>")
        for row in item.rows:
            out.append("<tr>" + "".join(f"<td>{_esc(_fmt_cell(c))}</td>" for c in row) + "</tr>")
        out.append("</tbody></table>")
    elif isinstance(item, PlotReport):
        out.append('<div class="plot">')
        out.append(item.to_svg())
        if item.caption:
            out.append(f"<p><em>{_esc(item.caption)}</em></p>")
        out.append("</div>")
    else:  # pragma: no cover - defensive
        out.append(f"<pre>{_esc(item)}</pre>")


def _render_section_html(
    section: SectionReport, number: str, level: int, out: List[str]
) -> None:
    tag = f"h{min(level, 6)}"
    anchor = "sec-" + number.replace(".", "-")
    out.append(f'<{tag} id="{anchor}">{number} {_esc(section.title)}</{tag}>')
    sub = 0
    for item in section.items:
        if isinstance(item, SectionReport):
            sub += 1
            _render_section_html(item, f"{number}.{sub}", level + 1, out)
        else:
            _render_leaf_html(item, out)


def render_html(doc: DocumentReport) -> str:
    """Render the tree to a standalone HTML page (DocumentToHTMLRenderer
    parity: title, table of contents, numbered chapters/sections)."""
    body: List[str] = [f"<h1>{_esc(doc.title)}</h1>"]

    toc: List[str] = ["<nav><ul>"]
    for ci, chapter in enumerate(doc.chapters, 1):
        toc.append(f'<li><a href="#ch-{ci}">{ci} {_esc(chapter.title)}</a><ul>')
        for si, section in enumerate(chapter.sections, 1):
            toc.append(
                f'<li><a href="#sec-{ci}-{si}">{ci}.{si} {_esc(section.title)}</a></li>'
            )
        toc.append("</ul></li>")
    toc.append("</ul></nav>")
    body.extend(toc)

    for ci, chapter in enumerate(doc.chapters, 1):
        body.append(f'<h2 id="ch-{ci}">{ci} {_esc(chapter.title)}</h2>')
        for si, section in enumerate(chapter.sections, 1):
            _render_section_html(section, f"{ci}.{si}", 3, body)

    return (
        "<!DOCTYPE html><html><head><meta charset='utf-8'>"
        f"<title>{_esc(doc.title)}</title><style>{_CSS}</style></head><body>"
        + "\n".join(body)
        + "</body></html>"
    )


# ---------------------------------------------------------------------------
# Text renderer (reporting/text/*.scala parity)
# ---------------------------------------------------------------------------


def _render_leaf_text(item: LeafReport, indent: str, out: List[str]) -> None:
    if isinstance(item, SimpleTextReport):
        out.append(indent + item.text)
    elif isinstance(item, (BulletedListReport, NumberedListReport)):
        numbered = isinstance(item, NumberedListReport)
        for i, entry in enumerate(item.items, 1):
            bullet = f"{i}." if numbered else "*"
            out.append(f"{indent}{bullet} {entry}")
    elif isinstance(item, TableReport):
        if item.caption:
            out.append(indent + item.caption)
        out.append(indent + " | ".join(item.header))
        for row in item.rows:
            out.append(indent + " | ".join(_fmt_cell(c) for c in row))
    elif isinstance(item, PlotReport):
        out.append(f"{indent}[plot: {item.title} ({item.x_label} vs {item.y_label})]")


def _render_section_text(section: SectionReport, number: str, out: List[str]) -> None:
    out.append(f"{number} {section.title}")
    sub = 0
    for item in section.items:
        if isinstance(item, SectionReport):
            sub += 1
            _render_section_text(item, f"{number}.{sub}", out)
        else:
            _render_leaf_text(item, "  ", out)


def render_text(doc: DocumentReport) -> str:
    out: List[str] = [doc.title, "=" * len(doc.title)]
    for ci, chapter in enumerate(doc.chapters, 1):
        out.append(f"\n{ci} {chapter.title}")
        for si, section in enumerate(chapter.sections, 1):
            _render_section_text(section, f"{ci}.{si}", out)
    return "\n".join(out) + "\n"
