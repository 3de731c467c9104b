"""Date ranges and daily-partitioned input path discovery (a copy of
photon_ml_tpu/utils/date_range.py).

Reference spec: util/DateRange.scala (parse ``yyyyMMdd-yyyyMMdd`` ranges and
"days ago" ranges) + util/IOUtils.scala:85-130 (expand an input dir into the
``<dir>/daily/yyyy/MM/dd`` paths inside the range, skipping missing days).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class DateRange:
    start: datetime.date
    end: datetime.date  # inclusive

    def __post_init__(self):
        if self.start > self.end:
            raise ValueError(f"invalid date range: {self.start} > {self.end}")

    @staticmethod
    def from_string(text: str) -> "DateRange":
        """Parse ``yyyyMMdd-yyyyMMdd`` (DateRange.fromDateString parity)."""
        parts = text.split("-")
        if len(parts) != 2:
            raise ValueError(f"invalid date range '{text}', expected yyyyMMdd-yyyyMMdd")
        return DateRange(_parse_day(parts[0]), _parse_day(parts[1]))

    @staticmethod
    def from_days_ago(text: str, today: Optional[datetime.date] = None) -> "DateRange":
        """Parse ``start-end`` in days-ago form, e.g. ``90-1`` = from 90 days
        ago through yesterday (DateRange.fromDaysAgo parity)."""
        parts = text.split("-")
        if len(parts) != 2:
            raise ValueError(f"invalid days-ago range '{text}', expected e.g. 90-1")
        today = today or datetime.date.today()
        start = today - datetime.timedelta(days=int(parts[0]))
        end = today - datetime.timedelta(days=int(parts[1]))
        return DateRange(start, end)

    def days(self) -> List[datetime.date]:
        n = (self.end - self.start).days + 1
        return [self.start + datetime.timedelta(days=i) for i in range(n)]


def _parse_day(s: str) -> datetime.date:
    return datetime.datetime.strptime(s.strip(), "%Y%m%d").date()


def expand_date_range_paths(
    input_dir: str, date_range: DateRange, error_on_missing: bool = False
) -> List[str]:
    """``<dir>/daily/yyyy/MM/dd`` paths within the range that exist on disk
    (IOUtils.getInputPathsWithinDateRange behavior: skip missing days; raise
    if nothing matched)."""
    out: List[str] = []
    for day in date_range.days():
        path = os.path.join(
            input_dir, "daily", f"{day.year:04d}", f"{day.month:02d}", f"{day.day:02d}"
        )
        if os.path.isdir(path):
            out.append(path)
        elif error_on_missing:
            raise FileNotFoundError(path)
    if not out:
        raise FileNotFoundError(
            f"no daily inputs under {input_dir} within {date_range.start}..{date_range.end}"
        )
    return out
