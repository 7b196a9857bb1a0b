"""Time range parsing and object-store prefix generation.

Behavioral parity with the reference (src/utils/time.rs): human time parsing
("10m"/"now" or RFC3339), minute truncation, and minute-granularity prefix
generation used both for object-store listing and manifest partition paths.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from datetime import UTC, datetime, timedelta

_DURATION_UNITS = {
    "ns": 1e-9,
    "us": 1e-6,
    "ms": 1e-3,
    "millisecond": 1e-3,
    "milliseconds": 1e-3,
    "s": 1.0,
    "sec": 1.0,
    "secs": 1.0,
    "second": 1.0,
    "seconds": 1.0,
    "m": 60.0,
    "min": 60.0,
    "mins": 60.0,
    "minute": 60.0,
    "minutes": 60.0,
    "h": 3600.0,
    "hr": 3600.0,
    "hour": 3600.0,
    "hours": 3600.0,
    "d": 86400.0,
    "day": 86400.0,
    "days": 86400.0,
    "w": 604800.0,
    "week": 604800.0,
    "weeks": 604800.0,
}

_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)\s*([a-zA-Z]+)")


class TimeParseError(ValueError):
    pass


def parse_duration(text: str) -> timedelta:
    """Parse a humantime-style duration like "10m", "1h 30m", "2days"."""
    text = text.strip()
    if not text:
        raise TimeParseError("empty duration")
    total = 0.0
    pos = 0
    for m in _DURATION_RE.finditer(text):
        if text[pos : m.start()].strip():
            raise TimeParseError(f"invalid duration: {text!r}")
        unit = m.group(2).lower()
        if unit not in _DURATION_UNITS:
            raise TimeParseError(f"unknown duration unit {unit!r} in {text!r}")
        total += float(m.group(1)) * _DURATION_UNITS[unit]
        pos = m.end()
    if pos != len(text) and text[pos:].strip():
        raise TimeParseError(f"invalid duration: {text!r}")
    if pos == 0:
        raise TimeParseError(f"invalid duration: {text!r}")
    return timedelta(seconds=total)


def parse_rfc3339(text: str) -> datetime:
    t = text.strip()
    if t.endswith(("Z", "z")):
        t = t[:-1] + "+00:00"
    try:
        dt = datetime.fromisoformat(t)
    except ValueError as e:
        raise TimeParseError(str(e)) from None
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=UTC)
    return dt.astimezone(UTC)


_EPOCH = datetime(1970, 1, 1, tzinfo=UTC)
_TICK_US = {"s": 1_000_000, "ms": 1000, "us": 1}


def time_ticks(dt: datetime, unit: str, op: str) -> int | None:
    """`dt` (naive = UTC) in ticks of `unit` ("s", "ms", "us", "ns") for
    the comparison `column op dt` over a column of that unit: rounded up
    for >= and < and down for > and <=, so that comparing ticks is exact;
    None for = and != when dt falls between two ticks (no value equals
    it)."""
    us = ((dt if dt.tzinfo else dt.replace(tzinfo=UTC)) - _EPOCH) // timedelta(microseconds=1)
    if unit == "ns":
        return us * 1000
    ticks, rest = divmod(us, _TICK_US[unit])
    if rest:
        if op in ("=", "!="):
            return None
        if op in (">=", "<"):
            ticks += 1
    return ticks


def truncate_to_minute(dt: datetime) -> datetime:
    return dt.replace(second=0, microsecond=0)


def minute_slot(minute: int, data_granularity: int) -> str:
    """Minute block -> slot string, e.g. minute=15, granularity=10 -> "10-19"."""
    assert 60 % data_granularity == 0
    block_n = minute // data_granularity
    block_start = block_n * data_granularity
    if data_granularity == 1:
        return f"{block_start:02d}"
    block_end = (block_n + 1) * data_granularity - 1
    return f"{block_start:02d}-{block_end:02d}"


@dataclass(frozen=True)
class TimeRange:
    """[start, end) range in UTC."""

    start: datetime
    end: datetime

    @classmethod
    def parse_human_time(cls, start_time: str, end_time: str) -> "TimeRange":
        if end_time == "now":
            end = datetime.now(UTC)
            start = end - parse_duration(start_time)
        else:
            start = parse_rfc3339(start_time)
            end = parse_rfc3339(end_time)
        # No minute truncation (reference parses exact instants;
        # time.rs:191): truncating `now` to the minute start would hide the
        # current minute's rows — the freshest data — from every query.
        if start > end:
            raise TimeParseError("start time is after end time")
        return cls(start, end)

    def contains(self, t: datetime) -> bool:
        return self.start <= t < self.end

    @classmethod
    def granularity_range(cls, ts: datetime, data_granularity: int) -> "TimeRange":
        ts = truncate_to_minute(ts)
        block_start = (ts.minute // data_granularity) * data_granularity
        start = ts.replace(minute=block_start)
        return cls(start, start + timedelta(minutes=data_granularity))

    def generate_prefixes(self, data_granularity: int = 1) -> list[str]:
        """Object-store prefixes covering this range.

        e.g. ("2022-06-11T15:59:00Z", "2022-06-11T17:01:00Z") ->
        ["date=2022-06-11/hour=15/minute=59/", "date=2022-06-11/hour=16/",
         "date=2022-06-11/hour=17/minute=00/"]
        """
        prefixes: list[str] = []
        start_date = self.start.date()
        end_date = self.end.date()
        start_hour, start_minute = self.start.hour, self.start.minute
        end_hour = self.end.hour
        end_minute = self.end.minute + (1 if self.end.second > 0 else 0)

        date = start_date
        while date <= end_date:
            date_prefix = f"date={date.isoformat()}/"
            is_start = date == start_date
            is_end = date == end_date
            sh, sm = (start_hour, start_minute) if is_start else (0, 0)
            eh, em = (end_hour, end_minute) if is_end else (24, 60)
            if sh == 0 and sm == 0 and eh == 24:
                prefixes.append(date_prefix)
            else:
                self._process_hours(data_granularity, date_prefix, sh, sm, eh, em, prefixes)
            date += timedelta(days=1)
        return prefixes

    @staticmethod
    def _process_hours(
        g: int,
        date_prefix: str,
        start_hour: int,
        start_minute: int,
        end_hour: int,
        end_minute: int,
        prefixes: list[str],
    ) -> None:
        for hour in range(start_hour, min(end_hour, 23) + 1):
            hour_prefix = f"{date_prefix}hour={hour:02d}/"
            is_start_hour = hour == start_hour
            is_end_hour = hour == end_hour
            if not is_start_hour and not is_end_hour:
                prefixes.append(hour_prefix)
                continue
            sm = start_minute if is_start_hour else 0
            em = end_minute if is_end_hour else 60
            if sm == em:
                continue
            start_block, end_block = sm // g, em // g
            if end_block - start_block >= 60 // g:
                prefixes.append(hour_prefix)
                continue
            blocks = list(range(start_block, end_block))
            if g > 1:
                blocks.append(end_block)
            for block in blocks:
                minute = block * g
                if minute < 60:
                    prefixes.append(f"{hour_prefix}minute={minute_slot(minute, g)}/")


# --- count-API bin intervals (reference: utils/time.rs:68-169) ---------------

def count_api_bin_interval(start: datetime, end: datetime) -> str:
    """Pick a human bin width for the /counts API based on the span."""
    span = end - start
    if span <= timedelta(hours=1):
        return "1 minute"
    if span <= timedelta(days=1):
        return "1 hour"
    return "1 day"


def interval_for_num_bins(start: datetime, end: datetime, num_bins: int) -> timedelta:
    span = (end - start).total_seconds()
    if num_bins <= 0:
        num_bins = 1
    secs = max(1.0, span / num_bins)
    # round up to a whole minute like the reference's minute-aligned bins
    mins = max(1, int((secs + 59) // 60))
    return timedelta(minutes=mins)


def expected_time_bins(start: datetime, end: datetime, num_bins: int) -> list[tuple[datetime, datetime]]:
    """Minute-aligned [start, end) bins covering the range."""
    start = truncate_to_minute(start)
    end_aligned = truncate_to_minute(end)
    if end_aligned < end:
        end_aligned += timedelta(minutes=1)
    step = interval_for_num_bins(start, end_aligned, num_bins)
    bins = []
    t = start
    while t < end_aligned:
        bins.append((t, min(t + step, end_aligned)))
        t += step
    return bins
