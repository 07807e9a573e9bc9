"""Date parsing/formatting for date fields and date_histogram.

Reference: org/elasticsearch/common/joda/ (Joda FormatDateTimeFormatter) and
index/mapper/core/DateFieldMapper.java. ES's default format is
``strict_date_optional_time||epoch_millis``; values are stored as epoch
millis (long). We parse a practical subset of the Joda patterns ES ships and
store epoch millis: exact int64 host-side, segment-offset-relative f32
device-side (see segment.NumericColumn.offset).
"""
from __future__ import annotations

import datetime as _dt
import re

_ISO_RE = re.compile(
    r"^(\d{4})-(\d{2})-(\d{2})"
    r"(?:[T ](\d{2})(?::(\d{2})(?::(\d{2})(?:\.(\d{1,9}))?)?)?"  # minutes/seconds optional (Joda hour-only ok)
    r"(Z|[+-]\d{2}:?\d{2})?)?$"
)

# Joda pattern -> strptime pattern for the common explicit formats
_JODA_TO_STRPTIME = {
    "yyyy-MM-dd": "%Y-%m-%d",
    "yyyy/MM/dd": "%Y/%m/%d",
    "dd-MM-yyyy": "%d-%m-%Y",
    "dd/MM/yyyy": "%d/%m/%Y",
    "yyyyMMdd": "%Y%m%d",
    "yyyy-MM-dd HH:mm:ss": "%Y-%m-%d %H:%M:%S",
    "yyyy-MM-dd'T'HH:mm:ss": "%Y-%m-%dT%H:%M:%S",
    "HH:mm:ss": "%H:%M:%S",
    "epoch_millis": None,
    "epoch_second": None,
    "date_optional_time": None,
    "strict_date_optional_time": None,
}

EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)


def _to_millis(dt: _dt.datetime) -> int:
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return int(dt.timestamp() * 1000)


def parse_date(value, fmt: str = "strict_date_optional_time||epoch_millis") -> int:
    """Parse `value` to epoch millis, trying each ``||``-separated format."""
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        # numeric JSON input: epoch millis (ES semantics when epoch_millis allowed)
        if "epoch_second" in fmt and "epoch_millis" not in fmt:
            return int(value * 1000)
        return int(value)
    s = str(value).strip()
    for one in fmt.split("||"):
        one = one.strip()
        millis = _try_one(s, one)
        if millis is not None:
            return millis
    raise ValueError(f"failed to parse date [{s}] with format [{fmt}]")


def _try_one(s: str, fmt: str):
    if fmt in ("epoch_millis",):
        try:
            return int(s)
        except ValueError:
            return None
    if fmt in ("epoch_second",):
        try:
            return int(float(s) * 1000)
        except ValueError:
            return None
    if fmt in ("date_optional_time", "strict_date_optional_time", "dateOptionalTime"):
        m = _ISO_RE.match(s)
        if not m:
            return None
        y, mo, d = int(m.group(1)), int(m.group(2)), int(m.group(3))
        hh = int(m.group(4) or 0)
        mm = int(m.group(5) or 0)
        ss = int(m.group(6) or 0)
        frac = m.group(7) or ""
        micros = int((frac + "000000")[:6]) if frac else 0
        tz = m.group(8)
        tzinfo = _dt.timezone.utc
        if tz and tz != "Z":
            tz = tz.replace(":", "")
            sign = 1 if tz[0] == "+" else -1
            tzinfo = _dt.timezone(
                sign * _dt.timedelta(hours=int(tz[1:3]), minutes=int(tz[3:5]))
            )
        try:
            return _to_millis(_dt.datetime(y, mo, d, hh, mm, ss, micros, tzinfo=tzinfo))
        except ValueError:
            return None
    strp = _JODA_TO_STRPTIME.get(fmt)
    if strp:
        try:
            return _to_millis(_dt.datetime.strptime(s, strp))
        except ValueError:
            return None
    return None


def format_date(millis: int, fmt: str = "strict_date_optional_time") -> str:
    dt = EPOCH + _dt.timedelta(milliseconds=int(millis))
    if fmt in ("epoch_millis",):
        return str(int(millis))
    strp = _JODA_TO_STRPTIME.get(fmt)
    if strp:
        return dt.strftime(strp)
    if millis % 1000 == 0:
        return dt.strftime("%Y-%m-%dT%H:%M:%S.000Z")
    return dt.strftime("%Y-%m-%dT%H:%M:%S.") + f"{int(millis % 1000):03d}Z"


# ---- calendar interval math for date_histogram -------------------------------

_MS = {
    "ms": 1,
    "s": 1000,
    "m": 60_000,
    "h": 3_600_000,
    "d": 86_400_000,
    "w": 7 * 86_400_000,
}

_CAL = {"month", "quarter", "year", "1M", "1q", "1y", "M", "q", "y"}


def interval_to_millis(interval: str):
    """Fixed interval → millis; calendar intervals (month/quarter/year) → None."""
    interval = str(interval)
    if interval in _CAL or interval in ("month", "quarter", "year", "week", "day", "hour", "minute", "second"):
        named = {
            "second": 1000, "minute": 60_000, "hour": 3_600_000,
            "day": 86_400_000, "week": 7 * 86_400_000,
        }
        if interval in named:
            return named[interval]
        return None
    m = re.match(r"^(\d+)(ms|s|m|h|d|w)$", interval)
    if not m:
        raise ValueError(f"unknown interval [{interval}]")
    return int(m.group(1)) * _MS[m.group(2)]
