"""Host-side vectorized derivation of timestamp output fields.

The device ships ONE parsed-component bundle per timestamp token (year,
month, day, hour, minute, second, milli, offset_seconds — see
``tpu/timeparse.py``); this module turns that bundle into any of the
TimeStampDissector output fields (TimeStampDissector.java:136-177's 30-output
surface) as whole-column numpy operations — no per-line Python.

All math is int64 numpy.  Epoch math and the civil-date conversions use the
days-from-civil algorithm (proleptic Gregorian); ISO week fields follow the
ISO-8601 Thursday rule, matching ``datetime.date.isocalendar`` which the
host oracle uses.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..dissectors.timelayout import MONTHS_FULL

Components = Dict[str, np.ndarray]   # int64 arrays, keys as in timeparse


def days_from_civil(y: np.ndarray, m: np.ndarray, d: np.ndarray) -> np.ndarray:
    y = y.astype(np.int64) - (m <= 2)
    era = np.floor_divide(np.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = np.mod(m + 9, 12)
    doy = np.floor_divide(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + np.floor_divide(yoe, 4) - np.floor_divide(yoe, 100) + doy
    return era * 146097 + doe - 719468


def civil_from_days(days: np.ndarray):
    """Inverse of days_from_civil: days-since-epoch -> (year, month, day)."""
    z = days.astype(np.int64) + 719468
    era = np.floor_divide(np.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = np.floor_divide(
        doe - np.floor_divide(doe, 1460) + np.floor_divide(doe, 36524)
        - np.floor_divide(doe, 146096),
        365,
    )
    y = yoe + era * 400
    doy = doe - (365 * yoe + np.floor_divide(yoe, 4) - np.floor_divide(yoe, 100))
    mp = np.floor_divide(5 * doy + 2, 153)
    d = doy - np.floor_divide(153 * mp + 2, 5) + 1
    m = mp + np.where(mp < 10, 3, -9)
    return y + (m <= 2), m, d


def epoch_millis(c: Components) -> np.ndarray:
    days = days_from_civil(c["year"], c["month"], c["day"])
    sec = c["hour"] * 3600 + c["minute"] * 60 + c["second"] - c["offset_seconds"]
    return (days * 86400 + sec) * 1000 + c["milli"]


def utc_components(c: Components) -> Components:
    """The same instant re-expressed in UTC (ParsedTimestamp.utc_fields)."""
    ms = epoch_millis(c)
    days = np.floor_divide(ms, 86400000)
    ms_day = ms - days * 86400000
    y, m, d = civil_from_days(days)
    return {
        "year": y, "month": m, "day": d,
        "hour": np.floor_divide(ms_day, 3600000),
        "minute": np.mod(np.floor_divide(ms_day, 60000), 60),
        "second": np.mod(np.floor_divide(ms_day, 1000), 60),
        "milli": np.mod(ms_day, 1000),
        "offset_seconds": np.zeros_like(ms),
    }


def iso_week_fields(c: Components):
    """(weekyear, weekofweekyear) per ISO-8601 (the Thursday rule)."""
    days = days_from_civil(c["year"], c["month"], c["day"])
    isodow = np.mod(days + 3, 7) + 1          # 1970-01-01 was a Thursday (4)
    thursday = days - isodow + 4
    ty, _, _ = civil_from_days(thursday)
    jan1 = days_from_civil(ty, np.full_like(ty, 1), np.full_like(ty, 1))
    week = np.floor_divide(thursday - jan1, 7) + 1
    return ty, week


def locale_week_fields(c: Components, first_day: int, min_days: int):
    """(weekyear, weekofweekyear) per java.time ``WeekFields.of(locale)``
    (the vectorized twin of ``timelayout.week_based_fields``); the LOCAL
    week outputs follow the dissector's locale
    (TimeStampDissector.java:455-459) while the ``_utc`` twins stay ISO."""
    y = c["year"].astype(np.int64)
    days = days_from_civil(y, c["month"], c["day"])
    isodow = np.mod(days + 3, 7) + 1
    dow = np.mod(isodow - first_day, 7) + 1
    ones = np.ones_like(y)
    jan1 = days_from_civil(y, ones, ones)
    doy = days - jan1 + 1

    def sow_offset(d):
        week_start = np.mod(d - dow, 7)
        return np.where(week_start + 1 > min_days, 7 - week_start, -week_start)

    offset = sow_offset(doy)
    week = np.floor_divide(7 + offset + doy - 1, 7)
    # week == 0: end-of-week of the previous week-based year.
    prev_len = jan1 - days_from_civil(y - 1, ones, ones)
    doy2 = doy + prev_len
    week_prev = np.floor_divide(7 + sow_offset(doy2) + doy2 - 1, 7)
    # week > 50: possibly the partial week belonging to the next year.
    year_len = days_from_civil(y + 1, ones, ones) - jan1
    new_year_week = np.floor_divide(7 + offset + year_len + min_days - 1, 7)
    spill = (week > 50) & (week >= new_year_week)
    wy = np.where(week == 0, y - 1, np.where(spill, y + 1, y))
    wk = np.where(
        week == 0, week_prev, np.where(spill, week - new_year_week + 1, week)
    )
    return wy, wk


def _zfill(a: np.ndarray, width: int) -> np.ndarray:
    return np.char.zfill(a.astype(np.int64).astype(f"U{width}"), width)


def derive(
    comp: Components, name: str, memo: dict = None, locale=None
) -> np.ndarray:
    """One TimeStampDissector output column from the component bundle.

    ``name`` is the dissector-relative output name (``epoch``, ``year``,
    ``monthname_utc``, ``date``, ...).  Numeric outputs come back int64;
    string outputs come back as numpy unicode arrays.  Pass one ``memo``
    dict per bundle to share the O(B) intermediates (epoch, UTC bundle,
    week pair) across the outputs of the same timestamp.  ``locale``
    (a ``timelayout.LocaleData``) localizes monthname and the LOCAL week
    fields; ``_utc`` week twins stay ISO like the reference
    (TimeStampDissector.java:519-523) while monthname_utc follows the
    locale (:510-511).
    """
    if memo is None:
        memo = {}

    def shared(key, fn):
        if key not in memo:
            memo[key] = fn(comp)
        return memo[key]

    if name == "epoch":
        return shared("epoch", epoch_millis)
    if name.endswith("_utc"):
        utc = shared("utc", utc_components)
        base = name[: -len("_utc")]
        if base in ("weekyear", "weekofweekyear"):
            locale = None  # UTC week twins are always WeekFields.ISO
        return derive(utc, base, memo.setdefault("utc_memo", {}), locale)
    if name in ("year", "month", "day", "hour", "minute", "second"):
        return comp[name]
    if name == "millisecond":
        return comp["milli"]
    if name == "microsecond":
        return comp["milli"] * 1000
    if name == "nanosecond":
        return comp["milli"] * 1000000
    if name in ("weekyear", "weekofweekyear"):
        if locale is not None and (
            locale.week_first_day != 1 or locale.week_min_days != 4
        ):
            pair = shared(
                f"week:{locale.week_first_day}:{locale.week_min_days}",
                lambda c: locale_week_fields(
                    c, locale.week_first_day, locale.week_min_days
                ),
            )
        else:
            pair = shared("isoweek", iso_week_fields)
        return pair[0] if name == "weekyear" else pair[1]
    if name == "monthname":
        table = np.array(
            MONTHS_FULL if locale is None else list(locale.months_full)
        )
        return table[np.clip(comp["month"], 1, 12) - 1]
    if name == "date":
        return np.char.add(
            np.char.add(_zfill(comp["year"], 4), "-"),
            np.char.add(
                np.char.add(_zfill(comp["month"], 2), "-"),
                _zfill(comp["day"], 2),
            ),
        )
    if name == "time":
        return np.char.add(
            np.char.add(_zfill(comp["hour"], 2), ":"),
            np.char.add(
                np.char.add(_zfill(comp["minute"], 2), ":"),
                _zfill(comp["second"], 2),
            ),
        )
    if name == "timezone":
        # The TIME.ZONE/TIME.TIMEZONE quirk, modeled on device: the
        # reference declares ``TIME.ZONE:timezone`` but dissect emits the
        # value under type TIME.TIMEZONE (TestTimeStampDissector.java:258),
        # so a requested timezone field is None on EVERY valid line.  The
        # zone-name string table (timelayout.zone_display_name) feeds only
        # the never-requestable TIME.TIMEZONE emission.  Validity still
        # rides the shared ts bundle: an unparseable timestamp fails the
        # whole line, exactly like every other timestamp output.
        return np.full(comp["year"].shape, None, dtype=object)
    raise KeyError(name)


# Output names the device+host pipeline can deliver, with whether the
# delivered value is numeric (int64 column) or a string column.  The
# TIME.ZONE ``timezone`` output is the declared-but-never-delivered quirk
# (see derive): the device models it as an always-None obj column gated on
# the bundle's parse validity.
_NUMERIC = {
    "epoch", "year", "month", "day", "hour", "minute", "second",
    "millisecond", "microsecond", "nanosecond", "weekyear", "weekofweekyear",
}
_STRING = {"monthname", "date", "time"}

DEVICE_COMPONENTS = (
    _NUMERIC | _STRING
    | {f"{n}_utc" for n in _NUMERIC if n != "epoch"}
    | {f"{n}_utc" for n in _STRING}
    | {"timezone"}
)


def is_numeric_output(name: str) -> bool:
    base = name[: -len("_utc")] if name.endswith("_utc") else name
    return base in _NUMERIC
