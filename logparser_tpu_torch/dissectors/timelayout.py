"""Compiled timestamp layouts: a small, serializable parse program for
fixed-layout timestamps (the port's own copy of the reference package's
``dissectors/timelayout.py``, English locale only).

This replaces the reference's java.time ``DateTimeFormatter`` machinery
(TimeStampDissector.java:404-424 builds a formatter from a Java pattern;
StrfTimeToDateTimeFormatter.java maps strftime).  A layout is a flat list of
items, each matching a fixed or narrow-variable slice of the input:

- ``("lit", text)``
- ``("num", field, min_width, max_width, space_padded)``
- ``("text", field, style)`` -- field ``monthname`` / ``dayname`` / ``ampm``
- ``("offset",)`` -- ``+HHMM`` / ``+HH:MM`` (pattern ``ZZ``, strftime ``%z``)
- ``("offset_colon",)`` -- ``+HH:MM``, ``Z`` for zero (pattern ``XXX``)
- ``("zonetext",)`` -- a zone abbreviation or region id (strftime ``%Z``)

Two front-ends compile to this representation:
- :func:`compile_java_pattern` -- the subset of java.time pattern letters the
  reference uses (dd/MMM/yyyy:HH:mm:ss ZZ and friends);
  :data:`APACHE_LAYOUT` is what it gives for ``dd/MMM/yyyy:HH:mm:ss ZZ``.
- ``dissectors/strftime_stamp.compile_strftime`` -- strftime.

The device compiles a layout into its timestamp tables
(``tpu/timeparse.py``); :meth:`TimeLayout.parse` is the host oracle's
per-line parse.  Other locales' name tables (the reference's
``cldr_names.json``) are a later slice: :func:`get_locale` raises for a
tag other than English.
"""
from __future__ import annotations

import datetime as _dt
import re
from typing import List, Optional, Tuple

MONTHS_SHORT = ["Jan", "Feb", "Mar", "Apr", "May", "Jun",
                "Jul", "Aug", "Sep", "Oct", "Nov", "Dec"]
MONTHS_FULL = ["January", "February", "March", "April", "May", "June",
               "July", "August", "September", "October", "November", "December"]
DAYS_SHORT = ["Mon", "Tue", "Wed", "Thu", "Fri", "Sat", "Sun"]
DAYS_FULL = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
             "Saturday", "Sunday"]


class LocaleData:
    """Month/weekday name tables + week rule for one locale.

    The reference's ``TimeStampDissector.setLocale`` threads a
    ``java.util.Locale`` into its DateTimeFormatter
    (TimeStampDissector.java:73-78, :106) and into
    ``WeekFields.of(locale)`` for the LOCAL week outputs (:455-459; the
    ``_utc`` twins stay WeekFields.ISO, :519-523).  These tables mirror
    the CLDR data Java's formatter resolves (JDK 9+ default): note the
    trailing periods in e.g. French/Dutch abbreviated month names.
    ``week_first_day`` is ISO numbering (1=Monday .. 7=Sunday)."""

    __slots__ = ("tag", "months_short", "months_full", "days_short",
                 "days_full", "ampm", "week_first_day", "week_min_days")

    def __init__(self, tag, months_short, months_full, days_short, days_full,
                 ampm=("AM", "PM"), week_first_day=1, week_min_days=4):
        self.tag = tag
        self.months_short = months_short
        self.months_full = months_full
        self.days_short = days_short
        self.days_full = days_full
        self.ampm = ampm
        self.week_first_day = week_first_day
        self.week_min_days = week_min_days


EN = LocaleData("en", MONTHS_SHORT, MONTHS_FULL, DAYS_SHORT, DAYS_FULL)
_EN = EN


def week_based_fields(
    year: int, month: int, day: int, first_day: int = 1, min_days: int = 4
) -> Tuple[int, int]:
    """(week_based_year, week_of_week_based_year) per java.time
    ``WeekFields.of(locale)`` (ComputedDayOfField.localizedWeekOfWeekBasedYear
    semantics).  ``first_day``/``min_days`` default to ISO (Monday, 4) —
    then this agrees with ``datetime.date.isocalendar`` exactly."""
    date = _dt.date(year, month, day)
    dow = (date.isoweekday() - first_day) % 7 + 1
    doy = date.timetuple().tm_yday

    def sow_offset(d, w):
        week_start = (d - w) % 7
        return 7 - week_start if week_start + 1 > min_days else -week_start

    offset = sow_offset(doy, dow)
    week = (7 + offset + doy - 1) // 7
    if week == 0:
        # End-of-week of the previous week-based year.
        prev_len = (_dt.date(year, 1, 1) - _dt.date(year - 1, 1, 1)).days
        doy2 = doy + prev_len
        week = (7 + sow_offset(doy2, dow) + doy2 - 1) // 7
        return year - 1, week
    if week > 50:
        year_len = (_dt.date(year + 1, 1, 1) - _dt.date(year, 1, 1)).days
        new_year_week = (7 + offset + year_len + min_days - 1) // 7
        if week >= new_year_week:
            return year + 1, week - new_year_week + 1
    return year, week


def get_locale(tag: Optional[str]) -> LocaleData:
    """Resolve a locale tag to its table: English only ("en", "en_GB",
    "en-US", ...); any other tag raises ValueError (the other locales'
    tables are ROADMAP queue A item 5)."""
    if not tag:
        return _EN
    norm = tag.strip().lower().replace("-", "_")
    if norm.split("_")[0] == "en":
        return _EN
    raise ValueError(f"locale {tag!r}: only English is ported "
                     "(other locales: ROADMAP queue A item 5)")


# Curated zone-abbreviation table for %Z-style zone text (Java resolves these
# through its locale zone-name tables; we map to tzdata zones/fixed offsets).
_ZONE_ABBREVIATIONS = {
    "UTC": "UTC", "GMT": "UTC", "Z": "UTC", "UT": "UTC",
    "CET": "CET", "CEST": "CET", "MET": "MET", "MEST": "MET",
    "WET": "WET", "WEST": "WET", "EET": "EET", "EEST": "EET",
    "EST": "EST5EDT", "EDT": "EST5EDT",
    "CST": "CST6CDT", "CDT": "CST6CDT",
    "MST": "MST7MDT", "MDT": "MST7MDT",
    "PST": "PST8PDT", "PDT": "PST8PDT",
}

_ZONE_FULL_NAMES = {
    "UTC": "Coordinated Universal Time",
    "CET": "Central European Time",
    "MET": "Middle Europe Time",
    "WET": "Western European Time",
    "EET": "Eastern European Time",
    "EST5EDT": "Eastern Time",
    "CST6CDT": "Central Time",
    "MST7MDT": "Mountain Time",
    "PST8PDT": "Pacific Time",
}


class TimestampParseError(ValueError):
    """Raised when an input does not match the compiled layout."""


# A layout item is a tuple whose first element is the kind:
#   ("lit", text)
#   ("num", field, min_width, max_width, space_padded: bool)
#   ("text", field, style)          field: monthname|dayname|ampm
#   ("offset",)                     +HHMM / -HHMM  (+0000 for zero)
#   ("offset_colon",)               +HH:MM, 'Z' accepted for zero (pattern XXX)
#   ("zonetext",)                   zone abbreviation or region id
Item = Tuple


class ParsedTimestamp:
    """Resolved timestamp: local wall-clock fields + zone + epoch."""

    __slots__ = (
        "year", "month", "day", "hour", "minute", "second", "nano",
        "offset_seconds", "zone_name", "epoch_millis", "_dt_local",
    )

    def __init__(self, year, month, day, hour, minute, second, nano,
                 offset_seconds, zone_name, epoch_millis):
        self.year = year
        self.month = month
        self.day = day
        self.hour = hour
        self.minute = minute
        self.second = second
        self.nano = nano
        self.offset_seconds = offset_seconds
        self.zone_name = zone_name  # tzdata id when parsed from zone text
        self.epoch_millis = epoch_millis
        self._dt_local = _dt.date(year, month, day)

    # -- derived fields used by TimeStampDissector ----------------------

    def iso_week(self) -> int:
        return self._dt_local.isocalendar()[1]

    def iso_weekyear(self) -> int:
        return self._dt_local.isocalendar()[0]

    def monthname(self) -> str:
        return MONTHS_FULL[self.month - 1]

    def date_str(self) -> str:
        return f"{self.year:04d}-{self.month:02d}-{self.day:02d}"

    def time_str(self) -> str:
        return f"{self.hour:02d}:{self.minute:02d}:{self.second:02d}"

    def zone_display_name(self) -> str:
        """Java ZonedDateTime.getZone().getDisplayName(FULL, locale)."""
        if self.zone_name is not None:
            return _ZONE_FULL_NAMES.get(self.zone_name, self.zone_name)
        total = self.offset_seconds
        if total == 0:
            return "Z"
        sign = "+" if total >= 0 else "-"
        total = abs(total)
        h, rem = divmod(total, 3600)
        m, s = divmod(rem, 60)
        if s:
            return f"{sign}{h:02d}:{m:02d}:{s:02d}"
        return f"{sign}{h:02d}:{m:02d}"

    def as_utc(self) -> "_dt.datetime":
        return _dt.datetime.fromtimestamp(
            self.epoch_millis / 1000.0, tz=_dt.timezone.utc
        ).replace(microsecond=0) + _dt.timedelta(
            microseconds=(self.epoch_millis % 1000) * 1000
        )

    def utc_fields(self) -> "ParsedTimestamp":
        """The same instant re-expressed in UTC."""
        epoch_s, milli = divmod(self.epoch_millis, 1000)
        u = _dt.datetime.fromtimestamp(epoch_s, tz=_dt.timezone.utc)
        sub_nano = self.nano % 1_000_000  # keep micro/nano precision
        return ParsedTimestamp(
            u.year, u.month, u.day, u.hour, u.minute, u.second,
            milli * 1_000_000 + sub_nano,
            0, None, self.epoch_millis,
        )


_ZONE_RESOLVE_CACHE: dict = {}


def _resolve_zone_cached(name: str) -> Optional[str]:
    """%Z zone text -> tzdata id (None = unknown): abbreviation table +
    ZoneInfo validation, memoized — the validation was per-line cost on
    zone-text layouts and the distinct-name population is tiny."""
    got = _ZONE_RESOLVE_CACHE.get(name)
    if got is not None or name in _ZONE_RESOLVE_CACHE:
        return got
    zone: Optional[str] = _ZONE_ABBREVIATIONS.get(name.upper(), name)
    try:
        from zoneinfo import ZoneInfo

        ZoneInfo(zone)
    except Exception:
        zone = None
    if len(_ZONE_RESOLVE_CACHE) > 4096:  # hostile-corpus bound
        _ZONE_RESOLVE_CACHE.clear()
    _ZONE_RESOLVE_CACHE[name] = zone
    return zone


class TimeLayout:
    """A compiled, serializable timestamp layout."""

    def __init__(self, items: List[Item], default_zone: Optional[str] = None,
                 locale: Optional[LocaleData] = None):
        self.items = items
        # tzdata id applied when the layout itself carries no zone
        # (StrfTimeToDateTimeFormatter.java:97-105 defaults likewise).
        self.default_zone = default_zone
        # Month/day name tables (TimeStampDissector.setLocale semantics).
        self.locale = locale or _EN
        self._fast = None          # lazily compiled regex fast path
        self._fast_tried = False
        self._fixed = None         # lazily compiled fixed-width direct lane
        self._fixed_tried = False

    def with_locale(self, locale: LocaleData) -> "TimeLayout":
        """The same layout re-bound to another locale's name tables."""
        return TimeLayout(self.items, self.default_zone, locale)

    def __getstate__(self):
        state = self.__dict__.copy()
        # Compiled lanes hold closures/patterns; rebuild lazily on load.
        state["_fast"] = None
        state["_fast_tried"] = False
        state["_fixed"] = None
        state["_fixed_tried"] = False
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.__dict__.setdefault("_fixed", None)
        self.__dict__.setdefault("_fixed_tried", False)

    def has_zone(self) -> bool:
        return any(it[0] in ("offset", "offset_colon", "zonetext") for it in self.items)

    # -- parsing ---------------------------------------------------------

    def _compile_fast(self):
        """One anchored regex for fixed-width layouts (the hot shapes).
        Returns (pattern, extractors) or None when any item is variable
        width — regex backtracking could then accept inputs the greedy
        item-by-item parser rejects, so those layouts keep the slow path.
        """
        parts: List[str] = []
        extractors: List = []  # (kind, field_or_table)
        last_index = len(self.items) - 1
        for i, it in enumerate(self.items):
            kind = it[0]
            if kind == "lit":
                parts.append(re.escape(it[1]))
            elif kind == "num":
                _, field, minw, maxw, space_pad = it
                if space_pad or minw != maxw:
                    return None
                parts.append(f"(\\d{{{minw}}})")
                extractors.append(("num", field))
            elif kind == "text":
                _, field, style = it
                if field == "monthname":
                    table = (self.locale.months_full if style == "full"
                             else self.locale.months_short)
                    key = "month"
                elif field == "dayname":
                    table = (self.locale.days_full if style == "full"
                             else self.locale.days_short)
                    key = "dayofweek"
                else:
                    table = list(self.locale.ampm)
                    key = "ampm"
                alts = sorted(table, key=len, reverse=True)
                parts.append("(" + "|".join(re.escape(a) for a in alts) + ")")
                extractors.append(("text", (key, [a.lower() for a in table])))
            elif kind == "offset":
                parts.append(r"([+-]\d{2}:?\d{2})")
                extractors.append(("offset", None))
            elif kind == "offset_colon":
                parts.append(r"(Z|[+-]\d{2}:\d{2})")
                extractors.append(("offset", None))
            elif kind == "zonetext" and i == last_index:
                # Positional check, NOT identity: ("zonetext",) literals
                # are constant-folded to one shared tuple, so a layout
                # with two %Z items would pass an `is` test mid-layout.
                # Zone text as the FINAL item only: the group is greedy
                # over the same charset the slow parser uses and nothing
                # follows it, so regex backtracking cannot accept an
                # input the item-by-item parser rejects.  Zone names
                # resolve through a cache (abbreviation table + ZoneInfo
                # validation were ~a third of the per-line cost).
                parts.append(r"([A-Za-z_/+\-0-9]+)")
                extractors.append(("zonetext", None))
            else:  # mid-layout zone text stays on the slow path
                return None
        return re.compile("".join(parts) + r"\Z", re.IGNORECASE), extractors

    def _compile_fixed(self):
        """Direct-slicing lane for fully fixed-width offset-bearing layouts
        (the Apache ``dd/MMM/yyyy:HH:mm:ss ZZ`` shape): no regex, no field
        dict, no datetime objects in the epoch math.  Returns a closure
        ``s -> ParsedTimestamp | None`` (None = fall through to the exact
        slower lanes, which also own every error message), or None when the
        layout has any variable-width / zone-text / week / 12h construct.

        Bit-exactness notes: the epoch replicates ``datetime.timestamp()``'s
        float rounding exactly (``int((total_us / 10**6) * 1000)`` — the
        same single division + multiply), the leap-second clamp matches
        _resolve, and any out-of-range component bails to the slow lane so
        range errors surface with identical messages.
        """
        steps = []  # (start, end, kind, payload); fixed offsets into s
        pos = 0
        have = set()
        for it in self.items:
            kind = it[0]
            if kind == "lit":
                steps.append((pos, pos + len(it[1]), "lit", it[1].lower()))
                pos += len(it[1])
            elif kind == "num":
                _, field, minw, maxw, space_pad = it
                if space_pad or minw != maxw:
                    return None
                if field not in ("day", "month", "year", "hour", "minute",
                                 "second", "milli"):
                    return None
                steps.append((pos, pos + minw, "num", field))
                have.add(field)
                pos += minw
            elif kind == "text":
                _, field, style = it
                if field != "monthname":
                    return None
                table = (self.locale.months_full if style == "full"
                         else self.locale.months_short)
                widths = {len(t) for t in table}
                if len(widths) != 1:
                    return None
                w = widths.pop()
                lookup = {t.lower(): i + 1 for i, t in enumerate(table)}
                if len(lookup) != len(table):
                    return None
                steps.append((pos, pos + w, "month_text", lookup))
                have.add("month")
                pos += w
            elif kind == "offset":
                steps.append((pos, pos + 5, "offset", None))
                have.add("offset")
                pos += 5
            else:
                return None
        if not {"year", "month", "day", "offset"} <= have:
            return None
        total = pos

        # The steps are layout-static, so the lane is source-generated:
        # straight-line slicing + the exact epoch math, no per-item
        # dispatch loop (the loop + if-chain was ~a fifth of the compiled
        # oracle's per-line cost).  Operations are IDENTICAL to the old
        # interpreted loop — same rounding, same clamps, same bails.
        field_var = {"day": "d", "month": "mo", "year": "y", "hour": "h",
                     "minute": "mi", "second": "sec", "milli": "milli"}
        ns: dict = {"_PT": ParsedTimestamp}
        src = [
            "def run(s):",
            f"    if len(s) != {total}:",
            "        return None",
            "    y = mo = d = h = mi = sec = milli = off = 0",
            "    try:",
        ]

        def emit(line):
            src.append("        " + line)

        for j, (a, b, kind, payload) in enumerate(steps):
            if kind == "lit":
                emit(f"if s[{a}:{b}].lower() != {payload!r}:")
                emit("    return None")
            elif kind == "num":
                emit(f"part = s[{a}:{b}]")
                emit("if not part.isdigit():")
                emit("    return None")
                emit(f"{field_var[payload]} = int(part)")
            elif kind == "month_text":
                ns[f"_lk{j}"] = payload
                emit(f"mo = _lk{j}.get(s[{a}:{b}].lower(), 0)")
                emit("if mo == 0:")
                emit("    return None")
            else:  # offset
                emit(f"sign = s[{a}]")
                emit(f"body = s[{a + 1}:{b}]")
                # Strict ASCII digits: the slower lanes' offset regex is
                # [0-9] (unlike the unicode-accepting isdigit() the
                # numeric fields share with them).
                emit('if (sign not in "+-" or not body.isascii()'
                     " or not body.isdigit()):")
                emit("    return None")
                emit("off = int(body[:2]) * 3600 + int(body[2:]) * 60")
                # datetime.timezone (the slow lane) rejects offsets of
                # 24h or more — bail so it does.
                emit("if off >= 86400:")
                emit("    return None")
                emit('if sign == "-":')
                emit("    off = -off")
        src += [
            "        if sec == 60:",
            "            sec = 59  # leap second: java.time SMART clamps",
            "        if not (1 <= mo <= 12 and 1 <= d <= 31 and h <= 23",
            "                and mi <= 59 and sec <= 59):",
            "            return None",
            "        # days-from-civil (proleptic Gregorian), then the exact",
            "        # float rounding datetime.timestamp() applies.",
            "        yy = y - (mo <= 2)",
            "        era = (yy if yy >= 0 else yy - 399) // 400",
            "        yoe = yy - era * 400",
            "        doy = (153 * (mo + (-3 if mo > 2 else 9)) + 2) // 5 + d - 1",
            "        doe = yoe * 365 + yoe // 4 - yoe // 100 + doy",
            "        days = era * 146097 + doe - 719468",
            "        base_s = days * 86400 + h * 3600 + mi * 60 + sec - off",
            "        micro = milli * 1000",
            "        total_us = base_s * 10**6 + micro",
            "        epoch_millis = int((total_us / 10**6) * 1000)",
            "        return _PT(",
            "            y, mo, d, h, mi, sec, milli * 1_000_000, off, None,",
            "            epoch_millis,",
            "        )",
            "    except (ValueError, IndexError):",
            "        return None",
        ]
        exec(  # noqa: S102 — our own generated source
            compile("\n".join(src) + "\n", "<timelayout-fixed>", "exec"), ns
        )
        return ns["run"]

    def parse(self, s: str) -> ParsedTimestamp:
        if not self._fixed_tried:
            self._fixed_tried = True
            self._fixed = self._compile_fixed()
        if self._fixed is not None:
            ts = self._fixed(s)
            if ts is not None:
                return ts
        if not self._fast_tried:
            self._fast_tried = True
            self._fast = self._compile_fast()
        if self._fast is not None:
            m = self._fast[0].match(s)
            if m is not None:
                fields: dict = {}
                for (kind, spec), group in zip(self._fast[1], m.groups()):
                    if kind == "num":
                        fields[spec] = int(group)
                    elif kind == "text":
                        key, lowered = spec
                        idx = lowered.index(group.lower())
                        fields[key] = idx + 1 if key == "month" else idx
                    elif kind == "zonetext":
                        zone = _resolve_zone_cached(group)
                        if zone is None:
                            raise TimestampParseError(
                                f"Text '{s}' could not be parsed: "
                                f"unknown zone '{group}'"
                            )
                        fields["zone"] = zone
                    else:  # offset
                        if group in ("Z", "z"):
                            fields["offset"] = 0
                        else:
                            sign = -1 if group[0] == "-" else 1
                            hh = int(group[1:3])
                            mm = int(group[-2:])
                            fields["offset"] = sign * (hh * 3600 + mm * 60)
                return self._resolve(fields, s)
            # fall through: the item-by-item parser produces the exact
            # error message (index of the first mismatch)
        return self._parse_slow(s)

    def _parse_slow(self, s: str) -> ParsedTimestamp:
        fields = {}
        pos = 0
        n = len(s)
        for it in self.items:
            kind = it[0]
            if kind == "lit":
                lit = it[1]
                if s[pos : pos + len(lit)].lower() != lit.lower():
                    raise TimestampParseError(
                        f"Text '{s}' could not be parsed at index {pos}"
                    )
                pos += len(lit)
            elif kind == "num":
                _, field, minw, maxw, space_pad = it
                start = pos
                if space_pad:
                    while pos < n and s[pos] == " " and pos - start < maxw - 1:
                        pos += 1
                digits_start = pos
                signed = field == "epoch" and pos < n and s[pos] in "+-"
                if signed:
                    pos += 1
                while pos < n and s[pos].isdigit() and (pos - digits_start) < maxw:
                    pos += 1
                ndig = pos - digits_start - (1 if signed else 0)
                if (ndig < minw and not space_pad) or ndig == 0:
                    raise TimestampParseError(
                        f"Text '{s}' could not be parsed at index {start}"
                    )
                # The slice keeps any leading sign; int() applies it.
                fields[field] = int(s[digits_start:pos])
            elif kind == "text":
                _, field, style = it
                pos = self._parse_text(s, pos, field, style, fields)
            elif kind == "offset":
                pos = self._parse_offset(s, pos, fields, colon=False)
            elif kind == "offset_colon":
                pos = self._parse_offset(s, pos, fields, colon=True)
            elif kind == "zonetext":
                pos = self._parse_zonetext(s, pos, fields)
            else:  # pragma: no cover
                raise AssertionError(kind)
        if pos != n:
            raise TimestampParseError(
                f"Text '{s}' could not be parsed, unparsed text found at index {pos}"
            )
        return self._resolve(fields, s)

    def _parse_text(self, s, pos, field, style, fields) -> int:
        if field == "monthname":
            table = (self.locale.months_full if style == "full"
                     else self.locale.months_short)
            key = "month"
        elif field == "dayname":
            table = (self.locale.days_full if style == "full"
                     else self.locale.days_short)
            key = "dayofweek"
        else:  # ampm
            table = (list(self.locale.ampm) if style == "upper"
                     else [a.lower() for a in self.locale.ampm])
            key = "ampm"
        low = s[pos:].lower()
        for idx, name in enumerate(table):
            if low.startswith(name.lower()):
                fields[key] = idx + 1 if key == "month" else idx
                return pos + len(name)
        raise TimestampParseError(f"Text '{s}' could not be parsed at index {pos}")

    def _parse_offset(self, s, pos, fields, colon: bool) -> int:
        if colon and pos < len(s) and s[pos] in "zZ":
            fields["offset"] = 0
            return pos + 1
        m = re.match(r"([+-])([0-9]{2}):?([0-9]{2})", s[pos:])
        if not m:
            raise TimestampParseError(f"Text '{s}' could not be parsed at index {pos}")
        sign = -1 if m.group(1) == "-" else 1
        fields["offset"] = sign * (int(m.group(2)) * 3600 + int(m.group(3)) * 60)
        return pos + m.end()

    def _parse_zonetext(self, s, pos, fields) -> int:
        m = re.match(r"[A-Za-z_/+\-0-9]+", s[pos:])
        if not m:
            raise TimestampParseError(f"Text '{s}' could not be parsed at index {pos}")
        name = m.group(0)
        zone = _resolve_zone_cached(name)
        if zone is None:
            raise TimestampParseError(
                f"Text '{s}' could not be parsed: unknown zone '{name}'"
            )
        fields["zone"] = zone
        return pos + m.end()

    # -- resolution ------------------------------------------------------

    def _resolve(self, fields: dict, original: str) -> ParsedTimestamp:
        zone_name = fields.get("zone")
        offset = fields.get("offset")
        if zone_name is None and offset is None and self.default_zone is not None:
            zone_name = self.default_zone

        if "epoch" in fields:
            epoch_s = fields["epoch"]
            epoch_millis = epoch_s * 1000
            off = offset if offset is not None else 0
            tz = _dt.timezone(_dt.timedelta(seconds=off))
            local = _dt.datetime.fromtimestamp(epoch_s, tz=tz)
            return ParsedTimestamp(
                local.year, local.month, local.day, local.hour, local.minute,
                local.second, 0, off, zone_name if offset is None else None,
                epoch_millis,
            )

        year = fields.get("year")
        if year is None and "year2" in fields:
            year = 2000 + fields["year2"]
        if year is None and "wby" in fields and "isoweek" in fields:
            # Week-based date (%G/%V/%u)
            wby = fields["wby"]
            week = fields["isoweek"]
            dow = fields.get("isodow", 1)
            d = _dt.date.fromisocalendar(wby, week, dow)
            year, month, day = d.year, d.month, d.day
        else:
            month = fields.get("month")
            day = fields.get("day")
            if year is not None and month is None and "doy" in fields:
                d = _dt.date(year, 1, 1) + _dt.timedelta(days=fields["doy"] - 1)
                month, day = d.month, d.day

        if year is None or month is None or day is None:
            raise TimestampParseError(
                f"Unable to obtain a complete date from '{original}'"
            )

        hour = fields.get("hour")
        if hour is None and "clock_hour" in fields:
            ch = fields["clock_hour"]
            if ch in (0, 24):
                # Java's SMART resolver special-cases BOTH 0 and 24 for
                # CLOCK_HOUR_OF_DAY as midnight (jdk Parsed.resolveTimeLenient
                # accepts 0 explicitly in SMART mode) — so `%H` parsing of
                # "00:xx:xx" succeeds in the reference.
                hour = 0
            elif 1 <= ch <= 23:
                hour = ch
            else:
                raise TimestampParseError(
                    f"Invalid value for ClockHourOfDay: {ch} in '{original}'"
                )
        if hour is None and "hour12" in fields:
            h12 = fields["hour12"]
            ampm = fields.get("ampm", 0)
            hour = (h12 % 12) + (12 if ampm == 1 else 0)
        if hour is None:
            hour = 0
        minute = fields.get("minute", 0)
        second = fields.get("second", 0)
        nano = fields.get("milli", 0) * 1_000_000 + fields.get("micro", 0) * 1_000

        if second == 60:  # leap second: java.time SMART clamps
            second = 59

        local = _dt.datetime(year, month, day, hour, minute, second,
                             microsecond=nano // 1000)
        if zone_name is not None and offset is None:
            from zoneinfo import ZoneInfo

            tz = ZoneInfo(zone_name)
            aware = local.replace(tzinfo=tz, fold=0)
            epoch_millis = int(aware.timestamp() * 1000)
            real_offset = int(aware.utcoffset().total_seconds())
            return ParsedTimestamp(year, month, day, hour, minute, second, nano,
                                   real_offset, zone_name, epoch_millis)
        off = offset if offset is not None else 0
        tz = _dt.timezone(_dt.timedelta(seconds=off))
        aware = local.replace(tzinfo=tz)
        epoch_millis = int(aware.timestamp() * 1000)
        return ParsedTimestamp(year, month, day, hour, minute, second, nano,
                               off, None, epoch_millis)


# ---------------------------------------------------------------------------
# java.time pattern front-end (the subset the reference uses)
# ---------------------------------------------------------------------------

def compile_java_pattern(
    pattern: str,
    default_zone: Optional[str] = None,
    locale: Optional[LocaleData] = None,
) -> TimeLayout:
    """Compile the java.time pattern subset used by the reference:
    d/dd, M/MM/MMM/MMMM, y/yy/yyyy, H/HH, m/mm, s/ss, S/SSS, E/EEE/EEEE,
    Z/ZZ/ZZZ (+HHMM), X/XX/XXX (+HH:MM, Z), z (zone text), quoted literals.
    """
    items: List[Item] = []
    i = 0
    n = len(pattern)
    while i < n:
        c = pattern[i]
        if c.isalpha():
            j = i
            while j < n and pattern[j] == c:
                j += 1
            count = j - i
            if c == "d":
                items.append(("num", "day", count, 2, False))
            elif c == "M":
                if count >= 4:
                    items.append(("text", "monthname", "full"))
                elif count == 3:
                    items.append(("text", "monthname", "short"))
                else:
                    items.append(("num", "month", count, 2, False))
            elif c == "y":
                if count == 2:
                    items.append(("num", "year2", 2, 2, False))
                else:
                    items.append(("num", "year", count, 4, False))
            elif c == "H":
                items.append(("num", "hour", count, 2, False))
            elif c == "h":
                items.append(("num", "hour12", count, 2, False))
            elif c == "m":
                items.append(("num", "minute", count, 2, False))
            elif c == "s":
                items.append(("num", "second", count, 2, False))
            elif c == "S":
                items.append(("num", "milli", count, count, False))
            elif c == "E":
                items.append(("text", "dayname", "full" if count >= 4 else "short"))
            elif c == "a":
                items.append(("text", "ampm", "upper"))
            elif c == "Z":
                items.append(("offset",))
            elif c == "X":
                items.append(("offset_colon",))
            elif c == "z":
                items.append(("zonetext",))
            elif c == "T":  # bare T appears unquoted in some patterns
                items.append(("lit", "T"))
            else:
                raise ValueError(f"Unsupported pattern letter '{c}' in {pattern!r}")
            i = j
        elif c == "'":
            j = i + 1
            lit = []
            while j < n:
                if pattern[j] == "'":
                    if j + 1 < n and pattern[j + 1] == "'":
                        lit.append("'")
                        j += 2
                        continue
                    break
                lit.append(pattern[j])
                j += 1
            items.append(("lit", "".join(lit) if lit else "'"))
            i = j + 1
        else:
            items.append(("lit", c))
            i += 1

    # Merge adjacent literals for faster parsing.
    merged: List[Item] = []
    for it in items:
        if it[0] == "lit" and merged and merged[-1][0] == "lit":
            merged[-1] = ("lit", merged[-1][1] + it[1])
        else:
            merged.append(list(it) if it[0] == "lit" else it)
    merged = [tuple(it) if isinstance(it, list) else it for it in merged]
    return TimeLayout(merged, default_zone, locale)


# dd/MMM/yyyy:HH:mm:ss ZZ -- (kind, field, min width, max width, space pad)
# for numbers, (kind, field, style) for names, adjacent literals merged.
APACHE_LAYOUT = TimeLayout([
    ("num", "day", 2, 2, False), ("lit", "/"), ("text", "monthname", "short"),
    ("lit", "/"), ("num", "year", 4, 4, False), ("lit", ":"),
    ("num", "hour", 2, 2, False), ("lit", ":"), ("num", "minute", 2, 2, False),
    ("lit", ":"), ("num", "second", 2, 2, False), ("lit", " "), ("offset",),
])
