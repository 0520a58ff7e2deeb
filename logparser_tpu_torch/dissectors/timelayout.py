"""The timestamp layout of Apache's ``[%t]`` (the port's own copy of what
it needs from the reference package's ``dissectors/timelayout.py``).

A layout is a flat list of items, each matching a fixed slice of the
input.  :data:`APACHE_LAYOUT` is ``dd/MMM/yyyy:HH:mm:ss ZZ`` in the
English locale, the items the reference's ``compile_java_pattern``
produces for that pattern.  Other patterns, other locales and the
per-line host parser are later slices.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

MONTHS_SHORT = ["Jan", "Feb", "Mar", "Apr", "May", "Jun",
                "Jul", "Aug", "Sep", "Oct", "Nov", "Dec"]
MONTHS_FULL = ["January", "February", "March", "April", "May", "June",
               "July", "August", "September", "October", "November", "December"]
DAYS_SHORT = ["Mon", "Tue", "Wed", "Thu", "Fri", "Sat", "Sun"]
DAYS_FULL = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
             "Saturday", "Sunday"]

Item = Tuple


class LocaleData:
    """Month/weekday name tables + week rule for one locale
    (``week_first_day`` is ISO numbering, 1 = Monday)."""

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


class TimeLayout:
    """A compiled timestamp layout: items + default zone + locale."""

    def __init__(self, items: List[Item], default_zone: Optional[str] = None,
                 locale: Optional[LocaleData] = None):
        self.items = items
        self.default_zone = default_zone
        self.locale = locale or EN


# dd/MMM/yyyy:HH:mm:ss ZZ -- (kind, field, min width, max width, space pad)
# for numbers, (kind, field, style) for names, adjacent literals merged.
APACHE_LAYOUT = TimeLayout([
    ("num", "day", 2, 2, False), ("lit", "/"), ("text", "monthname", "short"),
    ("lit", "/"), ("num", "year", 4, 4, False), ("lit", ":"),
    ("num", "hour", 2, 2, False), ("lit", ":"), ("num", "minute", 2, 2, False),
    ("lit", ":"), ("num", "second", 2, 2, False), ("lit", " "), ("offset",),
])
