"""strftime timestamps: the ``%{format}t`` layout compiler (the port's own
copy of ``compile_strftime`` from the reference package's
``dissectors/strftime_stamp.py``).

A strftime(3) format becomes a :class:`~.timelayout.TimeLayout`: ``%X``
directives map to layout items, everything else is a literal, adjacent
literals merge, and a format without ``%z`` / ``%Z`` assumes
:data:`DEFAULT_ZONE`.

The host oracle's dissectors are copies of the reference's:
:class:`StrfTimeStampDissector` (StrfTimeStampDissector.java: wraps a
TimeStampDissector with the converted layout, :40-68) and
:class:`LocalizedTimeDissector`, the fallback that re-emits the raw value
as ``TIME.LOCALIZEDSTRING`` (:104-157).
"""
from __future__ import annotations

from typing import FrozenSet, List, Optional

from ..core.casts import Cast, STRING_ONLY
from ..core.dissector import Dissector
from ..core.fields import ParsedField
from .timelayout import Item, TimeLayout
from .timestamp import TimeStampDissector

DEFAULT_ZONE = "UTC"


class UnsupportedStrfField(ValueError):
    def __init__(self, field: str):
        super().__init__(
            f"The field '{field}' cannot be converted towards a timestamp layout field."
        )


# Single-item directives: %X -> its item.
_SIMPLE = {
    "%": ("lit", "%"), "n": ("lit", "\n"), "t": ("lit", "\t"),
    "a": ("text", "dayname", "short"), "A": ("text", "dayname", "full"),
    "b": ("text", "monthname", "short"), "h": ("text", "monthname", "short"),
    "B": ("text", "monthname", "full"),
    "d": ("num", "day", 2, 2, False), "e": ("num", "day", 1, 2, True),
    "G": ("num", "wby", 4, 4, False), "g": ("num", "wby2", 2, 2, False),
    # %H is the clock hour (1-24; 0 and 24 both read as midnight).
    "H": ("num", "clock_hour", 2, 2, False),
    "I": ("num", "hour12", 2, 2, False), "j": ("num", "doy", 3, 3, False),
    "k": ("num", "hour", 1, 2, True), "l": ("num", "hour12", 1, 2, True),
    "m": ("num", "month", 2, 2, False), "M": ("num", "minute", 2, 2, False),
    "p": ("text", "ampm", "upper"), "P": ("text", "ampm", "lower"),
    "s": ("num", "epoch", 1, 19, False), "S": ("num", "second", 2, 2, False),
    "u": ("num", "isodow", 1, 1, False), "V": ("num", "isoweek", 1, 2, False),
    "W": ("num", "isoweek", 2, 2, False), "y": ("num", "year2", 2, 2, False),
    "Y": ("num", "year", 4, 4, False),
}
# Composite directives: %X -> its items.
_COMPOSITE = {
    "D": [("num", "month", 2, 2, False), ("lit", "/"), ("num", "day", 2, 2, False),
          ("lit", "/"), ("num", "year2", 2, 2, False)],
    "F": [("num", "year", 4, 4, False), ("lit", "-"), ("num", "month", 2, 2, False),
          ("lit", "-"), ("num", "day", 2, 2, False)],
    "r": [("num", "hour12", 2, 2, False), ("lit", ":"), ("num", "minute", 2, 2, False),
          ("lit", ":"), ("num", "second", 2, 2, False), ("lit", " "),
          ("text", "ampm", "upper")],
    "R": [("num", "hour", 2, 2, False), ("lit", ":"), ("num", "minute", 2, 2, False)],
    "T": [("num", "hour", 2, 2, False), ("lit", ":"), ("num", "minute", 2, 2, False),
          ("lit", ":"), ("num", "second", 2, 2, False)],
}
_UNSUPPORTED = set("cCUwxX+")


def compile_strftime(
    strfformat: str, default_zone: str = DEFAULT_ZONE
) -> Optional[TimeLayout]:
    """strftime(3) format -> TimeLayout.  Returns None on syntax errors
    (a dangling or unknown ``%``), raises UnsupportedStrfField on
    directives no layout field models."""
    items: List[Item] = []
    has_zone = False
    i = 0
    n = len(strfformat)
    while i < n:
        # Apache's fraction tokens match with or without a leading '%'
        # and beat every other directive.
        rest = strfformat[i:]
        frac = next(((name, field, width) for name, field, width in
                     (("msec_frac", "milli", 3), ("usec_frac", "micro", 6))
                     if rest.startswith(name) or rest.startswith("%" + name)), None)
        if frac is not None:
            name, field, width = frac
            items.append(("num", field, width, width, False))
            i += len(name) + (1 if rest.startswith("%") else 0)
            continue
        c = strfformat[i]
        if c != "%":
            items.append(("lit", c))
            i += 1
            continue
        if i + 1 >= n:
            return None
        d = strfformat[i + 1]
        i += 2
        if d in ("E", "O") and i < n:
            # E / O alternative-format modifiers are ignored.
            d = strfformat[i]
            i += 1
        if d in _SIMPLE:
            items.append(_SIMPLE[d])
        elif d in _COMPOSITE:
            items.extend(_COMPOSITE[d])
        elif d == "z":
            items.append(("offset",))
            has_zone = True
        elif d == "Z":
            items.append(("zonetext",))
            has_zone = True
        elif d in _UNSUPPORTED:
            raise UnsupportedStrfField("%" + d)
        else:
            return None

    merged: List[Item] = []
    for it in items:
        if it[0] == "lit" and merged and merged[-1][0] == "lit":
            merged[-1] = ("lit", merged[-1][1] + it[1])
        else:
            merged.append(it)
    return TimeLayout(merged, None if has_zone else default_zone)


class StrfTimeStampDissector(Dissector):
    """Handles ``%{strfformat}t``: converts the strftime pattern to a layout
    and delegates to an embedded TimeStampDissector."""

    def __init__(self):
        self.timestamp_dissector = TimeStampDissector()
        self.strf_pattern: Optional[str] = None
        self._input_type = "TIME.?????"
        # One LocalizedTimeDissector per instance: create_additional runs
        # again on every re-assembly (e.g. after set_locale), and
        # add_dissector dedups by identity — a fresh instance per call
        # would accumulate duplicates.
        self._localized: Optional["LocalizedTimeDissector"] = None

    def set_date_time_pattern(self, pattern: Optional[str]) -> None:
        if pattern is None:
            self.timestamp_dissector.set_date_time_pattern("")
            return
        if pattern == self.strf_pattern:
            return
        self.strf_pattern = pattern
        layout = compile_strftime(pattern)
        if layout is None:
            raise UnsupportedStrfField(pattern)
        self.timestamp_dissector.set_layout(layout)

    def initialize_from_settings_parameter(self, settings: str) -> bool:
        self.set_date_time_pattern(settings)
        return True

    def set_locale(self, locale) -> "StrfTimeStampDissector":
        """Delegates to the embedded TimeStampDissector (the reference's
        wrapped-dissector shape keeps one locale, TimeStampDissector.java
        :73-78)."""
        self.timestamp_dissector.set_locale(locale)
        return self

    def dissect(self, parsable, input_name: str) -> None:
        field: ParsedField = parsable.get_parsable_field(self._input_type, input_name)
        self.timestamp_dissector.dissect_field(parsable, input_name, field)

    def get_input_type(self) -> str:
        return self._input_type

    def set_input_type(self, new_input_type: str) -> None:
        self._input_type = new_input_type

    def get_possible_output(self) -> List[str]:
        return self.timestamp_dissector.get_possible_output()

    def prepare_for_dissect(self, input_name: str, output_name: str) -> FrozenSet[Cast]:
        return self.timestamp_dissector.prepare_for_dissect(input_name, output_name)

    def prepare_for_run(self) -> None:
        self.timestamp_dissector.prepare_for_run()

    def get_new_instance(self) -> "Dissector":
        new = StrfTimeStampDissector()
        self.initialize_new_instance(new)
        return new

    def initialize_new_instance(self, new_instance: "Dissector") -> None:
        new_instance.set_input_type(self._input_type)
        new_instance.set_locale(self.timestamp_dissector.locale)
        if self.strf_pattern is not None:
            new_instance.set_date_time_pattern(self.strf_pattern)

    def create_additional_dissectors(self, parser) -> None:
        if self._localized is None:
            self._localized = LocalizedTimeDissector(self._input_type)
        self._localized.set_input_type(self._input_type)
        parser.add_dissector(self._localized)


class LocalizedTimeDissector(Dissector):
    """Fallback that re-emits the raw strftime timestamp value as
    ``TIME.LOCALIZEDSTRING`` (StrfTimeStampDissector.java:104-157)."""

    def __init__(self, input_type: Optional[str] = None):
        self._input_type = input_type

    def set_input_type(self, new_input_type: str) -> None:
        self._input_type = new_input_type

    def initialize_from_settings_parameter(self, settings: str) -> bool:
        self.set_input_type(settings)
        return True

    def dissect(self, parsable, input_name: str) -> None:
        field = parsable.get_parsable_field(self._input_type, input_name)
        parsable.add_dissection(input_name, "TIME.LOCALIZEDSTRING", "", field.value)

    def get_input_type(self) -> str:
        return self._input_type

    def get_possible_output(self) -> List[str]:
        return ["TIME.LOCALIZEDSTRING:"]

    def prepare_for_dissect(self, input_name: str, output_name: str) -> FrozenSet[Cast]:
        return STRING_ONLY

    def get_new_instance(self) -> "Dissector":
        return LocalizedTimeDissector(self._input_type)
