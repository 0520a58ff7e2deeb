"""TIME.STAMP dissector: one timestamp string -> 30 demand-driven outputs.

The port's own copy of the reference package's ``dissectors/timestamp.py``.

Rebuild of httpdlog/httpdlog-parser/.../dissectors/TimeStampDissector.java:
outputs day/month/monthname/week/year/hour/minute/second/ms/us/ns/date/time in
local + ``_utc`` variants, plus timezone + epoch millis (getPossibleOutput
:136-177); demand flags set in prepare_for_dissect (:222-352); default Apache
pattern ``dd/MMM/yyyy:HH:mm:ss ZZ`` (:46); ISO week fields (Locale.UK, :52).

Faithfully replicated quirk: getPossibleOutput declares ``TIME.ZONE:timezone``
but dissect emits type ``TIME.TIMEZONE`` — so a requested timezone field is
never actually delivered (the reference's own tests assert its absence,
TestTimeStampDissector.java:258).
"""
from __future__ import annotations

from typing import FrozenSet, List, Optional

from ..core.casts import Cast, NO_CASTS, STRING_ONLY, STRING_OR_LONG
from ..core.dissector import Dissector, extract_field_name
from ..core.exceptions import DissectionFailure
from ..core.fields import ParsedField
from .timelayout import (
    LocaleData,
    TimeLayout,
    TimestampParseError,
    compile_java_pattern,
    get_locale,
    week_based_fields,
)

DEFAULT_APACHE_DATE_TIME_PATTERN = "dd/MMM/yyyy:HH:mm:ss ZZ"

_LOCAL_FIELDS = [
    ("day", "TIME.DAY", STRING_OR_LONG),
    ("monthname", "TIME.MONTHNAME", STRING_ONLY),
    ("month", "TIME.MONTH", STRING_OR_LONG),
    ("weekofweekyear", "TIME.WEEK", STRING_OR_LONG),
    ("weekyear", "TIME.YEAR", STRING_OR_LONG),
    ("year", "TIME.YEAR", STRING_OR_LONG),
    ("hour", "TIME.HOUR", STRING_OR_LONG),
    ("minute", "TIME.MINUTE", STRING_OR_LONG),
    ("second", "TIME.SECOND", STRING_OR_LONG),
    ("millisecond", "TIME.MILLISECOND", STRING_OR_LONG),
    ("microsecond", "TIME.MICROSECOND", STRING_OR_LONG),
    ("nanosecond", "TIME.NANOSECOND", STRING_OR_LONG),
    ("date", "TIME.DATE", STRING_ONLY),
    ("time", "TIME.TIME", STRING_ONLY),
]


class TimeStampDissector(Dissector):
    def __init__(
        self,
        date_time_pattern: str = DEFAULT_APACHE_DATE_TIME_PATTERN,
        input_type: str = "TIME.STAMP",
        locale: Optional[str] = None,
    ):
        self._input_type = input_type
        if not date_time_pattern or not date_time_pattern.strip():
            date_time_pattern = DEFAULT_APACHE_DATE_TIME_PATTERN
        self.date_time_pattern = date_time_pattern
        # Reference default is Locale.UK — English names, ISO week fields
        # (TimeStampDissector.java:52).
        self.locale = get_locale(locale)
        self._layout: Optional[TimeLayout] = None
        self.wanted: set = set()

    # -- configuration ---------------------------------------------------

    def initialize_from_settings_parameter(self, settings: str) -> bool:
        self.set_date_time_pattern(settings)
        return True

    def set_date_time_pattern(self, pattern: str) -> None:
        self.date_time_pattern = pattern
        self._layout = None

    def set_locale(self, locale) -> "TimeStampDissector":
        """Month/weekday name tables + week rule for parsing and the
        monthname/week outputs (TimeStampDissector.java:73-78 setLocale).
        Accepts a tag ("fr", "en_US") or a LocaleData; returns self like
        the reference's builder-style setter."""
        self.locale = (
            locale if isinstance(locale, LocaleData) else get_locale(locale)
        )
        if self._layout is not None:
            self._layout = self._layout.with_locale(self.locale)
        return self

    def set_layout(self, layout: TimeLayout) -> None:
        """Install a pre-compiled layout (used by the strftime front-end)."""
        self._layout = layout.with_locale(self.locale)

    def get_layout(self) -> TimeLayout:
        if self._layout is None:
            self._layout = compile_java_pattern(
                self.date_time_pattern, locale=self.locale
            )
        return self._layout

    def get_new_instance(self) -> "Dissector":
        new = type(self)()
        self.initialize_new_instance(new)
        return new

    def initialize_new_instance(self, new_instance: "Dissector") -> None:
        new_instance._input_type = self._input_type
        new_instance.date_time_pattern = self.date_time_pattern
        new_instance.locale = self.locale
        if self._layout is not None:
            new_instance._layout = self._layout

    # -- SPI -------------------------------------------------------------

    def get_input_type(self) -> str:
        return self._input_type

    def set_input_type(self, new_input_type: str) -> None:
        self._input_type = new_input_type

    def get_possible_output(self) -> List[str]:
        result = []
        for name, ftype, _ in _LOCAL_FIELDS:
            result.append(f"{ftype}:{name}")
        result.append("TIME.ZONE:timezone")
        result.append("TIME.EPOCH:epoch")
        for name, ftype, _ in _LOCAL_FIELDS:
            result.append(f"{ftype}:{name}_utc")
        return result

    def prepare_for_dissect(self, input_name: str, output_name: str) -> FrozenSet[Cast]:
        name = extract_field_name(input_name, output_name)
        base = name[:-4] if name.endswith("_utc") else name
        for fname, _, casts in _LOCAL_FIELDS:
            if fname == base:
                self.wanted.add(name)
                return casts
        if name == "timezone":
            self.wanted.add(name)
            return STRING_ONLY
        if name == "epoch":
            self.wanted.add(name)
            return STRING_OR_LONG
        return NO_CASTS

    # -- dissection ------------------------------------------------------

    def dissect(self, parsable, input_name: str) -> None:
        field = parsable.get_parsable_field(self._input_type, input_name)
        self.dissect_field(parsable, input_name, field)

    def dissect_field(self, parsable, input_name: str, field: ParsedField) -> None:
        value = field.value.get_string()
        if value is None or value == "":
            return

        try:
            ts = self.get_layout().parse(value)
        except TimestampParseError as e:
            raise DissectionFailure(str(e)) from e
        except (ValueError, IndexError) as e:
            raise DissectionFailure(f"Unable to parse timestamp {value!r}: {e}") from e

        w = self.wanted
        if "timezone" in w:
            parsable.add_dissection(
                input_name, "TIME.TIMEZONE", "timezone", ts.zone_display_name()
            )
        if "epoch" in w:
            parsable.add_dissection(input_name, "TIME.EPOCH", "epoch", ts.epoch_millis)

        self._emit_components(parsable, input_name, ts, suffix="")
        if any(name.endswith("_utc") for name in w):
            self._emit_components(parsable, input_name, ts.utc_fields(), suffix="_utc")

    def _emit_components(self, parsable, input_name, ts, suffix: str) -> None:
        w = self.wanted
        add = parsable.add_dissection
        if "day" + suffix in w:
            add(input_name, "TIME.DAY", "day" + suffix, ts.day)
        if "monthname" + suffix in w:
            # getDisplayName(TextStyle.FULL, locale): the locale's full
            # month name for BOTH local and _utc (TimeStampDissector.java
            # :446-447, :510-511).
            add(input_name, "TIME.MONTHNAME", "monthname" + suffix,
                self.locale.months_full[ts.month - 1])
        if "month" + suffix in w:
            add(input_name, "TIME.MONTH", "month" + suffix, ts.month)
        if "weekofweekyear" + suffix in w:
            # Local weeks follow WeekFields.of(locale) (:455-459); the
            # _utc twins stay WeekFields.ISO (:519-523).
            wk = (
                ts.iso_week() if suffix
                else week_based_fields(
                    ts.year, ts.month, ts.day,
                    self.locale.week_first_day, self.locale.week_min_days,
                )[1]
            )
            add(input_name, "TIME.WEEK", "weekofweekyear" + suffix, wk)
        if "weekyear" + suffix in w:
            wy = (
                ts.iso_weekyear() if suffix
                else week_based_fields(
                    ts.year, ts.month, ts.day,
                    self.locale.week_first_day, self.locale.week_min_days,
                )[0]
            )
            add(input_name, "TIME.YEAR", "weekyear" + suffix, wy)
        if "year" + suffix in w:
            add(input_name, "TIME.YEAR", "year" + suffix, ts.year)
        if "hour" + suffix in w:
            add(input_name, "TIME.HOUR", "hour" + suffix, ts.hour)
        if "minute" + suffix in w:
            add(input_name, "TIME.MINUTE", "minute" + suffix, ts.minute)
        if "second" + suffix in w:
            add(input_name, "TIME.SECOND", "second" + suffix, ts.second)
        if "millisecond" + suffix in w:
            add(input_name, "TIME.MILLISECOND", "millisecond" + suffix,
                ts.nano // 1_000_000)
        if "microsecond" + suffix in w:
            add(input_name, "TIME.MICROSECOND", "microsecond" + suffix,
                ts.nano // 1_000)
        if "nanosecond" + suffix in w:
            add(input_name, "TIME.NANOSECOND", "nanosecond" + suffix, ts.nano)
        if "date" + suffix in w:
            add(input_name, "TIME.DATE", "date" + suffix, ts.date_str())
        if "time" + suffix in w:
            add(input_name, "TIME.TIME", "time" + suffix, ts.time_str())
