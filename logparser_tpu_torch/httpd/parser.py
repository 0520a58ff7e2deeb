"""The user-facing facade: ``HttpdLoglineParser(record_class, logformat)``
(the port's own copy of the reference package's ``httpd/parser.py``; the
batch parser's host oracle is one of these).

Rebuild of httpdlog/httpdlog-parser/.../httpdlog/HttpdLoglineParser.java:
registers the multi-format dissector + all sub-dissectors + the CLF<->number
translators, and sets the root type (setupDissectors :104-126).
"""
from __future__ import annotations

from typing import Optional

from ..core.parser import Parser
from ..dissectors.cookies import (
    RequestCookieListDissector,
    ResponseSetCookieDissector,
    ResponseSetCookieListDissector,
)
from ..dissectors.firstline import (
    HttpFirstLineDissector,
    HttpFirstLineProtocolDissector,
)
from ..dissectors.mod_unique_id import ModUniqueIdDissector
from ..dissectors.query import QueryStringFieldDissector
from ..dissectors.timestamp import (
    DEFAULT_APACHE_DATE_TIME_PATTERN,
    TimeStampDissector,
)
from ..dissectors.translate import ConvertCLFIntoNumber, ConvertNumberIntoCLF
from ..dissectors.uri import HttpUriDissector
from .format_dissector import INPUT_TYPE, HttpdLogFormatDissector


class HttpdLoglineParser(Parser):
    def __init__(
        self,
        record_class: Optional[type],
        log_format: str,
        timestamp_format: Optional[str] = None,
        locale: Optional[str] = None,
    ):
        super().__init__(record_class)
        self._setup_dissectors(log_format, timestamp_format)
        if locale is not None:
            # Parser-level surface over TimeStampDissector.setLocale
            # (TimeStampDissector.java:73-78): month/day name tables +
            # WeekFields rule for every timestamp dissector, including
            # the per-token strftime instances created during assembly.
            self.set_locale(locale)

    def _setup_dissectors(
        self, log_format: str, timestamp_format: Optional[str]
    ) -> None:
        self.add_dissector(HttpdLogFormatDissector(log_format))
        self.add_dissector(
            TimeStampDissector(
                timestamp_format or DEFAULT_APACHE_DATE_TIME_PATTERN, "TIME.STAMP"
            )
        )
        self.add_dissector(
            TimeStampDissector("yyyy-MM-dd'T'HH:mm:ssXXX", "TIME.ISO8601")
        )
        self.add_dissector(HttpFirstLineDissector())
        self.add_dissector(HttpFirstLineProtocolDissector())
        self.add_dissector(HttpUriDissector())
        self.add_dissector(QueryStringFieldDissector())
        self.add_dissector(RequestCookieListDissector())
        self.add_dissector(ResponseSetCookieListDissector())
        self.add_dissector(ResponseSetCookieDissector())
        self.add_dissector(ModUniqueIdDissector())

        # Type translators
        self.add_dissector(ConvertCLFIntoNumber("BYTESCLF", "BYTES"))
        self.add_dissector(ConvertNumberIntoCLF("BYTES", "BYTESCLF"))

        self.set_root_type(INPUT_TYPE)
