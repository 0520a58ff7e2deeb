"""Multi-format wrapper: several LogFormat lines, runtime fallback/switching.

The port's own copy of the reference package's ``httpd/format_dissector.py``.

Rebuild of httpdlog/httpdlog-parser/.../httpdlog/HttpdLogFormatDissector.java:
accepts multiple LogFormat lines (one per line, :99-101), sniffs Apache vs
NGINX per line (:126-140), keeps an active dissector at runtime and on
DissectionFailure retries every registered format then switches (:174-204),
plus the Jetty quirk fixes (:62-97).
"""
from __future__ import annotations

import logging
from typing import FrozenSet, List, Optional

from ..core.casts import Cast, NO_CASTS
from ..core.dissector import Dissector
from ..core.exceptions import DissectionFailure, InvalidDissectorException
from ..dissectors.tokenformat import TokenFormatDissector
from .apache import ApacheHttpdLogFormatDissector, looks_like_apache_format
from .nginx import NginxHttpdLogFormatDissector, looks_like_nginx_format

LOG = logging.getLogger(__name__)

INPUT_TYPE = "HTTPLOGLINE"


class HttpdLogFormatDissector(Dissector):
    def __init__(self, multi_line_log_format: Optional[str] = None):
        self.registered_log_formats: List[str] = []
        self.dissectors: List[TokenFormatDissector] = []
        self.active_dissector: Optional[TokenFormatDissector] = None
        self._enable_jetty_fix = False
        # Reference semantics are STATEFUL: the last-successful format stays
        # active across lines (HttpdLogFormatDissector.java:174-204), so a
        # line matching several formats parses differently depending on
        # stream history.  Stateless mode re-tries from the first registered
        # format on every line — deterministic registration priority, the
        # semantics the device batch path guarantees (and needs from its
        # fallback oracle so device and oracle agree per line).
        self.stateless = False
        if multi_line_log_format is not None:
            self.add_multiple_log_formats(multi_line_log_format)
            if self._enable_jetty_fix:
                self._add_jetty_fix_formats()

    # -- registration ----------------------------------------------------

    def enable_jetty_fix(self) -> "HttpdLogFormatDissector":
        self._enable_jetty_fix = True
        return self

    def _add_jetty_fix_formats(self) -> None:
        # Jetty historically logged an empty useragent with a trailing space
        # and an empty user as " - "; register patched format variants.
        for log_format in self._get_all_log_formats():
            if '"%{User-Agent}i"' in log_format:
                self.add_log_format(
                    log_format.replace('"%{User-Agent}i"', '"%{User-Agent}i" ')
                )
        for log_format in self._get_all_log_formats():
            if "%u" in log_format:
                self.add_log_format(log_format.replace("%u", " %u "))

    def add_multiple_log_formats(self, multi_line: str) -> "HttpdLogFormatDissector":
        for line in multi_line.splitlines():
            self.add_log_format(line)
        return self

    def add_log_formats(self, log_formats: List[str]) -> "HttpdLogFormatDissector":
        for lf in log_formats:
            self.add_log_format(lf)
        return self

    def add_log_format(self, log_format: Optional[str]) -> "HttpdLogFormatDissector":
        if log_format is None or not log_format.strip():
            return self
        if log_format.upper().strip() == "ENABLE JETTY FIX":
            return self.enable_jetty_fix()
        if log_format in self.registered_log_formats:
            LOG.info("Skipping duplicate LogFormat: >>%s<<", log_format)
            return self
        self.registered_log_formats.append(log_format)

        if looks_like_apache_format(log_format):
            self.dissectors.append(ApacheHttpdLogFormatDissector(log_format))
        elif looks_like_nginx_format(log_format):
            self.dissectors.append(NginxHttpdLogFormatDissector(log_format))
        else:
            LOG.error(
                "Unable to determine if this is an APACHE or a NGINX LogFormat= >>%s<<",
                log_format,
            )
        return self

    def _get_all_log_formats(self) -> List[str]:
        return [d.get_log_format() for d in self.dissectors]

    # -- SPI -------------------------------------------------------------

    def initialize_from_settings_parameter(self, settings: str) -> bool:
        self.add_multiple_log_formats(settings)
        return True

    def create_additional_dissectors(self, parser) -> None:
        for dissector in self.dissectors:
            dissector.create_additional_dissectors(parser)

    def get_input_type(self) -> str:
        return INPUT_TYPE

    def get_possible_output(self) -> List[str]:
        if not self.dissectors:
            return []
        seen = set()
        result = []
        for dissector in self.dissectors:
            for output in dissector.get_possible_output():
                if output not in seen:
                    seen.add(output)
                    result.append(output)
        return result

    def prepare_for_dissect(self, input_name: str, output_name: str) -> FrozenSet[Cast]:
        if not self.dissectors:
            return NO_CASTS
        result: FrozenSet[Cast] = NO_CASTS
        for dissector in self.dissectors:
            result = result | dissector.prepare_for_dissect(input_name, output_name)
        return result

    def prepare_for_run(self) -> None:
        if not self.dissectors:
            raise InvalidDissectorException("Cannot run without logformats")
        for dissector in self.dissectors:
            if dissector.get_input_type() != INPUT_TYPE:
                raise InvalidDissectorException(
                    "All dissectors controlled by HttpdLogFormatDissector MUST "
                    f'have "{INPUT_TYPE}" as their inputtype.'
                )
            dissector.prepare_for_run()

    def get_new_instance(self) -> "Dissector":
        new = HttpdLogFormatDissector()
        self.initialize_new_instance(new)
        return new

    def initialize_new_instance(self, new_instance: "Dissector") -> None:
        if not self.dissectors:
            return
        new_instance.add_log_formats(self._get_all_log_formats())
        if self._enable_jetty_fix:
            new_instance.enable_jetty_fix()
        new_instance.stateless = self.stateless

    # -- dissection with fallback/switch ---------------------------------

    def dissect(self, parsable, input_name: str) -> None:
        if not self.dissectors:
            raise DissectionFailure(
                "We need one or more logformats before we can dissect."
            )
        if self.stateless or self.active_dissector is None:
            self.active_dissector = self.dissectors[0]

        try:
            self.active_dissector.dissect(parsable, input_name)
        except DissectionFailure:
            if len(self.dissectors) > 1:
                for dissector in self.dissectors:
                    try:
                        dissector.dissect(parsable, input_name)
                        LOG.info(
                            "Switched to LogFormat >>%s<<", dissector.get_log_format()
                        )
                        self.active_dissector = dissector
                        return
                    except DissectionFailure:
                        continue
            raise
