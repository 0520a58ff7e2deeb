"""HTTP request first-line dissection ("GET /x HTTP/1.1" -> method/uri/protocol).

The port's own copy of the reference package's ``dissectors/firstline.py``.

Rebuild of httpdlog/httpdlog-parser/.../dissectors/HttpFirstLineDissector.java
(split regex :59-60 with truncated-line fallback :62-63, 108-121) and
HttpFirstLineProtocolDissector.java (protocol/version split on ``/`` :54-77).
"""
from __future__ import annotations

import re
from typing import FrozenSet, List, Set

from ..core.casts import Cast, STRING_ONLY
from ..core.dissector import Dissector, extract_field_name


class HttpFirstLineDissector(Dissector):
    # The token regex is just '.*' so garbage survives the skeleton match;
    # the real structure check happens here.
    FIRSTLINE_REGEX = ".*"

    _SPLITTER = re.compile(r"^([a-zA-Z-_]+) (.*) (HTTP/[0-9]+\.[0-9]+)$")
    _TOO_LONG_SPLITTER = re.compile(r"^([a-zA-Z-_]+) (.*)$")

    INPUT_TYPE = "HTTP.FIRSTLINE"

    def __init__(self):
        self.requested: Set[str] = set()

    def get_input_type(self) -> str:
        return self.INPUT_TYPE

    def get_possible_output(self) -> List[str]:
        return [
            "HTTP.METHOD:method",
            "HTTP.URI:uri",
            "HTTP.PROTOCOL_VERSION:protocol",
        ]

    def prepare_for_dissect(self, input_name: str, output_name: str) -> FrozenSet[Cast]:
        self.requested.add(extract_field_name(input_name, output_name))
        return STRING_ONLY

    def get_new_instance(self) -> "Dissector":
        return HttpFirstLineDissector()

    def dissect(self, parsable, input_name: str) -> None:
        field = parsable.get_parsable_field(self.INPUT_TYPE, input_name)
        value = field.value.get_string()
        if value is None or value == "" or value == "-":
            return

        m = self._SPLITTER.search(value)
        if m is not None:
            self._output(parsable, input_name, "HTTP.METHOD", "method", m.group(1))
            self._output(parsable, input_name, "HTTP.URI", "uri", m.group(2))
            self._output(
                parsable, input_name, "HTTP.PROTOCOL_VERSION", "protocol", m.group(3)
            )
            return

        # The request URI may have been so long that the protocol was cut off.
        m = self._TOO_LONG_SPLITTER.search(value)
        if m is not None:
            self._output(parsable, input_name, "HTTP.METHOD", "method", m.group(1))
            self._output(parsable, input_name, "HTTP.URI", "uri", m.group(2))
            parsable.add_dissection(
                input_name, "HTTP.PROTOCOL_VERSION", "protocol", None
            )

    def _output(self, parsable, input_name, ftype, name, value) -> None:
        if name in self.requested:
            parsable.add_dissection(input_name, ftype, name, value)


class HttpFirstLineProtocolDissector(Dissector):
    """HTTP.PROTOCOL_VERSION ("HTTP/1.1") -> protocol + version."""

    INPUT_TYPE = "HTTP.PROTOCOL_VERSION"

    def __init__(self):
        self.requested: Set[str] = set()

    def get_input_type(self) -> str:
        return self.INPUT_TYPE

    def get_possible_output(self) -> List[str]:
        return ["HTTP.PROTOCOL:", "HTTP.PROTOCOL.VERSION:version"]

    def prepare_for_dissect(self, input_name: str, output_name: str) -> FrozenSet[Cast]:
        self.requested.add(extract_field_name(input_name, output_name))
        return STRING_ONLY

    def get_new_instance(self) -> "Dissector":
        return HttpFirstLineProtocolDissector()

    def dissect(self, parsable, input_name: str) -> None:
        field = parsable.get_parsable_field(self.INPUT_TYPE, input_name)
        value = field.value.get_string()
        if value is None or value == "" or value == "-":
            return

        parts = value.split("/", 1)
        if len(parts) == 2:
            self._output(parsable, input_name, "HTTP.PROTOCOL", "", parts[0])
            self._output(
                parsable, input_name, "HTTP.PROTOCOL.VERSION", "version", parts[1]
            )
            return

        # Truncated first line: emit explicit nulls.
        parsable.add_dissection(input_name, "HTTP.PROTOCOL", "", None)
        parsable.add_dissection(input_name, "HTTP.PROTOCOL.VERSION", "version", None)

    def _output(self, parsable, input_name, ftype, name, value) -> None:
        if name in self.requested:
            parsable.add_dissection(input_name, ftype, name, value)
