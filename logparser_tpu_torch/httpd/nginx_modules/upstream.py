"""NGINX upstream module variables + the upstream list dissector (the
port's own copy of the reference package's
``httpd/nginx_modules/upstream.py``).

Rebuild of .../nginxmodules/UpstreamModule.java and UpstreamListDissector.java:
upstream variables are ``", "``-separated lists with ``": "`` redirect groups;
the list dissector splits them into indexed ``N.value``/``N.redirected``
outputs (UpstreamListDissector.java:78-109).
"""
from __future__ import annotations

from typing import FrozenSet, List, Optional

from ...core.casts import (
    Cast,
    NO_CASTS,
    STRING_ONLY,
    STRING_OR_LONG,
    STRING_OR_LONG_OR_DOUBLE,
)
from ...core.dissector import Dissector, extract_field_name
from ...dissectors.tokenformat import (
    FORMAT_NO_SPACE_STRING,
    FORMAT_NUMBER,
    FORMAT_NUMBER_DECIMAL,
    FORMAT_STRING,
    NamedTokenParser,
    TokenParser,
)
from . import NginxModule

_PREFIX = "nginxmodule.upstream"


def _upstream_list_of(regex: str) -> str:
    return regex + "(?: *, *" + regex + "(?: *: *" + regex + ")?)*"


class UpstreamListDissector(Dissector):
    OUTPUT_ORIGINAL_NAME = ".value"
    OUTPUT_REDIRECTED_NAME = ".redirected"

    def __init__(
        self,
        input_type: Optional[str] = None,
        output_original_type: Optional[str] = None,
        output_original_casts: Optional[FrozenSet[Cast]] = None,
        output_redirected_type: Optional[str] = None,
        output_redirected_casts: Optional[FrozenSet[Cast]] = None,
    ):
        self.input_type = input_type
        self.output_original_type = output_original_type
        self.output_original_casts = output_original_casts
        self.output_redirected_type = output_redirected_type
        self.output_redirected_casts = output_redirected_casts

    def get_input_type(self) -> str:
        return self.input_type

    def get_possible_output(self) -> List[str]:
        result = []
        for i in range(32):
            result.append(f"{self.output_original_type}:{i}{self.OUTPUT_ORIGINAL_NAME}")
            result.append(
                f"{self.output_redirected_type}:{i}{self.OUTPUT_REDIRECTED_NAME}"
            )
        return result

    def prepare_for_dissect(self, input_name: str, output_name: str) -> FrozenSet[Cast]:
        name = extract_field_name(input_name, output_name)
        if name.endswith(self.OUTPUT_ORIGINAL_NAME):
            return self.output_original_casts
        if name.endswith(self.OUTPUT_REDIRECTED_NAME):
            return self.output_redirected_casts
        return NO_CASTS

    def get_new_instance(self) -> "Dissector":
        return UpstreamListDissector(
            self.input_type,
            self.output_original_type,
            self.output_original_casts,
            self.output_redirected_type,
            self.output_redirected_casts,
        )

    def dissect(self, parsable, input_name: str) -> None:
        field = parsable.get_parsable_field(self.input_type, input_name)
        value = field.value.get_string()
        if value is None:
            return
        for server_nr, server in enumerate(value.split(", ")):
            parts = server.split(": ")
            original = parts[0].strip()
            redirected = parts[1].strip() if len(parts) > 1 else original
            parsable.add_dissection(
                input_name,
                self.output_original_type,
                f"{server_nr}{self.OUTPUT_ORIGINAL_NAME}",
                original,
            )
            parsable.add_dissection(
                input_name,
                self.output_redirected_type,
                f"{server_nr}{self.OUTPUT_REDIRECTED_NAME}",
                redirected,
            )


class UpstreamModule(NginxModule):
    def get_token_parsers(self) -> List[TokenParser]:
        addr_list = _upstream_list_of(FORMAT_NO_SPACE_STRING)
        bytes_list = _upstream_list_of(FORMAT_NUMBER)
        time_list = _upstream_list_of(FORMAT_NUMBER_DECIMAL)
        return [
            # $upstream_addr: IP:port / unix socket path list
            TokenParser("$upstream_addr", _PREFIX + ".addr", "UPSTREAM_ADDR_LIST",
                        STRING_ONLY, addr_list),
            # $upstream_bytes_received / $upstream_bytes_sent
            TokenParser("$upstream_bytes_received", _PREFIX + ".bytes.received",
                        "UPSTREAM_BYTES_LIST", STRING_ONLY, bytes_list),
            TokenParser("$upstream_bytes_sent", _PREFIX + ".bytes.sent",
                        "UPSTREAM_BYTES_LIST", STRING_ONLY, bytes_list),
            # $upstream_cache_status
            TokenParser("$upstream_cache_status", _PREFIX + ".cache.status",
                        "UPSTREAM_CACHE_STATUS", STRING_ONLY,
                        "(?:MISS|BYPASS|EXPIRED|STALE|UPDATING|REVALIDATED|HIT)"),
            # $upstream_connect_time
            TokenParser("$upstream_connect_time", _PREFIX + ".connect.time",
                        "UPSTREAM_SECOND_MILLIS_LIST", STRING_ONLY, time_list),
            # $upstream_cookie_<name>
            NamedTokenParser("\\$upstream_cookie_([a-z0-9\\-_]*)",
                             _PREFIX + ".response.cookies.", "HTTP.COOKIE",
                             STRING_ONLY, FORMAT_STRING),
            # $upstream_header_time
            TokenParser("$upstream_header_time", _PREFIX + ".header.time",
                        "UPSTREAM_SECOND_MILLIS_LIST", STRING_ONLY, time_list),
            # $upstream_http_<name>
            NamedTokenParser("\\$upstream_http_([a-z0-9\\-_]*)",
                             _PREFIX + ".header.", "HTTP.HEADER",
                             STRING_ONLY, FORMAT_STRING),
            # $upstream_queue_time
            TokenParser("$upstream_queue_time", _PREFIX + ".queue.time",
                        "UPSTREAM_SECOND_MILLIS_LIST", STRING_ONLY, time_list),
            # $upstream_response_length / $upstream_response_time / $upstream_status
            TokenParser("$upstream_response_length", _PREFIX + ".response.length",
                        "UPSTREAM_BYTES_LIST", STRING_ONLY, bytes_list),
            TokenParser("$upstream_response_time", _PREFIX + ".response.time",
                        "UPSTREAM_SECOND_MILLIS_LIST", STRING_ONLY, time_list),
            TokenParser("$upstream_status", _PREFIX + ".status",
                        "UPSTREAM_STATUS_LIST", STRING_ONLY,
                        _upstream_list_of(FORMAT_NO_SPACE_STRING)),
            # $upstream_trailer_<name>
            NamedTokenParser("\\$upstream_trailer_([a-z0-9\\-_]*)",
                             _PREFIX + ".trailer.", "HTTP.TRAILER",
                             STRING_ONLY, FORMAT_STRING),
            # $upstream_first_byte_time / $upstream_session_time
            TokenParser("$upstream_first_byte_time", _PREFIX + ".first_byte.time",
                        "UPSTREAM_SECOND_MILLIS_LIST", STRING_ONLY, time_list),
            TokenParser("$upstream_session_time", _PREFIX + ".session.time",
                        "UPSTREAM_SECOND_MILLIS_LIST", STRING_ONLY, time_list),
        ]

    def get_dissectors(self) -> List[Dissector]:
        return [
            UpstreamListDissector("UPSTREAM_ADDR_LIST",
                                  "UPSTREAM_ADDR", STRING_ONLY,
                                  "UPSTREAM_ADDR", STRING_ONLY),
            UpstreamListDissector("UPSTREAM_BYTES_LIST",
                                  "BYTES", STRING_OR_LONG,
                                  "BYTES", STRING_OR_LONG),
            UpstreamListDissector("UPSTREAM_SECOND_MILLIS_LIST",
                                  "SECOND_MILLIS", STRING_OR_LONG_OR_DOUBLE,
                                  "SECOND_MILLIS", STRING_OR_LONG_OR_DOUBLE),
            UpstreamListDissector("UPSTREAM_STATUS_LIST",
                                  "UPSTREAM_STATUS", STRING_ONLY,
                                  "UPSTREAM_STATUS", STRING_ONLY),
        ]
