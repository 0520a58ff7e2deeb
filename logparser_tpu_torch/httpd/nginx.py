"""The NGINX ``$variable`` table dissector (the port's own copy of the
reference package's ``httpd/nginx.py``).

Rebuild of httpdlog/httpdlog-parser/.../httpdlog/NginxHttpdLogFormatDissector.java:
the variable table is assembled from six pluggable modules (:121-129), the
``combined`` alias (:82-91), ``-`` -> null decode (:107-119), plus helper
dissectors: BinaryIPDissector (``\\xHH`` x4 -> dotted IP, :151-178) and
seconds-with-millis / ms->us converters (:140-149).

The device compiler reads :class:`NginxLogFormat` (the token list) and
plan resolution :func:`additional_consumers` (the consumer edges the
format's additional dissectors add: ``SECOND_MILLIS`` -> ``MILLISECONDS``
and ``TIME.EPOCH_SECOND_MILLIS`` -> ``TIME.EPOCH``, the ``secmillis``
plan; ``MILLISECONDS`` -> ``MICROSECONDS`` (x 1000); ``IP_BINARY`` ->
``IP``, delivered by the host oracle; the upstream lists' indexed
elements).
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from ..core.casts import STRING_OR_LONG
from ..core.dissector import Dissector, SimpleDissector
from ..core.fields import ParsedField
from ..dissectors.tokenformat import Token, TokenFormatDissector, TokenParser, tokenize
from ..dissectors.translate import (
    ConvertMillisecondsIntoMicroseconds,
    ConvertSecondsWithMillisStringDissector,
)
from ..dissectors.utils import hex_chars_to_byte
from .nginx_modules import ALL_MODULES

INPUT_TYPE = "HTTPLOGLINE"

NGINX_COMBINED = (
    '$remote_addr - $remote_user [$time_local] "$request" $status '
    '$body_bytes_sent "$http_referer" "$http_user_agent"'
)


def looks_like_nginx_format(log_format: str) -> bool:
    if "$" in log_format:
        return True
    return log_format.lower() == "combined"


class BinaryIPDissector(SimpleDissector):
    """``\\xHH\\xHH\\xHH\\xHH`` -> dotted IP.  Faithful to the reference: the
    bytes are rendered as SIGNED Java bytes (String.valueOf((byte)b)), so
    values >= 0x80 print negative."""

    _PATTERN = re.compile(
        r"\\x([0-9a-fA-F][0-9a-fA-F])" * 4
    )

    def __init__(self):
        super().__init__("IP_BINARY", {"IP:": STRING_OR_LONG})

    def dissect_field(self, parsable, input_name: str, pf: ParsedField) -> None:
        value = pf.value.get_string()
        m = self._PATTERN.fullmatch(value) if value is not None else None
        if m is not None:
            octets = []
            for i in range(1, 5):
                b = hex_chars_to_byte(m.group(i)[0], m.group(i)[1])
                octets.append(str(b if b < 0x80 else b - 256))
            parsable.add_dissection(input_name, "IP", "", ".".join(octets))


class NginxHttpdLogFormatDissector(TokenFormatDissector):
    def __init__(self, log_format: Optional[str] = None):
        super().__init__(log_format)
        self.set_input_type(INPUT_TYPE)

    def set_log_format(self, log_format: str) -> None:
        if log_format.lower() == "combined":
            super().set_log_format(NGINX_COMBINED)
        else:
            super().set_log_format(log_format)

    def decode_extracted_value(self, token_name: str, value: str) -> Optional[str]:
        if value is None or value == "":
            return value
        if value == "-":
            return None
        return value

    def create_all_token_parsers(self) -> List[TokenParser]:
        return create_token_parsers()

    def create_additional_dissectors(self, parser) -> None:
        super().create_additional_dissectors(parser)
        parser.add_dissector(BinaryIPDissector())
        parser.add_dissector(
            ConvertSecondsWithMillisStringDissector("SECOND_MILLIS", "MILLISECONDS")
        )
        parser.add_dissector(
            ConvertSecondsWithMillisStringDissector(
                "TIME.EPOCH_SECOND_MILLIS", "TIME.EPOCH"
            )
        )
        parser.add_dissector(
            ConvertMillisecondsIntoMicroseconds("MILLISECONDS", "MICROSECONDS")
        )
        for module_cls in ALL_MODULES:
            parser.add_dissectors(module_cls().get_dissectors())


def create_token_parsers() -> List[TokenParser]:
    parsers: List[TokenParser] = []
    for module_cls in ALL_MODULES:
        parsers.extend(module_cls().get_token_parsers())
    return parsers


class NginxLogFormat:
    """One NGINX log_format resolved to its token list."""

    def __init__(self, log_format: str):
        self.log_format = (NGINX_COMBINED if log_format.lower() == "combined"
                           else log_format)
        # The table ends in a catch-all for unknown $variables, so no hole
        # is an unknown directive.
        self.log_format_tokens: List[Token] = tokenize(
            self.log_format, create_token_parsers(), directive=None)
        self.strftime_types: Dict[str, str] = {}

    def get_log_format(self) -> Optional[str]:
        return self.log_format


def additional_consumers() -> Dict[str, List[Tuple[str, List[Tuple[str, str]], object]]]:
    """The consumer edges an NGINX format adds to the parser: input type
    -> [(consumer, [(output type, output name)], dissector or None)]; ""
    keeps the input's name.  An upstream list's edge carries its
    dissector (the element outputs' casts decide what the device
    delivers)."""
    edges: Dict[str, List[Tuple[str, List[Tuple[str, str]], object]]] = {
        "IP_BINARY": [("binary_ip", [("IP", "")], None)],
        "SECOND_MILLIS": [("secmillis", [("MILLISECONDS", "")], None)],
        "TIME.EPOCH_SECOND_MILLIS": [("secmillis", [("TIME.EPOCH", "")], None)],
        "MILLISECONDS": [("millis_to_micros", [("MICROSECONDS", "")], None)],
    }
    for module_cls in ALL_MODULES:
        for d in module_cls().get_dissectors():
            outputs = [tuple(o.split(":", 1)) for o in d.get_possible_output()]
            edges.setdefault(d.get_input_type(), []).append(("ulist", outputs, d))
    return edges
