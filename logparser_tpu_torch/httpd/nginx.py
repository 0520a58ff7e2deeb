"""The NGINX ``$variable`` table (the port's copy of the reference
package's ``httpd/nginx.py``, cut to what the device compiler and plan
resolution read).

The variable table is assembled from six pluggable modules
(``nginx_modules``), ``combined`` names the NGINX combined format, and a
lone ``-`` decodes to null (the device's CLF-dash rule on direct token
spans).  The format's additional dissectors appear here as the consumer
edges they add to plan resolution: ``SECOND_MILLIS`` -> ``MILLISECONDS``
and ``TIME.EPOCH_SECOND_MILLIS`` -> ``TIME.EPOCH`` (seconds with
milliseconds, the ``secmillis`` plan), ``MILLISECONDS`` ->
``MICROSECONDS`` (x 1000), ``IP_BINARY`` -> ``IP`` (the escaped binary
address) and the upstream lists' indexed elements.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..dissectors.tokenformat import Token, TokenParser, tokenize
from .nginx_modules import ALL_MODULES

NGINX_COMBINED = (
    '$remote_addr - $remote_user [$time_local] "$request" $status '
    '$body_bytes_sent "$http_referer" "$http_user_agent"'
)


def looks_like_nginx_format(log_format: str) -> bool:
    if "$" in log_format:
        return True
    return log_format.lower() == "combined"


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
