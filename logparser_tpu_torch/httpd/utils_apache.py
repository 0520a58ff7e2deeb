"""Apache per-value decode applied by the format dissector.

The port's own copy of the reference package's ``httpd/utils_apache.py``.

Reference behavior: ApacheHttpdLogFormatDissector.java:170-198 —
``-`` means "not specified" and becomes null.  NOTE: the reference then compares
the *value* (not the token name) against "request.firstline"/"request.header."/
"response.header." before applying the ``\\xhh`` unescape, so in practice the
unescape never fires (EdgeCasesTest expects the UNDECODED ``\\x16\\x03\\x01``
value).  We replicate that observable behavior exactly for bit-exactness.
"""
from __future__ import annotations

from typing import Optional

from ..dissectors.utils import decode_apache_httpd_log_value


def decode_extracted_apache_value(token_name: str, value: str) -> Optional[str]:
    if value is None or value == "":
        return value
    if value == "-":
        return None
    # Faithful replication of the reference's condition, which tests `value`
    # where it plainly meant `token_name` (upstream bug kept for bit-exactness).
    if (
        value == "request.firstline"
        or value.startswith("request.header.")
        or value.startswith("response.header.")
    ):
        return decode_apache_httpd_log_value(value)
    return value
