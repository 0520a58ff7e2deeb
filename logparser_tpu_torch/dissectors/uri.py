"""URI dissection with real-world repair (the port's own copy of the
reference package's ``dissectors/uri.py``).

Rebuild of httpdlog/httpdlog-parser/.../dissectors/HttpUriDissector.java:
``HTTP.URI`` -> protocol/userinfo/host/port/path/query/ref (:52-63) after a
repair chain for garbage URIs (:111-199):

1. %-encode bad characters (control, space, unwise ``{}|\\^[]``` , ``<>"``)
   byte-wise over UTF-8, like commons-httpclient URIUtil.encode.
2. Normalize query separators: any '?' to '&', then the first '&' to '?&'.
3. Fix '%' signs that are not escape sequences (twice).
4. Repair almost-HTML-encoded entities and unescape HTML4.
5. Fix '=#' and '#&' artifacts; collapse multiple '#' to '~'.
6. Parse like java.net.URI (server-based authority or a null host), faking
   ``dummy-protocol://dummy.host.name`` for relative URIs.
"""
from __future__ import annotations

import html.entities
import re
from typing import FrozenSet, List, Optional, Set

from ..core.casts import Cast, NO_CASTS, STRING_ONLY, STRING_OR_LONG
from ..core.dissector import Dissector, extract_field_name
from ..core.exceptions import DissectionFailure

# Bytes that URIUtil.encode must escape: control, space, unwise, <>", 0xFF
# (HttpUriDissector.java:111-121 builds the allowed set; this is its complement).
# ENCODE_PRINTABLE is the printable subset the DEVICE tier models without the
# oracle (postproc.split_uri_fast / split_csr masks, arrow_bridge splice) —
# those masks are built from THIS constant so the device/host bit-exactness
# argument cannot drift when the set changes.
ENCODE_PRINTABLE = b' {}|\\^[]`<>"'
_ENCODE_BYTES = set(range(0x00, 0x20)) | {0x7F, 0xFF}
_ENCODE_BYTES |= set(ENCODE_PRINTABLE)

_BAD_ESCAPE_PATTERN = re.compile("%([^0-9a-fA-F]|[0-9a-fA-F][^0-9a-fA-F]|.$|$)")
_EQUALS_HASH_PATTERN = re.compile("=#")
_HASH_AMP_PATTERN = re.compile("#&")
_DOUBLE_HASH_PATTERN = re.compile("#(.*)#")
_ALMOST_HTML_ENCODED = re.compile("([^&])(#x[0-9a-fA-F][0-9a-fA-F];)")

_URI_SPLIT = re.compile(
    r"^(?:([^:/?#]+):)?(?://([^/?#]*))?([^?#]*)(?:\?([^#]*))?(?:#(.*))?$"
)
_SCHEME_RE = re.compile(r"^[A-Za-z][A-Za-z0-9+.\-]*$")
_HOST_RE = re.compile(r"^[A-Za-z0-9.\-]*$")

_NUMERIC_ENTITY = re.compile(r"&#(?:[xX]([0-9a-fA-F]+)|([0-9]+));")
_NAMED_ENTITY = re.compile(r"&([a-zA-Z][a-zA-Z0-9]*);")


# Fast-path gate for _encode_bad_uri_chars: any char that is non-ASCII
# (multi-byte under UTF-8) or in the encode set takes the byte loop;
# everything else is the identity.
_NEEDS_ENCODE_RE = re.compile(
    "[" + re.escape("".join(chr(b) for b in sorted(_ENCODE_BYTES)))
    + "\u0080-\U0010ffff]"
)


def _encode_bad_uri_chars(s: str) -> str:
    if _NEEDS_ENCODE_RE.search(s) is None:
        # Pure-ASCII input with no escapable byte: the byte loop below is
        # the identity (every byte maps to chr(byte)).
        return s
    out = []
    for b in s.encode("utf-8"):
        if b in _ENCODE_BYTES:
            out.append("%%%02X" % b)
        else:
            out.append(chr(b))
    # Re-interpret the remaining raw bytes as latin-1 passthrough; join keeps
    # high bytes as single chars, matching the Java byte-wise behavior.
    return "".join(out)


def _unescape_html4(s: str) -> str:
    """commons-lang3 unescapeHtml4: named HTML4 entities + numeric entities,
    semicolon required."""
    if "&" not in s:
        return s

    def named(m: "re.Match[str]") -> str:
        repl = html.entities.entitydefs.get(m.group(1))
        return repl if repl is not None else m.group(0)

    def numeric(m: "re.Match[str]") -> str:
        code = int(m.group(1), 16) if m.group(1) is not None else int(m.group(2))
        if code > 0x10FFFF:
            return m.group(0)
        return chr(code)

    s = _NUMERIC_ENTITY.sub(numeric, s)
    s = _NAMED_ENTITY.sub(named, s)
    return s


def _percent_decode(s: str) -> str:
    """java.net.URI decode(): %XX runs -> bytes -> UTF-8 (replace on error)."""
    if "%" not in s:
        return s
    out = []
    i = 0
    n = len(s)
    while i < n:
        c = s[i]
        if c == "%" and i + 2 < n + 1:
            run = bytearray()
            while i < n and s[i] == "%" and i + 2 < n:
                try:
                    run.append(int(s[i + 1 : i + 3], 16))
                except ValueError:
                    break
                i += 3
            if run:
                out.append(run.decode("utf-8", errors="replace"))
                continue
        out.append(c)
        i += 1
    return "".join(out)


class JavaUri:
    """Minimal java.net.URI equivalent: split + server-based authority parse."""

    __slots__ = ("scheme", "userinfo", "host", "port", "path", "raw_query", "fragment")

    def __init__(self, uri_string: str):
        m = _URI_SPLIT.match(uri_string)
        if m is None:  # the regex is total; kept for safety
            raise ValueError(f"Malformed URI: {uri_string!r}")
        scheme, authority, path, query, fragment = m.groups()

        if scheme is not None and not _SCHEME_RE.match(scheme):
            raise ValueError(f"Illegal character in scheme name: {uri_string!r}")
        for component in (path, query, fragment):
            if component and (" " in component or "#" in component):
                raise ValueError(f"Illegal character in URI: {uri_string!r}")

        self.scheme = scheme
        self.userinfo: Optional[str] = None
        self.host: Optional[str] = None
        self.port: Optional[int] = None
        if authority is not None:
            self._parse_authority(authority)
        self.path = _percent_decode(path) if path else ("" if authority is not None else path or "")
        self.raw_query = query
        self.fragment = _percent_decode(fragment) if fragment is not None else None

    def _parse_authority(self, authority: str) -> None:
        """Server-based parse; on failure the authority is registry-based and
        host/userinfo/port stay None (mirrors java.net.URI)."""
        rest = authority
        userinfo = None
        at = rest.rfind("@")
        if at != -1:
            userinfo = rest[:at]
            rest = rest[at + 1 :]
        host = rest
        port: Optional[int] = None
        if rest.startswith("["):  # IPv6 literal
            close = rest.find("]")
            if close == -1:
                return  # registry-based
            host = rest[: close + 1]
            tail = rest[close + 1 :]
            if tail.startswith(":") and tail[1:].isdigit():
                port = int(tail[1:])
            elif tail not in ("", ":"):
                return
        else:
            colon = rest.rfind(":")
            if colon != -1:
                port_str = rest[colon + 1 :]
                if port_str == "":
                    host = rest[:colon]
                elif port_str.isdigit():
                    host = rest[:colon]
                    port = int(port_str)
                else:
                    return  # not a valid port: registry-based
            if not _HOST_RE.match(host):
                return  # registry-based authority: host is null
        self.userinfo = _percent_decode(userinfo) if userinfo is not None else None
        self.host = host
        self.port = port


class HttpUriDissector(Dissector):
    INPUT_TYPE = "HTTP.URI"

    _FIELDS = {
        "protocol": STRING_ONLY,
        "userinfo": STRING_ONLY,
        "host": STRING_ONLY,
        "port": STRING_OR_LONG,
        "path": STRING_ONLY,
        "query": STRING_ONLY,
        "ref": STRING_ONLY,
    }

    def __init__(self):
        self.wanted: Set[str] = set()

    def get_input_type(self) -> str:
        return self.INPUT_TYPE

    def get_possible_output(self) -> List[str]:
        return [
            "HTTP.PROTOCOL:protocol",
            "HTTP.USERINFO:userinfo",
            "HTTP.HOST:host",
            "HTTP.PORT:port",
            "HTTP.PATH:path",
            "HTTP.QUERYSTRING:query",
            "HTTP.REF:ref",
        ]

    def prepare_for_dissect(self, input_name: str, output_name: str) -> FrozenSet[Cast]:
        name = extract_field_name(input_name, output_name)
        casts = self._FIELDS.get(name)
        if casts is None:
            return NO_CASTS
        self.wanted.add(name)
        return casts

    def get_new_instance(self) -> "Dissector":
        return HttpUriDissector()

    def dissect(self, parsable, input_name: str) -> None:
        field = parsable.get_parsable_field(self.INPUT_TYPE, input_name)
        original = field.value.get_string()
        if original is None or original == "":
            return

        uri_string = _encode_bad_uri_chars(original)

        # Normalize ?/& so the query string always starts with ?& .
        if "?" in uri_string or "&" in uri_string:
            uri_string = uri_string.replace("?", "&")
            uri_string = uri_string.replace("&", "?&", 1)

        # Fix % signs that are not escape sequences (twice: overlaps).
        # Presence gates: every pattern in this repair block requires its
        # trigger character, so clean URIs skip the regex passes.
        if "%" in uri_string:
            uri_string = _BAD_ESCAPE_PATTERN.sub(r"%25\1", uri_string)
            uri_string = _BAD_ESCAPE_PATTERN.sub(r"%25\1", uri_string)

        if "#" in uri_string:
            # Repair almost-HTML-encoded entities, then unescape HTML4.
            uri_string = _ALMOST_HTML_ENCODED.sub(r"\1&\2", uri_string)
            uri_string = _unescape_html4(uri_string)
            uri_string = _EQUALS_HASH_PATTERN.sub("=", uri_string)
            uri_string = _HASH_AMP_PATTERN.sub("&", uri_string)

            # Multiple '#': keep only the last as the fragment marker.
            while _DOUBLE_HASH_PATTERN.search(uri_string):
                uri_string = _DOUBLE_HASH_PATTERN.sub(r"~\1#", uri_string)
        else:
            uri_string = _unescape_html4(uri_string)

        is_url = True
        try:
            if uri_string[0] == "/":
                uri = JavaUri("dummy-protocol://dummy.host.name" + uri_string)
                is_url = False  # do not return the values we just faked
            else:
                uri = JavaUri(uri_string)
        except ValueError as e:
            raise DissectionFailure(
                f"Failed to parse URI >>{original}<< because of : {e}"
            ) from e

        w = self.wanted
        if "query" in w:
            parsable.add_dissection(
                input_name, "HTTP.QUERYSTRING", "query", uri.raw_query or ""
            )
        if "path" in w:
            parsable.add_dissection(input_name, "HTTP.PATH", "path", uri.path)
        if "ref" in w:
            parsable.add_dissection(input_name, "HTTP.REF", "ref", uri.fragment)

        if is_url:
            if "protocol" in w:
                parsable.add_dissection(
                    input_name, "HTTP.PROTOCOL", "protocol", uri.scheme
                )
            if "userinfo" in w:
                parsable.add_dissection(
                    input_name, "HTTP.USERINFO", "userinfo", uri.userinfo
                )
            if "host" in w:
                parsable.add_dissection(input_name, "HTTP.HOST", "host", uri.host)
            if "port" in w and uri.port is not None:
                parsable.add_dissection(input_name, "HTTP.PORT", "port", uri.port)
