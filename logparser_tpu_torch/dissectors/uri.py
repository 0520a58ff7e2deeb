"""The URI repair helpers the device URI split and the host fix
materializer need (the port's own copy of part of the reference package's
``dissectors/uri.py``, the rebuild of HttpUriDissector.java).

- :data:`ENCODE_PRINTABLE`: the printable bytes URIUtil.encode escapes;
  the ``uri_split`` / ``csr_split`` kernels and their plain versions flag
  them (fix / decode rows) rather than send the line to the host.
- :func:`_encode_bad_uri_chars`, :data:`_BAD_ESCAPE_PATTERN` and
  :func:`_percent_decode`: the encode, ``%``-repair and java.net.URI
  decode steps that ``BatchResult`` applies to one flagged sub-span.
"""
from __future__ import annotations

import re

# Bytes that URIUtil.encode must escape: control, space, unwise, <>", 0xFF
# (HttpUriDissector.java:111-121 builds the allowed set; this is its
# complement).  ENCODE_PRINTABLE is the printable subset the device tier
# models without the host.
ENCODE_PRINTABLE = b' {}|\\^[]`<>"'
_ENCODE_BYTES = set(range(0x00, 0x20)) | {0x7F, 0xFF}
_ENCODE_BYTES |= set(ENCODE_PRINTABLE)

_BAD_ESCAPE_PATTERN = re.compile("%([^0-9a-fA-F]|[0-9a-fA-F][^0-9a-fA-F]|.$|$)")


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
