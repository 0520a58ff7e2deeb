"""URL decoding with Java-exact semantics (the port's own copy of
:func:`resilient_url_decode` and its helpers from the reference package's
``dissectors/utils.py``, the rebuild of Utils.java:38-65).

Tolerant URL decoding that survives chopped %-escapes and the rejected
``%uXXXX`` encoding, via the UTF-16 re-encode trick: every ``%hh`` becomes
``%00%hh`` and ``%uABCD`` becomes ``%AB%CD``, then the whole string is
URL-decoded as UTF-16.  Malformed interior escapes raise ValueError (Java:
IllegalArgumentException from URLDecoder), which callers catch per field.

:func:`decode_apache_httpd_log_value` (Utils.java:147-201) is the inverse
of Apache HTTPD's ap_escape_logitem -- ``\\"``, ``\\\\``, C-style whitespace
escapes and ``\\xhh`` -- with the Java ``(char)(byte)`` sign-extension quirk:
bytes >= 0x80 become U+FF80..U+FFFF, not U+0080..U+00FF.
"""
from __future__ import annotations

import re
from typing import Optional

_VALID_STANDARD = re.compile("%([0-9A-Fa-f]{2})")
_CHOPPED_STANDARD = re.compile("%[0-9A-Fa-f]?$")
_VALID_NON_STANDARD = re.compile("%u([0-9A-Fa-f][0-9A-Fa-f])([0-9A-Fa-f][0-9A-Fa-f])")
_CHOPPED_NON_STANDARD = re.compile("%u[0-9A-Fa-f]{0,3}$")

_HEX = "0123456789abcdef"


def hex_chars_to_byte(c1: str, c2: str) -> int:
    """Two hex characters -> byte value 0..255; ValueError on non-hex."""
    hi = _HEX.find(c1.lower())
    lo = _HEX.find(c2.lower())
    if hi < 0:
        raise ValueError(f"URLDecoder: Illegal hex characters (char 1): '{c1}'")
    if lo < 0:
        raise ValueError(f"URLDecoder: Illegal hex characters (char 2): '{c2}'")
    return (hi << 4) | lo


def _decode_utf16_bytes(b: bytes) -> str:
    """Java ``new String(bytes, "UTF-16")``: BOM-sniffing, big-endian default,
    malformed input replaced with U+FFFD."""
    if b.startswith(b"\xfe\xff"):
        return b[2:].decode("utf-16-be", errors="replace")
    if b.startswith(b"\xff\xfe"):
        return b[2:].decode("utf-16-le", errors="replace")
    return b.decode("utf-16-be", errors="replace")


def _url_decode_utf16(s: str) -> str:
    """java.net.URLDecoder.decode(s, "UTF-16"): '+' -> ' '; each maximal run of
    ``%XX`` escapes is collected into bytes and decoded as one UTF-16 string;
    malformed/incomplete escapes raise ValueError."""
    out = []
    i = 0
    n = len(s)
    while i < n:
        c = s[i]
        if c == "+":
            out.append(" ")
            i += 1
        elif c == "%":
            run = bytearray()
            while i < n and s[i] == "%":
                hex2 = s[i + 1 : i + 3]
                if len(hex2) != 2:
                    raise ValueError(
                        "URLDecoder: Incomplete trailing escape (%) pattern"
                    )
                try:
                    run.append(int(hex2, 16))
                except ValueError:
                    raise ValueError(
                        f'URLDecoder: Illegal hex characters in escape (%) pattern : "{hex2}"'
                    ) from None
                i += 3
            out.append(_decode_utf16_bytes(bytes(run)))
        else:
            out.append(c)
            i += 1
    return "".join(out)


def resilient_url_decode(input_str: str) -> str:
    cooked = input_str
    if "%" in cooked:
        # Transform all existing UTF-8 standard escapes into UTF-16 escapes.
        cooked = _VALID_STANDARD.sub("%00%\\1", cooked)
        # Discard a chopped encoded char at the end of the line.
        cooked = _CHOPPED_STANDARD.sub("", cooked)
        if "%u" in cooked:
            cooked = _VALID_NON_STANDARD.sub("%\\1%\\2", cooked)
            cooked = _CHOPPED_NON_STANDARD.sub("", cooked)
    return _url_decode_utf16(cooked)


def decode_apache_httpd_log_value(input_str: Optional[str]) -> Optional[str]:
    if input_str is None or input_str == "":
        return input_str
    if "\\" not in input_str:
        return input_str

    out = []
    i = 0
    n = len(input_str)
    while i < n:
        chr_ = input_str[i]
        if chr_ == "\\":
            i += 1
            chr_ = input_str[i]  # IndexError mirrors Java's StringIndexOutOfBounds
            if chr_ in ('"', "\\"):
                out.append(chr_)
            elif chr_ == "b":
                out.append("\b")
            elif chr_ == "n":
                out.append("\n")
            elif chr_ == "r":
                out.append("\r")
            elif chr_ == "t":
                out.append("\t")
            elif chr_ == "v":
                out.append("\x0b")
            elif chr_ == "x":
                b = hex_chars_to_byte(input_str[i + 1], input_str[i + 2])
                i += 2
                # Java appends (char)(byte)b — sign-extension maps >=0x80
                # to U+FF80..U+FFFF.
                out.append(chr(b if b < 0x80 else 0xFF00 | b))
            else:
                # Shouldn't happen; append unmodified.
                out.append("\\")
                out.append(chr_)
        else:
            out.append(chr_)
        i += 1
    return "".join(out)
