"""Cookie dissection (the port's own copy of the reference package's
``dissectors/cookies.py``, as plain functions).

- :func:`request_cookies` -- ``HTTP.COOKIES`` -> ``HTTP.COOKIE:*``: split
  on ``"; "``, names trimmed and lower-cased, values trimmed and
  URL-decoded (RequestCookieListDissector).
- :func:`response_setcookies` -- ``HTTP.SETCOOKIES`` ->
  ``HTTP.SETCOOKIE:*``: split on ``", "``, a part that ends inside its
  ``expires=`` date glued to the next (ResponseSetCookieListDissector).
- :func:`parse_attrs` -- one Set-Cookie value -> value / expires
  (seconds, and ``expires_epoch`` millis) / path / domain / comment
  (ResponseSetCookieDissector); the batch materialization delivers the
  per-cookie attribute fields through it.

The device splits (``split_csr`` in cookie mode, ``split_setcookie_csr``
in ``tpu/postproc.py`` and their kernels) reproduce the first two; the
host keeps the per-value work (trimming, URL-decoding, attributes).  The
host oracle's three dissectors (:class:`RequestCookieListDissector`,
:class:`ResponseSetCookieListDissector`,
:class:`ResponseSetCookieDissector`) deliver what these functions give.
"""
from __future__ import annotations

import datetime as _dt
import functools
import re
from typing import Callable, Dict, FrozenSet, List, Optional, Set
from zoneinfo import ZoneInfo

from ..core.casts import Cast, STRING_ONLY, STRING_OR_LONG
from ..core.dissector import Dissector, extract_field_name
from ..core.exceptions import DissectionFailure
from .timelayout import DAYS_SHORT, MONTHS_SHORT, _ZONE_ABBREVIATIONS
from .utils import resilient_url_decode

_SPLIT_BY = ", "
# len("expires=XXXXXXX"): a part whose expires= starts later than this
# many bytes before its end is cut inside the date.
_MINIMAL_EXPIRES_LENGTH = len("expires=XXXXXXX")


def request_cookies(value: str,
                    wanted: Optional[Callable[[str], bool]] = None) -> Dict[str, str]:
    """{name: value} of a Cookie header (a later name wins), only the names
    ``wanted`` accepts when it is given; raises ValueError where the
    URL-decode of a kept value does (the host fails the line)."""
    out: Dict[str, str] = {}
    if not value:
        return out
    for part in value.split("; "):
        equal_pos = part.find("=")
        if equal_pos == -1:
            name = part.strip().lower()
            if part != "" and (wanted is None or wanted(name)):
                out[name] = ""
        else:
            name = part[:equal_pos].strip().lower()
            if wanted is None or wanted(name):
                out[name] = resilient_url_decode(part[equal_pos + 1:].strip())
    return out


def _http_cookie_name(header_value: str) -> Optional[str]:
    """The cookie name of one Set-Cookie value (java.net.HttpCookie.parse's
    name, after its ``set-cookie:`` / ``set-cookie2:`` prefix); None for
    an empty name."""
    value = header_value
    if value.lower().startswith("set-cookie2:"):
        value = value[len("set-cookie2:"):]
    elif value.lower().startswith("set-cookie:"):
        value = value[len("set-cookie:"):]
    name = value.split(";", 1)[0].strip().split("=", 1)[0].strip()
    return name or None


def response_setcookies(value: str) -> Dict[str, str]:
    """{lower-cased cookie name: the whole cookie text} of a Set-Cookie
    header list (a later name wins)."""
    out: Dict[str, str] = {}
    if not value:
        return out
    previous = ""
    for part in value.split(_SPLIT_BY):
        expires_index = part.lower().find("expires=")
        if expires_index != -1 and len(part) - _MINIMAL_EXPIRES_LENGTH < expires_index:
            previous = part
            continue
        if previous:
            part = previous + _SPLIT_BY + part
            previous = ""
        name = _http_cookie_name(part)
        if name is not None:
            out[name.lower()] = part
    return out


def parse_attrs(value: str) -> dict:
    """One Set-Cookie value -> its delivered attributes: ``value`` (the
    first ';'-part's value), exact-lowercase ``expires`` (seconds) with
    ``expires_epoch`` (millis), ``path``, ``domain``, ``comment``; a later
    duplicate overwrites, anything else is ignored."""
    out: dict = {}
    for i, raw_part in enumerate(value.split(";")):
        kv = raw_part.strip().split("=", 1)
        key = kv[0].strip()
        part_value = kv[1].strip() if len(kv) == 2 else ""
        if i == 0:
            out["value"] = part_value
        elif key == "expires":
            expires = parse_expire(part_value)
            out["expires"] = expires // 1000
            out["expires_epoch"] = expires
        elif key in ("domain", "comment", "path"):
            out[key] = part_value
    return out


# The three expires layouts the reference tries in order, as items (the
# items its Java pattern compiler builds for "EEE',' dd-MMM-yyyy HH:mm:ss
# z", "EEE',' dd MMM yyyy HH:mm:ss z" and "EEE MMM dd yyyy HH:mm:ss
# 'GMT'Z"), in the default zone UTC.
_DAY = ("num", "day")
_EXPIRES_LAYOUTS = [
    [("day",), ("lit", ", "), _DAY, ("lit", "-"), ("month",), ("lit", "-"),
     ("num", "year"), ("lit", " "), ("num", "hour"), ("lit", ":"),
     ("num", "minute"), ("lit", ":"), ("num", "second"), ("lit", " "), ("zone",)],
    [("day",), ("lit", ", "), _DAY, ("lit", " "), ("month",), ("lit", " "),
     ("num", "year"), ("lit", " "), ("num", "hour"), ("lit", ":"),
     ("num", "minute"), ("lit", ":"), ("num", "second"), ("lit", " "), ("zone",)],
    [("day",), ("lit", " "), ("month",), ("lit", " "), _DAY, ("lit", " "),
     ("num", "year"), ("lit", " "), ("num", "hour"), ("lit", ":"),
     ("num", "minute"), ("lit", ":"), ("num", "second"), ("lit", " GMT"),
     ("offset",)],
]
_WIDTH = {"day": 2, "year": 4, "hour": 2, "minute": 2, "second": 2}
_ZONE_TEXT = re.compile(r"[A-Za-z_/+\-0-9]+")
_OFFSET = re.compile(r"([+-])([0-9]{2}):?([0-9]{2})")


@functools.lru_cache(maxsize=4096)
def parse_expire(text: str) -> int:
    """Epoch millis of an expires date in the first of the three layouts
    that parses it; 0 when none does (memoized: a batch repeats a few
    dates)."""
    for layout in _EXPIRES_LAYOUTS:
        try:
            return _parse(layout, text)
        except ValueError:
            continue
    return 0


def _parse(layout, s: str) -> int:
    """The reference's item-by-item timestamp parse and resolution, for
    the items above; ValueError where it raises."""
    fields: dict = {}
    pos, n = 0, len(s)
    for kind, *arg in layout:
        if kind == "lit":
            lit = arg[0]
            if s[pos:pos + len(lit)].lower() != lit.lower():
                raise ValueError(pos)
            pos += len(lit)
        elif kind == "num":
            width = _WIDTH[arg[0]]
            start = pos
            while pos < n and s[pos].isdigit() and pos - start < width:
                pos += 1
            if pos - start < width:
                raise ValueError(start)
            fields[arg[0]] = int(s[start:pos])
        elif kind in ("day", "month"):
            table = DAYS_SHORT if kind == "day" else MONTHS_SHORT
            low = s[pos:].lower()
            idx = next((i for i, name in enumerate(table)
                        if low.startswith(name.lower())), None)
            if idx is None:
                raise ValueError(pos)
            if kind == "month":
                fields["month"] = idx + 1
            pos += 3
        elif kind == "zone":
            m = _ZONE_TEXT.match(s, pos)
            zone = _resolve_zone(m.group(0)) if m else None
            if zone is None:
                raise ValueError(pos)
            fields["zone"] = zone
            pos = m.end()
        else:  # offset
            m = _OFFSET.match(s, pos)
            if not m:
                raise ValueError(pos)
            sign = -1 if m.group(1) == "-" else 1
            fields["offset"] = sign * (int(m.group(2)) * 3600 + int(m.group(3)) * 60)
            pos = m.end()
    if pos != n:
        raise ValueError(pos)
    second = 59 if fields["second"] == 60 else fields["second"]
    local = _dt.datetime(fields["year"], fields["month"], fields["day"],
                         fields["hour"], fields["minute"], second)
    wall_s = int((local - _dt.datetime(1970, 1, 1)).total_seconds())
    if "offset" in fields:
        offset = fields["offset"]
    else:
        offset = _zone_offset(fields.get("zone", "UTC"), wall_s)
    return (wall_s - offset) * 1000


@functools.lru_cache(maxsize=4096)
def _resolve_zone(name: str) -> Optional[str]:
    """Zone text -> zone id: the abbreviation table, else the name itself
    when tzdata knows it (None: unknown)."""
    zone = _ZONE_ABBREVIATIONS.get(name.upper(), name)
    try:
        ZoneInfo(zone)
    except Exception:  # noqa: BLE001 -- any unknown or unreadable zone
        return None
    return zone


def _zone_offset(zone: str, wall_s: int) -> int:
    """The zone's fold=0 UTC offset (seconds) at a wall-clock time."""
    local = _dt.datetime(1970, 1, 1) + _dt.timedelta(seconds=wall_s)
    return int(local.replace(tzinfo=ZoneInfo(zone), fold=0).utcoffset().total_seconds())


class RequestCookieListDissector(Dissector):
    """``HTTP.COOKIES`` -> ``HTTP.COOKIE:*`` (RequestCookieListDissector.java
    :77-111), through :func:`request_cookies`."""

    INPUT_TYPE = "HTTP.COOKIES"

    def __init__(self):
        self.requested: Set[str] = set()
        self.want_all = False

    def get_input_type(self) -> str:
        return self.INPUT_TYPE

    def get_possible_output(self) -> List[str]:
        return ["HTTP.COOKIE:*"]

    def prepare_for_dissect(self, input_name: str, output_name: str) -> FrozenSet[Cast]:
        self.requested.add(extract_field_name(input_name, output_name))
        return STRING_ONLY

    def prepare_for_run(self) -> None:
        self.want_all = "*" in self.requested

    def get_new_instance(self) -> "Dissector":
        return RequestCookieListDissector()

    def _wanted(self, name: str) -> bool:
        return self.want_all or name in self.requested

    def dissect(self, parsable, input_name: str) -> None:
        field = parsable.get_parsable_field(self.INPUT_TYPE, input_name)
        try:
            cookies = request_cookies(field.value.get_string(), self._wanted)
        except ValueError as e:
            raise DissectionFailure(str(e)) from e
        for name, value in cookies.items():
            parsable.add_dissection(input_name, "HTTP.COOKIE", name, value)


class ResponseSetCookieListDissector(Dissector):
    """``HTTP.SETCOOKIES`` -> ``HTTP.SETCOOKIE:*``
    (ResponseSetCookieListDissector.java:78-115), through
    :func:`response_setcookies`."""

    INPUT_TYPE = "HTTP.SETCOOKIES"

    def __init__(self):
        self.requested: Set[str] = set()
        self.want_all = False

    def get_input_type(self) -> str:
        return self.INPUT_TYPE

    def get_possible_output(self) -> List[str]:
        return ["HTTP.SETCOOKIE:*"]

    def prepare_for_dissect(self, input_name: str, output_name: str) -> FrozenSet[Cast]:
        self.requested.add(extract_field_name(input_name, output_name))
        return STRING_ONLY

    def prepare_for_run(self) -> None:
        self.want_all = "*" in self.requested

    def get_new_instance(self) -> "Dissector":
        return ResponseSetCookieListDissector()

    def dissect(self, parsable, input_name: str) -> None:
        field = parsable.get_parsable_field(self.INPUT_TYPE, input_name)
        for name, part in response_setcookies(field.value.get_string()).items():
            if self.want_all or name in self.requested:
                parsable.add_dissection(input_name, "HTTP.SETCOOKIE", name, part)


class ResponseSetCookieDissector(Dissector):
    """One Set-Cookie value -> value / expires (STRING seconds and
    TIME.EPOCH millis) / path / domain / comment
    (ResponseSetCookieDissector.java:63-105), through :func:`parse_attrs`."""

    INPUT_TYPE = "HTTP.SETCOOKIE"

    def __init__(self):
        self.requested: Set[str] = set()

    def get_input_type(self) -> str:
        return self.INPUT_TYPE

    def get_possible_output(self) -> List[str]:
        return ["STRING:value", "STRING:expires", "TIME.EPOCH:expires",
                "STRING:path", "STRING:domain", "STRING:comment"]

    def prepare_for_dissect(self, input_name: str, output_name: str) -> FrozenSet[Cast]:
        name = extract_field_name(input_name, output_name)
        self.requested.add(name)
        return STRING_OR_LONG if name == "expires" else STRING_ONLY

    def get_new_instance(self) -> "Dissector":
        return ResponseSetCookieDissector()

    def dissect(self, parsable, input_name: str) -> None:
        field = parsable.get_parsable_field(self.INPUT_TYPE, input_name)
        value = field.value.get_string()
        if not value:
            return
        attrs = parse_attrs(value)
        parsable.add_dissection(input_name, "STRING", "value", attrs["value"])
        if "expires" in attrs:
            parsable.add_dissection(input_name, "STRING", "expires", attrs["expires"])
            parsable.add_dissection(input_name, "TIME.EPOCH", "expires",
                                    attrs["expires_epoch"])
        for key in ("domain", "comment", "path"):
            if key in attrs:
                parsable.add_dissection(input_name, "STRING", key, attrs[key])
