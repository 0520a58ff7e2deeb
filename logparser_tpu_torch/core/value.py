"""Tri-state value union (string / int / float) with lazy cross-casts.

The port's own copy of the reference package's ``core/value.py``.

Reference behavior: parser-core/.../core/Value.java:48-87 — string->long via integer
parse (None on failure), string->double via float parse (None on failure),
double->long with round-half-up (floor(d + 0.5)), long->string/double trivially.
"""
from __future__ import annotations

import math
from typing import Optional, Union

RawValue = Union[str, int, float, None]


def _java_double_to_string(d: float) -> str:
    """Match Java's Double.toString: shortest decimal that round-trips, plain
    decimal form for 1e-3 <= |d| < 1e7, otherwise ``d.dddEn`` scientific form,
    always with at least one digit after the point."""
    if math.isnan(d):
        return "NaN"
    if math.isinf(d):
        return "Infinity" if d > 0 else "-Infinity"
    if d == 0.0:
        return "-0.0" if math.copysign(1.0, d) < 0 else "0.0"
    a = abs(d)
    if 1e-3 <= a < 1e7:
        # Python repr is also shortest-round-trip and stays in decimal form
        # (no exponent) throughout this magnitude range.
        return repr(d)
    from decimal import Decimal

    sign, digits, exp = Decimal(repr(a)).as_tuple()
    e = exp + len(digits) - 1
    mant_digits = "".join(map(str, digits)).rstrip("0") or "0"
    mant = (
        mant_digits + ".0"
        if len(mant_digits) == 1
        else mant_digits[0] + "." + mant_digits[1:]
    )
    return ("-" if d < 0 else "") + mant + "E" + str(e)


_LONG_MIN = -(2**63)
_LONG_MAX = 2**63 - 1


def _parse_java_long(s: str) -> Optional[int]:
    """Long.parseLong semantics: optional sign, decimal digits only, 64-bit range."""
    if not s:
        return None
    body = s[1:] if s[0] in "+-" else s
    if not body or not body.isascii() or not body.isdigit():
        return None
    try:
        v = int(s)
    except ValueError:
        return None
    if v < _LONG_MIN or v > _LONG_MAX:
        return None
    return v


def _parse_java_double(s: str) -> Optional[float]:
    """Double.parseDouble semantics (no underscores, no 'inf'/'nan' spellings
    beyond Java's, which log data never contains)."""
    if not s:
        return None
    t = s.strip()
    if not t or "_" in t:
        return None
    # Python accepts 'inf'/'nan' like Java accepts 'Infinity'/'NaN'; log fields
    # never legitimately carry either, so reject the textual forms Java rejects.
    low = t.lower().lstrip("+-")
    if low in ("inf", "infinity", "nan"):
        return None
    try:
        return float(t)
    except ValueError:
        return None


class Value:
    """One parsed field value; remembers which representation filled it."""

    __slots__ = ("_kind", "_v")

    def __init__(self, v: RawValue, kind: Optional[str] = None):
        if kind is None:
            if v is None or isinstance(v, str):
                kind = "STRING"
            elif isinstance(v, bool):
                raise TypeError("bool is not a valid Value payload")
            elif isinstance(v, int):
                kind = "LONG"
            elif isinstance(v, float):
                kind = "DOUBLE"
            else:
                raise TypeError(f"unsupported value type: {type(v)!r}")
        self._kind = kind
        self._v = v

    @property
    def kind(self) -> str:
        return self._kind

    def get_string(self) -> Optional[str]:
        if self._v is None:
            return None
        if self._kind == "LONG":
            return str(self._v)
        if self._kind == "DOUBLE":
            return _java_double_to_string(float(self._v))
        return self._v  # type: ignore[return-value]

    def get_long(self) -> Optional[int]:
        if self._v is None:
            return None
        if self._kind == "STRING":
            return _parse_java_long(self._v)  # type: ignore[arg-type]
        if self._kind == "DOUBLE":
            d = float(self._v)
            # Java: (long) Math.floor(d + 0.5) — NaN -> 0, +/-inf and overflow
            # clamp to Long.MAX/MIN.
            if math.isnan(d):
                return 0
            if d >= _LONG_MAX:
                return _LONG_MAX
            if d <= _LONG_MIN:
                return _LONG_MIN
            return int(math.floor(d + 0.5))
        return int(self._v)  # type: ignore[arg-type]

    def get_double(self) -> Optional[float]:
        if self._v is None:
            return None
        if self._kind == "STRING":
            return _parse_java_double(self._v)  # type: ignore[arg-type]
        return float(self._v)  # type: ignore[arg-type]

    def __repr__(self) -> str:
        return f"Value({self._kind}:{self._v!r})"

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Value)
            and other._kind == self._kind
            and other._v == self._v
        )

    def __hash__(self) -> int:
        return hash((self._kind, self._v))
