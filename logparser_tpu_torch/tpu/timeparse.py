"""Device-side fixed-layout timestamp parsing (the port of the reference
package's ``tpu/timeparse.py``, cut to Apache's ``[%t]``).

A :class:`~logparser_tpu_torch.dissectors.timelayout.TimeLayout` compiles
to a :class:`DeviceTimeLayout` whose every item sits at a static byte
offset of one segment: literals, fixed-width numeric fields and a
fixed-width month-name table, then the numeric UTC offset ``ZZ``
(``+HHMM`` / ``+HH:MM``) in tail position.  Localized and variable-width
names, am/pm, ``XXX`` offsets, default zones and ``%Z`` zone text are
later slices: :func:`compile_layout_for_device` returns None for them.

:func:`parse_device_timestamp` is the plain PyTorch version the
``timestamp`` kernel is held against.  Validation discipline is the
reference's: every digit is range-checked, literals and ASCII name
letters compare case-insensitively, and day-in-month honours leap years,
so the device never accepts a span the host layout rejects.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from ..dissectors.timelayout import LocaleData, TimeLayout
from .postproc import gather_span_bytes, wrap_i32

# Numeric layout fields the port models; the tail offset is 6 bytes wide.
NUM_FIELDS = ("year", "month", "day", "hour", "minute", "second")
TAIL_WIDTH = 6


@dataclass(frozen=True)
class _DevItem:
    kind: str        # lit | num | name
    offset: int      # byte offset within its segment
    width: int       # fixed width (name: the entries' common width)
    field: str = ""  # num: layout field; name: "month"
    text: bytes = b""            # lit
    table: Tuple[bytes, ...] = ()  # name: per-entry bytes
    zone_idx: Tuple[int, ...] = ()
    fold_flags: Tuple[bool, ...] = ()


@dataclass
class DeviceTimeLayout:
    """A TimeLayout resolved to byte offsets: one fixed-width segment
    then the ``offset`` (ZZ) tail."""

    segments: Tuple[Tuple[_DevItem, ...], ...]
    seg_widths: Tuple[int, ...]
    tail: str                      # always "offset" in this port
    default_offset_seconds: int    # unused with an offset tail
    locale: Optional[LocaleData] = None
    min_prefix: int = 0
    zone_table: Optional[object] = None


def compile_layout_for_device(layout: TimeLayout) -> Optional[DeviceTimeLayout]:
    """TimeLayout -> DeviceTimeLayout, or None when any item is outside
    what this port's timestamp kernel runs."""
    *body, last = layout.items or [None]
    if last != ("offset",):
        return None
    items: List[_DevItem] = []
    offset = 0
    for it in body:
        if it[0] == "lit":
            text = it[1].encode("utf-8", errors="strict")
            items.append(_DevItem("lit", offset, len(text), text=text))
        elif it[0] == "num":
            _, field, minw, maxw, space_pad = it
            if space_pad or minw != maxw or field not in NUM_FIELDS:
                return None
            items.append(_DevItem("num", offset, minw, field=field))
        elif it[0] == "text" and it[1] == "monthname":
            names = (layout.locale.months_full if it[2] == "full"
                     else layout.locale.months_short)
            table = tuple(nm.encode("utf-8") for nm in names)
            if len({len(t) for t in table}) != 1:
                return None  # variable-width names: a later slice
            items.append(_DevItem("name", offset, len(table[0]), field="month",
                                  table=table))
        else:
            return None
        offset += items[-1].width
    fields = {i.field for i in items}
    if not {"year", "month", "day"} <= fields:
        return None
    return DeviceTimeLayout(
        (tuple(items),), (offset,), "offset", 0,
        locale=layout.locale, min_prefix=offset,
    )


def _fold_byte(byte: int) -> Optional[int]:
    """ASCII-lowercased byte value, or None for non-letters (compared
    exactly)."""
    if ord("a") <= (byte | 0x20) <= ord("z"):
        return byte | 0x20
    return None


def parse_device_timestamp(
    buf: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
    dl: DeviceTimeLayout,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Execute a DeviceTimeLayout over [B] spans.

    Returns (components, ok): int32 ``year month day hour minute second
    milli offset_seconds`` (local wall clock + UTC offset) and the bool
    verdict.  Garbage spans yield the same (wrapping) component values
    as the reference."""
    B, L = buf.shape
    (seg,), (seg_w,) = dl.segments, dl.seg_widths
    if seg_w + TAIL_WIDTH > L:
        raise ValueError(f"line bucket {L} narrower than the timestamp window")
    dev = buf.device
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    ok = (end - start) >= dl.min_prefix
    # One window covers the segment and the tail (the reference's one-shot
    # extract).
    win = gather_span_bytes(buf, start, seg_w + TAIL_WIDTH)
    lower = win | 0x20

    def digits(off: int, w: int):
        d = (win[:, off:off + w].to(torch.int64) - ord("0")) & 0xFF
        good = (d <= 9).all(dim=1)
        weights = 10 ** torch.arange(w - 1, -1, -1, device=dev,
                                     dtype=torch.int64)
        return wrap_i32((d * weights).sum(dim=1)), good

    def match_entry(off: int, entry: bytes) -> torch.Tensor:
        m = torch.ones(B, dtype=torch.bool, device=dev)
        for i, byte in enumerate(entry):
            folded = _fold_byte(byte)
            if folded is not None:
                m = m & (lower[:, off + i] == folded)
            else:
                m = m & (win[:, off + i] == byte)
        return m

    comp: Dict[str, torch.Tensor] = {}
    month_from_name = None
    for it in seg:
        if it.kind == "lit":
            ok = ok & match_entry(it.offset, it.text)
        elif it.kind == "num":
            val, good = digits(it.offset, it.width)
            ok = ok & good
            comp[it.field] = val
        else:  # month names: the first matching table entry wins
            value = zeros
            matched = torch.zeros(B, dtype=torch.bool, device=dev)
            for idx in reversed(range(len(it.table))):
                entry = it.table[idx]
                m = match_entry(it.offset, entry) & (start + len(entry) <= end)
                value = torch.where(m, idx, value)
                matched = matched | m
            ok = ok & matched
            month_from_name = value + 1

    # ZZ tail: [+-]HHMM (5 bytes) or [+-]HH:MM (6 bytes).
    tail_w = end - (start + seg_w)
    sign_b = win[:, seg_w]
    sign = torch.where(sign_b == ord("-"), -1, 1).to(torch.int32)
    sign_ok = (sign_b == ord("+")) | (sign_b == ord("-"))
    oh, oh_ok = digits(seg_w + 1, 2)
    colon = tail_w == 6
    m_nc, m_nc_ok = digits(seg_w + 3, 2)
    m_c, m_c_ok = digits(seg_w + 4, 2)
    om = torch.where(colon, m_c, m_nc)
    om_ok = torch.where(colon, m_c_ok & (win[:, seg_w + 3] == ord(":")), m_nc_ok)
    ok = ok & ((tail_w == 5) | colon) & sign_ok & oh_ok & om_ok
    offset = sign * (oh * 3600 + om * 60)

    year, day = comp["year"], comp["day"]
    month = comp.get("month", month_from_name)
    hour = comp.get("hour", zeros)
    minute = comp.get("minute", zeros)
    second = comp.get("second", zeros)
    # Range checks = what datetime() construction enforces on the host.
    leap = ((year % 4 == 0) & (year % 100 != 0)) | (year % 400 == 0)
    thirty = (month == 4) | (month == 6) | (month == 9) | (month == 11)
    dim = torch.where(thirty, 30,
                      torch.where(month == 2, torch.where(leap, 29, 28), 31))
    ok = (
        ok
        & (year >= 1) & (month >= 1) & (month <= 12)
        & (day >= 1) & (day <= dim)
        & (hour <= 23) & (minute <= 59) & (second <= 60)
        & (offset.abs() < 86400)
    )
    second = second.clamp(max=59)  # leap second: SMART clamps 60 -> 59
    return (
        {
            "year": year, "month": month, "day": day, "hour": hour,
            "minute": minute, "second": second, "milli": zeros,
            "offset_seconds": offset,
        },
        ok,
    )
