"""Device-side timestamp parsing (the port of the reference package's
``tpu/timeparse.py``).

A :class:`~logparser_tpu_torch.dissectors.timelayout.TimeLayout` compiles
to a :class:`DeviceTimeLayout`: runs of fixed-width items (literals,
numeric fields, name tables whose entries share one width) form
segments at static byte offsets; a name table with entries of different
widths (English ``%B``: "May" against "September"), and ``%Z`` zone text,
each form a segment of their own that advances a per-row cursor by the
matched entry.  A numeric UTC offset (``offset`` = ``ZZ`` / ``%z``,
``offset_colon`` = ``XXX``) may end the layout; without one the layout's
default zone applies, which must be a fixed offset.  Zone text resolves
through the tzdata transition tables of
:mod:`~logparser_tpu_torch.dissectors.tztable` once the wall clock is
known.

:func:`parse_device_timestamp` is the plain PyTorch version of the whole
stage.  The kernels split it in two: ``timestamp`` runs
:func:`parse_timestamp_fields` (everything up to the zone's wall minute)
and, for zone-text layouts, ``zone_lookup`` runs
:func:`resolve_zone_offset`.  Validation discipline is the reference's:
every digit is range-checked, literals and ASCII name letters compare
case-insensitively (region ids exactly), day-in-month honours leap
years, so the device never accepts a span the host layout rejects.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from ..dissectors.timelayout import _ZONE_ABBREVIATIONS, LocaleData, TimeLayout
from .postproc import gather_span_bytes

# Zones that are a fixed UTC offset year-round: a layout defaulting to
# one of these still compiles to constant offset arithmetic.
_FIXED_OFFSET_ZONES = {"UTC": 0, "GMT": 0, "Z": 0, "UT": 0, "Etc/UTC": 0}

# Numeric layout fields the device models (the kernel's field indices).
NUM_FIELDS = ("year", "year2", "month", "day", "hour", "clock_hour",
              "hour12", "minute", "second", "milli")
TAIL_WIDTH = 6   # the offset tail's window: [+-]HH:MM


@dataclass(frozen=True)
class _DevItem:
    kind: str        # lit | num | name | ampm | zone
    offset: int      # byte offset within its segment
    width: int       # fixed width (name / ampm / zone: the widest entry, zone + 1)
    field: str = ""  # num: layout field; name: "month" | "dayofweek"
    text: bytes = b""            # lit
    table: Tuple[bytes, ...] = ()  # name / ampm / zone: per-entry bytes
    # zone only: each entry's index into the layout's ZoneDeviceTable, and
    # whether it matches case-folded (abbreviations) or exactly (region
    # ids, like zoneinfo's file paths).
    zone_idx: Tuple[int, ...] = ()
    fold_flags: Tuple[bool, ...] = ()


@dataclass
class DeviceTimeLayout:
    """A TimeLayout resolved to per-segment byte offsets."""

    segments: Tuple[Tuple[_DevItem, ...], ...]
    seg_widths: Tuple[int, ...]    # fixed byte width per segment; -1 = variable
    tail: str                      # "" | "offset" | "offset_colon"
    default_offset_seconds: int    # applied when tail == "" and no zone item
    locale: Optional[LocaleData] = None
    min_prefix: int = 0            # lower bound of the pre-tail width
    zone_table: Optional[object] = None   # tztable.ZoneDeviceTable of a %Z layout

    def one_shot(self, L: int) -> bool:
        """One window covers a single fixed segment and the tail (when it
        fits the line bucket); otherwise each segment, and the tail at the
        final cursor, gathers its own window."""
        return (len(self.segments) == 1 and self.seg_widths[0] >= 0
                and self.seg_widths[0] + (TAIL_WIDTH if self.tail else 0) <= L)

    def windows(self) -> Tuple[int, ...]:
        """Each segment's window width when it gathers its own."""
        return tuple(w if w >= 0 else max(i.width for i in seg)
                     for seg, w in zip(self.segments, self.seg_widths))


def zone_vocabulary(zone_table) -> List[Tuple[bytes, int, bool]]:
    """(entry bytes, zone index, case-folded) of a zone table's
    vocabulary: the abbreviations first (the host checks them before
    treating a token as a region id), then every region id."""
    zone_of = {name: i for i, name in enumerate(zone_table.zones)}
    entries = [(abbr.encode(), zone_of[target], True)
               for abbr, target in _ZONE_ABBREVIATIONS.items() if target in zone_of]
    entries += [(name.encode(), zi, False) for name, zi in zone_of.items()]
    return entries


def compile_layout_for_device(layout: TimeLayout) -> Optional[DeviceTimeLayout]:
    """TimeLayout -> DeviceTimeLayout, or None when any item is outside the
    device subset (the field then stays with the host)."""
    loc = layout.locale
    segments: List[Tuple[_DevItem, ...]] = []
    seg_widths: List[int] = []
    cur: List[_DevItem] = []
    offset = 0
    min_prefix = 0
    tail = ""
    zone_table = None
    n = len(layout.items)

    def close_segment():
        nonlocal cur, offset
        if cur:
            segments.append(tuple(cur))
            seg_widths.append(offset)
        cur = []
        offset = 0

    def name_tables(field: str, style: str):
        if field == "monthname":
            return "month", loc.months_full if style == "full" else loc.months_short
        if field == "dayname":
            return "dayofweek", loc.days_full if style == "full" else loc.days_short
        return "ampm", list(loc.ampm)

    for idx, it in enumerate(layout.items):
        kind = it[0]
        if kind == "lit":
            text = it[1].encode("utf-8", errors="strict")
            cur.append(_DevItem("lit", offset, len(text), text=text))
            offset += len(text)
            min_prefix += len(text)
        elif kind == "num":
            _, field, minw, maxw, space_pad = it
            if space_pad or minw != maxw or field not in NUM_FIELDS:
                return None
            cur.append(_DevItem("num", offset, minw, field=field))
            offset += minw
            min_prefix += minw
        elif kind == "text":
            _, field, style = it
            key, names = name_tables(field, style)
            table = tuple(nm.encode("utf-8") for nm in names)
            widths = {len(t) for t in table}
            w = max(widths)
            dev_kind = "ampm" if key == "ampm" else "name"
            if len(widths) == 1:
                cur.append(_DevItem(dev_kind, offset, w, field=key, table=table))
                offset += w
                min_prefix += w
            else:
                # Variable entry widths: a segment of its own, per-row advance.
                close_segment()
                segments.append((_DevItem(dev_kind, 0, w, field=key, table=table),))
                seg_widths.append(-1)
                min_prefix += min(widths)
        elif kind in ("offset", "offset_colon"):
            if idx != n - 1:
                return None   # a variable width is only decodable at the tail
            tail = kind
        elif kind == "zonetext":
            # %Z: the zone token is consumed greedily over [A-Za-z0-9_/+-]
            # on the host, so an entry also needs the byte after it outside
            # that class ("UTCX" is not UTC): the +1 width is that peek.
            from ..dissectors.tztable import default_zone_table

            zone_table = default_zone_table()
            entries = zone_vocabulary(zone_table)
            if not entries:
                return None
            table = tuple(e[0] for e in entries)
            close_segment()
            segments.append((_DevItem(
                "zone", 0, max(len(t) for t in table) + 1, field="zone",
                table=table, zone_idx=tuple(e[1] for e in entries),
                fold_flags=tuple(e[2] for e in entries),
            ),))
            seg_widths.append(-1)
            min_prefix += min(len(t) for t in table)
        else:
            return None
    close_segment()

    default_offset = 0
    if not tail and zone_table is None:
        zone = layout.default_zone
        if zone is not None and zone not in _FIXED_OFFSET_ZONES:
            return None   # a DST default zone needs tzdata per row: host
        default_offset = _FIXED_OFFSET_ZONES.get(zone or "UTC", 0)

    flat = [i for seg in segments for i in seg]
    fields = {i.field for i in flat if i.kind == "num"}
    has_month = "month" in fields or any(
        i.kind == "name" and i.field == "month" for i in flat)
    if not (("year" in fields or "year2" in fields) and has_month and "day" in fields):
        return None   # an incomplete date resolves on the host
    return DeviceTimeLayout(
        tuple(segments), tuple(seg_widths), tail, default_offset,
        locale=loc, min_prefix=min_prefix, zone_table=zone_table,
    )


# ---------------------------------------------------------------------------
# Execution (plain PyTorch)
# ---------------------------------------------------------------------------


def _fold_byte(byte: int) -> Optional[int]:
    """ASCII-lowercased byte value, or None for non-letters (compared
    exactly)."""
    if ord("a") <= (byte | 0x20) <= ord("z"):
        return byte | 0x20
    return None


def _zone_char(b: torch.Tensor) -> torch.Tensor:
    """Bytes the host's greedy zone token [A-Za-z0-9_/+-] continues over."""
    lo = b | 0x20
    return (((lo >= ord("a")) & (lo <= ord("z"))) | ((b >= ord("0")) & (b <= ord("9")))
            | (b == ord("_")) | (b == ord("/")) | (b == ord("+")) | (b == ord("-")))


def _digits(win: torch.Tensor, off: int, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    d = (win[:, off:off + w].to(torch.int32) - ord("0")) & 0xFF   # uint8 wrap
    weights = 10 ** torch.arange(w - 1, -1, -1, device=win.device, dtype=torch.int32)
    return (d * weights).sum(dim=1, dtype=torch.int32), (d <= 9).all(dim=1)


def _match(win: torch.Tensor, lower: torch.Tensor, off: int, entry: bytes,
           fold: bool = True) -> torch.Tensor:
    m = torch.ones(win.shape[0], dtype=torch.bool, device=win.device)
    for i, byte in enumerate(entry):
        folded = _fold_byte(byte) if fold else None
        if folded is not None:
            m = m & (lower[:, off + i] == folded)
        else:
            m = m & (win[:, off + i] == byte)
    return m


def parse_timestamp_fields(
    buf: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
    dl: DeviceTimeLayout,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Everything of :func:`parse_device_timestamp` up to the zone lookup.

    Returns (components, ok) with int32 ``year month day hour minute
    second milli offset_seconds``.  For a zone-text layout the components
    also hold ``zone_idx`` and ``minutes`` (the wall clock in minutes
    since the epoch, -1 outside 1970..2096), ``offset_seconds`` is the
    layout's tail or default offset, and ``ok`` lacks the zone's verdict
    and the offset range check (see :func:`resolve_zone_offset`)."""
    B, L = buf.shape
    if any(w > L for w in dl.windows()):
        raise ValueError(f"line bucket {L} narrower than a timestamp segment")
    dev = buf.device
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    ok = (end - start) >= dl.min_prefix
    cursor = start
    comp: Dict[str, torch.Tensor] = {}

    one_shot = dl.one_shot(L)
    shared = (gather_span_bytes(buf, cursor, dl.seg_widths[0] + (TAIL_WIDTH if dl.tail else 0))
              if one_shot else None)
    month_from_name = None
    for seg, seg_w, win_w in zip(dl.segments, dl.seg_widths, dl.windows()):
        b = shared if one_shot else gather_span_bytes(buf, cursor, win_w)
        lower = b | 0x20
        for it in seg:
            if it.kind == "lit":
                ok = ok & _match(b, lower, it.offset, it.text)
            elif it.kind == "num":
                val, good = _digits(b, it.offset, it.width)
                ok = ok & good
                comp[it.field] = val
            else:
                # Table order: the first match wins (reversed overwrite).
                value, wsel = zeros, zeros
                matched = torch.zeros(B, dtype=torch.bool, device=dev)
                for idx in reversed(range(len(it.table))):
                    entry = it.table[idx]
                    fold = it.fold_flags[idx] if it.kind == "zone" else True
                    m = _match(b, lower, it.offset, entry, fold) & (cursor + len(entry) <= end)
                    if it.kind == "zone":
                        m = m & ~_zone_char(b[:, it.offset + len(entry)])
                    value = torch.where(m, idx, value)
                    wsel = torch.where(m, len(entry), wsel)
                    matched = matched | m
                ok = ok & matched
                if it.kind == "zone":
                    zone_idx = torch.tensor(it.zone_idx, dtype=torch.int32, device=dev)
                    comp["zone_idx"] = zone_idx[value.to(torch.int64)]
                elif it.kind == "ampm":
                    comp["ampm"] = value
                elif it.field == "month":
                    month_from_name = value + 1
                if seg_w < 0:
                    cursor = cursor + wsel
        if seg_w >= 0:
            cursor = cursor + seg_w

    tail_w = end - cursor
    if dl.tail:
        b = shared[:, dl.seg_widths[0]:] if one_shot else gather_span_bytes(
            buf, cursor, TAIL_WIDTH)
        sign_b = b[:, 0]
        sign = torch.where(sign_b == ord("-"), -1, 1).to(torch.int32)
        sign_ok = (sign_b == ord("+")) | (sign_b == ord("-"))
        oh, oh_ok = _digits(b, 1, 2)
        if dl.tail == "offset":
            # ZZ: [+-]HHMM (5 bytes) or [+-]HH:MM (6 bytes).
            colon = tail_w == 6
            m_nc, m_nc_ok = _digits(b, 3, 2)
            m_c, m_c_ok = _digits(b, 4, 2)
            om = torch.where(colon, m_c, m_nc)
            om_ok = torch.where(colon, m_c_ok & (b[:, 3] == ord(":")), m_nc_ok)
            ok = ok & ((tail_w == 5) | colon) & sign_ok & oh_ok & om_ok
            comp["offset_seconds"] = sign * (oh * 3600 + om * 60)
        else:
            # XXX: 'Z' (1 byte) or [+-]HH:MM (6 bytes).
            is_z = (tail_w == 1) & ((b[:, 0] | 0x20) == ord("z"))
            om, om_ok = _digits(b, 4, 2)
            full_ok = (tail_w == 6) & sign_ok & oh_ok & om_ok & (b[:, 3] == ord(":"))
            ok = ok & (is_z | full_ok)
            comp["offset_seconds"] = torch.where(is_z, 0, sign * (oh * 3600 + om * 60)
                                                 ).to(torch.int32)
    else:
        ok = ok & (tail_w == 0)
        comp["offset_seconds"] = torch.full((B,), dl.default_offset_seconds,
                                            dtype=torch.int32, device=dev)

    # Resolve the components (the host's SMART resolver).
    year = comp["year"] if "year" in comp else 2000 + comp["year2"]
    month = comp.get("month", month_from_name)
    day = comp["day"]
    hour = comp.get("hour")
    if hour is None and "clock_hour" in comp:
        ch = comp["clock_hour"]
        ok = ok & (ch <= 24)   # 0 and 24 both mean midnight; 25+ is invalid
        hour = torch.where(ch == 24, 0, ch)
    if hour is None and "hour12" in comp:
        hour = (comp["hour12"] % 12) + 12 * comp.get("ampm", zeros)
    if hour is None:
        hour = zeros
    minute = comp.get("minute", zeros)
    second = comp.get("second", zeros)
    milli = comp.get("milli", zeros)

    out = {"year": year, "month": month, "day": day, "hour": hour,
           "minute": minute, "second": second, "milli": milli,
           "offset_seconds": comp["offset_seconds"]}
    zone = dl.zone_table is not None and "zone_idx" in comp
    if zone:
        out["zone_idx"] = comp["zone_idx"]
        out["minutes"] = wall_minutes(year, month, day, hour, minute)

    # Range checks = what datetime() construction enforces on the host.
    leap = ((year % 4 == 0) & (year % 100 != 0)) | (year % 400 == 0)
    thirty = (month == 4) | (month == 6) | (month == 9) | (month == 11)
    dim = torch.where(thirty, 30, torch.where(month == 2, torch.where(leap, 29, 28), 31))
    ok = (ok & (year >= 1) & (month >= 1) & (month <= 12) & (day >= 1) & (day <= dim)
          & (hour <= 23) & (minute <= 59) & (second <= 60) & (milli <= 999))
    if not zone:
        # datetime.timezone only admits offsets strictly inside +-24h.
        ok = ok & (out["offset_seconds"].abs() < 86400)
    out["second"] = second.clamp(max=59)   # leap second: SMART clamps 60 -> 59
    return out, ok


def wall_minutes(year, month, day, hour, minute) -> torch.Tensor:
    """Wall-clock minutes since the epoch (days-from-civil, proleptic
    Gregorian); -1 for years outside [1970, 2096], which leave the zone
    tables' window."""
    y = year.to(torch.int64)
    m = month.to(torch.int64)
    yy = y - (m <= 2).to(torch.int64)
    era = torch.div(yy, 400, rounding_mode="floor")
    yoe = yy - era * 400
    doy = torch.div(153 * (m + torch.where(m > 2, -3, 9)) + 2, 5,
                    rounding_mode="floor") + day - 1
    doe = yoe * 365 + torch.div(yoe, 4, rounding_mode="floor") \
        - torch.div(yoe, 100, rounding_mode="floor") + doy
    days = era * 146097 + doe - 719468
    in_years = (year >= 1970) & (year <= 2096)
    return torch.where(in_years, days * 1440 + hour * 60 + minute, -1).to(torch.int32)


def resolve_zone_offset(zone_table, zone_idx: torch.Tensor, minutes: torch.Tensor,
                        ok: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The zone-text tail of :func:`parse_device_timestamp`: the offset at
    the wall minute through the tzdata tables, and ``ok`` narrowed by the
    zone's window and the +-24h offset check."""
    off, zok = zone_table.lookup(zone_idx, minutes)
    return off, ok & zok & (off.abs() < 86400)


def parse_device_timestamp(
    buf: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
    dl: DeviceTimeLayout,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Execute a DeviceTimeLayout over [B] spans.

    Returns (components, ok): int32 ``year month day hour minute second
    milli offset_seconds`` (local wall clock + UTC offset) and the bool
    verdict.  Garbage spans yield the same (wrapping) component values
    as the reference."""
    comp, ok = parse_timestamp_fields(buf, start, end, dl)
    if "zone_idx" in comp:
        comp["offset_seconds"], ok = resolve_zone_offset(
            dl.zone_table, comp.pop("zone_idx"), comp.pop("minutes"), ok)
    return comp, ok
