"""tzdata -> device transition tables for %Z zone text (the port's own
copy of the reference package's ``dissectors/tztable.py``).

Each zone of the device vocabulary becomes a wall-clock transition table
under ``fold=0`` semantics (PEP 495): around a UTC transition at ``t``
from offset ``o_prev`` to ``o_new`` the offset of a naive local time
switches exactly at local ``t + max(o_prev, o_new)`` -- ambiguous times
take the pre-transition offset, gap times extrapolate with it.

Wall minutes span [epoch, epoch + 2^26 min, about year 2097]; a zone whose
TZif footer carries an active DST rule is exact only up to its last
explicit transition (about 2037).  Rows outside a zone's window, before
1970 or with a zone outside the vocabulary are not device-valid: they go
to ``needs_host``.  At most 63 zones, so ``(zone, minute)`` packs into
one uint32 key.

The port reads its tables from ``tz_wall_tables.json`` in this
directory, a snapshot of the 63 default zones' wall tables written by
``python -m logparser_tpu_torch.tools.tz_snapshot`` (:func:`read_tzif`,
:func:`wall_table` and the zoneinfo self-check below).  The card's
machine may hold no tzdata; the snapshot gives it the same table as the
CPU.  :meth:`ZoneDeviceTable.lookup` is the plain PyTorch version of the
``zone_lookup`` kernel (``csrc/zone_lookup.cu``).
"""
from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# Minutes per zone segment of the packed uint32 key space: 1970..2097.
SPAN_MINUTES = 1 << 26

# Bias added to offset seconds in the packed [T, 2] table (key, offset +
# bias): UTC offsets span [-12h, +14h], so +2^17 keeps them non-negative.
_OFFSET_BIAS = 1 << 17

# Canonical zones the abbreviation table maps into
# (timelayout._ZONE_ABBREVIATIONS values).
_ABBREVIATION_TARGETS = [
    "UTC", "CET", "MET", "WET", "EET",
    "EST5EDT", "CST6CDT", "MST7MDT", "PST8PDT",
]

# The default region-id vocabulary: the canonical targets plus widespread
# region ids (under 64: the uint32 key packing).
DEFAULT_DEVICE_ZONES = _ABBREVIATION_TARGETS + [
    "Etc/UTC", "GMT",
    "America/New_York", "America/Chicago", "America/Denver",
    "America/Los_Angeles", "America/Phoenix", "America/Anchorage",
    "America/Toronto", "America/Mexico_City", "America/Sao_Paulo",
    "America/Argentina/Buenos_Aires",
    "Europe/London", "Europe/Dublin", "Europe/Lisbon", "Europe/Paris",
    "Europe/Berlin", "Europe/Madrid", "Europe/Rome", "Europe/Amsterdam",
    "Europe/Brussels", "Europe/Zurich", "Europe/Vienna", "Europe/Prague",
    "Europe/Warsaw", "Europe/Stockholm", "Europe/Oslo",
    "Europe/Helsinki", "Europe/Athens",
    "Europe/Bucharest", "Europe/Istanbul", "Europe/Moscow", "Europe/Kyiv",
    "Asia/Tokyo", "Asia/Shanghai", "Asia/Hong_Kong", "Asia/Singapore",
    "Asia/Seoul", "Asia/Taipei", "Asia/Kolkata", "Asia/Karachi",
    "Asia/Dubai", "Asia/Jerusalem", "Asia/Bangkok", "Asia/Jakarta",
    "Asia/Manila",
    "Australia/Sydney", "Australia/Melbourne", "Australia/Perth",
    "Pacific/Auckland",
    "Africa/Cairo", "Africa/Johannesburg", "Africa/Lagos",
    "Africa/Nairobi",
]
assert len(DEFAULT_DEVICE_ZONES) < 64, "uint32 key packing caps zones at 63"

SNAPSHOT = Path(__file__).resolve().parent / "tz_wall_tables.json"

WallTable = Tuple[np.ndarray, np.ndarray, int]   # bounds, offsets, valid_until


# ---------------------------------------------------------------------------
# tzdata -> wall tables (the snapshot tool's side)
# ---------------------------------------------------------------------------


def _tzpath_candidates() -> List[str]:
    import zoneinfo

    return list(zoneinfo.TZPATH) or ["/usr/share/zoneinfo"]


def read_tzif(zone: str) -> Optional[Tuple[List[int], List[int], int, bool]]:
    """Read a TZif file (RFC 8536): (UTC transition times, offset after
    each transition, offset before the first transition, footer has an
    active DST rule).  None when the zone file is missing or unreadable."""
    path = None
    for base in _tzpath_candidates():
        cand = os.path.join(base, *zone.split("/"))
        if os.path.isfile(cand):
            path = cand
            break
    if path is None:
        return None
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None

    def parse_block(buf: bytes, pos: int, time_size: int):
        if buf[pos:pos + 4] != b"TZif":
            raise ValueError("bad magic")
        version = buf[pos + 4:pos + 5]
        (isutcnt, isstdcnt, leapcnt, timecnt, typecnt, charcnt) = (
            struct.unpack(">6I", buf[pos + 20:pos + 44])
        )
        p = pos + 44
        fmt = ">%d%s" % (timecnt, "q" if time_size == 8 else "l")
        times = list(struct.unpack(fmt, buf[p:p + timecnt * time_size]))
        p += timecnt * time_size
        type_idx = list(buf[p:p + timecnt])
        p += timecnt
        ttinfo = []
        for _ in range(typecnt):
            utoff, _isdst, _desig = struct.unpack(">lBB", buf[p:p + 6])
            ttinfo.append(utoff)
            p += 6
        p += charcnt
        p += leapcnt * (time_size + 4)
        p += isstdcnt + isutcnt
        return version, times, type_idx, ttinfo, p

    try:
        version, times, type_idx, ttinfo, end = parse_block(data, 0, 4)
        footer = b""
        if version >= b"2":
            # The 64-bit section follows the v1 block, then the TZ footer.
            _, times, type_idx, ttinfo, end = parse_block(data, end, 8)
            footer = data[end:]
        if not ttinfo:
            return None
        offsets = [ttinfo[i] for i in type_idx]
        # Offset before the first transition: type 0 (the file
        # convention; the zoneinfo self-check drops any zone where that
        # disagrees).
        base = ttinfo[0]
        # A comma in the footer ("\nCET-1CEST,M3.5.0,M10.5.0/3\n") means
        # an active DST rule governs times past the last transition.
        return times, offsets, base, b"," in footer
    except (ValueError, struct.error, IndexError):
        return None


def wall_table(zone: str, span_minutes: int = SPAN_MINUTES) -> Optional[WallTable]:
    """Wall-clock (fold=0) transition table for one zone: (boundaries in
    minutes, ascending, first 0; offset seconds per segment;
    valid_until minute).  None when the zone cannot be represented
    exactly (missing file, sub-minute or non-monotone boundaries)."""
    got = read_tzif(zone)
    if got is None:
        return None
    times, offsets, base, footer_dst = got
    wall_bounds: List[Tuple[int, int]] = []   # (wall seconds, offset after)
    prev = base
    for t, off in zip(times, offsets):
        if off == prev:
            continue   # a no-op transition: no wall-clock boundary
        wall_bounds.append((t + max(prev, off), off))
        prev = off
    base_off = base
    for wall, off in wall_bounds:
        if wall <= 0:
            base_off = off
    bounds, segs, last_bound = [0], [base_off], 0
    for wall, off in wall_bounds:
        if wall <= 0:
            continue
        if wall % 60 != 0:
            return None
        m = wall // 60
        if m >= span_minutes:
            break
        if m <= last_bound:
            return None
        bounds.append(m)
        segs.append(off)
        last_bound = m
    valid_until = span_minutes - 1
    if footer_dst:
        valid_until = last_bound if last_bound > 0 else 0
    return (np.asarray(bounds, dtype=np.int64), np.asarray(segs, dtype=np.int32),
            valid_until)


def _probe_offset(zone_obj, minute: int) -> Optional[int]:
    """zoneinfo's fold=0 utcoffset at a wall minute."""
    import datetime as _dt

    days, rem = divmod(minute, 1440)
    try:
        local = _dt.datetime(1970, 1, 1) + _dt.timedelta(days=days, minutes=rem)
        delta = local.replace(tzinfo=zone_obj, fold=0).utcoffset()
        return int(delta.total_seconds())
    except (OverflowError, ValueError):
        return None


def validate_against_zoneinfo(zone: str, table: WallTable) -> bool:
    """Every segment's offset equals zoneinfo's fold=0 offset at and just
    before each boundary (and late in the last segment)."""
    try:
        from zoneinfo import ZoneInfo

        zobj = ZoneInfo(zone)
    except Exception:
        return False
    bounds, segs, valid_until = table
    bl, sl = bounds.tolist(), segs.tolist()
    for i, (b, off) in enumerate(zip(bl, sl)):
        if b < valid_until and _probe_offset(zobj, b) != off:
            return False
        if i > 0:
            before = bl[i] - 1
            if before < valid_until and _probe_offset(zobj, before) != sl[i - 1]:
                return False
    if valid_until > 0:
        last = min(valid_until - 1, bl[-1] + 2 * 365 * 1440)
        if last >= bl[-1] and _probe_offset(zobj, last) != sl[-1]:
            return False
    return True


def tzdata_wall_tables(zones: Sequence[str]) -> Dict[str, WallTable]:
    """{zone: wall table} for the zones this machine's tzdata represents
    exactly and zoneinfo confirms, in vocabulary order."""
    out: Dict[str, WallTable] = {}
    for zone in zones:
        table = wall_table(zone)
        if table is not None and validate_against_zoneinfo(zone, table):
            out[zone] = table
    return out


def write_snapshot(tables: Dict[str, WallTable], path: Path = SNAPSHOT,
                   tzdata_version: Optional[str] = None) -> None:
    """The wall tables as JSON: one zone per line."""
    rows = [json.dumps({"zone": z, "valid_until": int(v), "bounds": b.tolist(),
                        "offsets": s.tolist()}, separators=(",", ":"))
            for z, (b, s, v) in tables.items()]
    head = json.dumps({"span_minutes": SPAN_MINUTES, "tzdata": tzdata_version})
    Path(path).write_text(
        '{"meta": ' + head + ',\n"zones": [\n' + ",\n".join(rows) + "\n]}\n")


def read_snapshot(path: Path = SNAPSHOT) -> Dict[str, WallTable]:
    data = json.loads(Path(path).read_text())
    if data["meta"]["span_minutes"] != SPAN_MINUTES:
        raise ValueError(f"{path}: written for another key span")
    return {z["zone"]: (np.asarray(z["bounds"], dtype=np.int64),
                        np.asarray(z["offsets"], dtype=np.int32),
                        int(z["valid_until"]))
            for z in data["zones"]}


# ---------------------------------------------------------------------------
# The device table
# ---------------------------------------------------------------------------


def _bucket_index(keys: np.ndarray, n_zones: int, bits: int) -> Tuple[np.ndarray, int]:
    """For each bucket of 2^bits minutes of the key space, the last key at
    or before its start (clipped to 0, as the lookup clips); and the most
    keys strictly inside one bucket, the forward steps a lookup may take
    past its bucket's entry."""
    n_buckets = n_zones << (26 - bits)
    starts = np.arange(n_buckets, dtype=np.uint64) << bits
    first = np.searchsorted(keys, starts, side="right")
    index = np.maximum(first - 1, 0)
    chain = 0
    if len(keys) and n_buckets:
        ends = starts + np.uint64((1 << bits) - 1)
        chain = int((np.searchsorted(keys, ends, side="right") - first).max())
    return index, chain


@dataclass
class ZoneDeviceTable:
    """Packed uint32 keys ``zone * SPAN_MINUTES + wall minute`` with their
    offsets, resolved through a bucketed direct index: ``buckets[key >>
    BUCKET_BITS]`` (2^14 minutes, about 11.4 days) is the last transition
    at or before the bucket start, and at most ``chain`` steps forward
    finish the search (transitions are months apart)."""

    BUCKET_BITS = 14
    INDEX_BITS = 18

    zones: Tuple[str, ...]
    keys: np.ndarray          # [T] uint32 ascending
    offsets_s: np.ndarray     # [T] int32
    valid_until: np.ndarray   # [Z] int32 (exclusive wall-minute bound)
    buckets: np.ndarray       # [Z << (26 - BUCKET_BITS)] int32
    chain: int                # max in-bucket transition steps

    @classmethod
    def from_wall_tables(cls, tables: Dict[str, WallTable]) -> "ZoneDeviceTable":
        if len(tables) >= 64:
            raise ValueError("device zone vocabulary caps at 63 zones")
        keys: List[int] = []
        offs: List[int] = []
        for z, (bounds, segs, _) in enumerate(tables.values()):
            keys.extend(z * SPAN_MINUTES + b for b in bounds.tolist())
            offs.extend(segs.tolist())
        if any(abs(o) >= 86400 for o in offs):
            raise ValueError("a zone offset outside +-24h")
        keys_a = np.asarray(keys, dtype=np.uint32)
        buckets, chain = _bucket_index(keys_a, len(tables), cls.BUCKET_BITS)
        if chain > 4:
            raise ValueError(
                f"zone vocabulary needs {chain} in-bucket steps (>4); "
                "shrink BUCKET_BITS or drop the dense-transition zone"
            )
        return cls(tuple(tables), keys_a, np.asarray(offs, dtype=np.int32),
                   np.asarray([t[2] for t in tables.values()], dtype=np.int32),
                   buckets.astype(np.int32), chain)

    def coarse_index(self) -> Tuple[np.ndarray, int]:
        """The ``zone_lookup`` kernel's index and step count: [Z << (26 -
        INDEX_BITS)] uint16, for each bucket of 2^18 wall minutes (about
        182 days) the last transition at or before its start, and the most
        transitions inside one bucket (4 for the default vocabulary).  The
        kernel stages it in shared memory; ``buckets`` and :meth:`lookup`
        stay the reference's.  Raises ValueError at 65,536 transitions or
        more (uint16 entries)."""
        T = len(self.keys)
        if T >= 1 << 16:
            raise ValueError(f"{T} transitions do not fit the coarse index's "
                             "uint16 entries (at most 65,535)")
        index, chain = _bucket_index(self.keys, len(self.zones), self.INDEX_BITS)
        return index.astype(np.uint16), chain

    def packed(self) -> np.ndarray:
        """[T, 2] int32 rows of (key, offset + _OFFSET_BIAS), both uint32
        bit patterns: the kernel's table."""
        got = getattr(self, "_packed_cache", None)
        if got is None:
            got = np.stack([self.keys.astype(np.uint32),
                            (self.offsets_s.astype(np.int64) + _OFFSET_BIAS
                             ).astype(np.uint32)], axis=1).view(np.int32)
            self._packed_cache = got
        return got

    def lookup(self, zone_idx: torch.Tensor, minutes: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B] zone indices + [B] wall minutes (int32) -> (offset seconds
        int32, ok): the plain version of the ``zone_lookup`` kernel.  ok
        is False outside the zone's exact window (minutes < 0 or at or
        past ``valid_until``); the offset is still the one at the
        clipped minute."""
        t = self._tensors(minutes.device)
        m = minutes.to(torch.int64).clamp(0, SPAN_MINUTES - 1)
        key = zone_idx.to(torch.int64) * SPAN_MINUTES + m
        idx = t["buckets"][key >> self.BUCKET_BITS]
        last = max(len(self.keys) - 1, 0)
        for _ in range(self.chain):
            nxt = (idx + 1).clamp(max=last)
            idx = torch.where(t["keys"][nxt] <= key, nxt, idx)
        valid = t["valid_until"][zone_idx.to(torch.int64)]
        return t["offsets_s"][idx], (minutes >= 0) & (minutes < valid)

    def __getstate__(self):
        """The host tables only: the lookup's device operands are made
        again on the host that loads a pickled parser."""
        state = self.__dict__.copy()
        state.pop("_tensor_cache", None)
        return state

    def _tensors(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """The lookup's operands on ``device`` (cached per device)."""
        cache = self.__dict__.setdefault("_tensor_cache", {})
        got = cache.get(device)
        if got is None:
            got = cache[device] = {
                "keys": torch.from_numpy(self.keys.astype(np.int64)).to(device),
                "buckets": torch.from_numpy(self.buckets.astype(np.int64)).to(device),
                "offsets_s": torch.from_numpy(self.offsets_s).to(device),
                "valid_until": torch.from_numpy(self.valid_until).to(device),
            }
        return got


_TABLE_CACHE: Dict[str, ZoneDeviceTable] = {}


def default_zone_table() -> ZoneDeviceTable:
    """The table of the default vocabulary, from the committed snapshot
    (never from this machine's tzdata)."""
    got = _TABLE_CACHE.get("default")
    if got is None:
        got = _TABLE_CACHE["default"] = ZoneDeviceTable.from_wall_tables(read_snapshot())
    return got
