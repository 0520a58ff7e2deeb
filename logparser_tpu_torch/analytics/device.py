"""The device aggregation stage: the port of the reference package's
``analytics/device.py`` (``build_aggregate_fn``, one jitted body there)
as three CUDA kernels that read the packed ``[K, B]`` rows of the
``UnitsExecutor`` on the card, before any copy back:

- ``agg_lanes``  one thread per row: the winner / contested merge of the
                 units' row 0, the fold rules, and per distinct op field a
                 lane (a span word, base-10^6 limbs or an epoch-second
                 bucket, a sentinel where the row is not selected) plus
                 the per-row class plane ``cls`` (uint8: 0 counted on the
                 device, 1 fold, 2 reject, 3 padding);
- ``agg_reduce`` ``n_device``, the ``[ntiles, 3, 2]`` int32 tiles of every
                 ``sum`` (16-bit halves of each limb summed per 4096-row
                 tile) and the bins of every ``histogram``;
- ``agg_group``  distinct-value grouping of one span or int lane through
                 a global open-addressing hash table: ``(count, rep_row,
                 rep_start, rep_len)`` or ``(bucket, count)`` per distinct
                 key, in no particular order, and the group count.

Ops that read the same field share a lane (count_by and top_k one span
lane, sum and histogram one limbs lane, time_bucket one lane per width).
The plain PyTorch version of each kernel is here (``agg_lanes_plain``,
``agg_reduce_plain``, ``agg_group_plain``); ``tpu/kernels.py`` holds the
wrappers.  On the host, :func:`fetch_partials` copies back the class
plane, the scalars and a power-of-two prefix of each group array, and
:func:`accumulate_partials` folds them into an :class:`AggregateState`,
reading key bytes from the host copy of the batch buffer.

Exactness contract (the reference's): every row the device cannot finish
exactly -- truncated lines, CSR overflow, an escaped-quote claim, a span
value that needs host repair (amp / fix), a Long beyond int64 or a full
19-digit frame, a timestamp outside 1902-2037, a query-key match the raw
bytes cannot prove -- is folded (class 1) and replayed through the row
path, so the device partial plus the folded rows' referee partial equals
the referee over the whole batch.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..tpu.pipeline import (
    CSR_OVERFLOW_BIT,
    ESC_QUOTE_BIT,
    _SPAN_BITS,
    UnitsExecutor,
    _i32,
    csr_group_key,
    ts_group_key,
)
from .spec import AggregateSpec
from .state import AggregateState, _canon_key

_SPAN_MASK = (1 << _SPAN_BITS) - 1
INT32_MAX = (1 << 31) - 1
SUM_TILE = 4096              # 4096 * 0xFFFF < 2^31: the 16-bit-split bound

# Device-bucketable civil-year window: epoch seconds for years 1902..2037
# stay within int32.
_TS_YEAR_MIN, _TS_YEAR_MAX = 1902, 2037

# Longest query key matched on device (longer keys fold).
_QS_KEY_MAX = 64

# Lane kinds and the rows each writes into the lanes tensor.
LANE_SPAN, LANE_LIMBS, LANE_TIME = 0, 1, 2
LANE_ROWS = {LANE_SPAN: 1, LANE_LIMBS: 3, LANE_TIME: 1}
# Unit descriptor modes: rows won by the unit fold / read slots / match a
# query key in the packed CSR segment table.
UNIT_FOLD, UNIT_SLOTS, UNIT_QS = 0, 1, 2
# Null handling of a limbs lane: "" / dash_null, zero_null, dash_zero.
NULL_PLAIN, NULL_ZERO, NULL_DASH = 0, 1, 2
_NULL_CODE = {"zero_null": NULL_ZERO, "dash_zero": NULL_DASH}
UNIT_TRIPLES = 7
UDW = 2 + 3 * UNIT_TRIPLES   # unit descriptor: mode, null code, 7 slots
LANEW = 4                    # lane row: kind, first output row, width_s, first unit row
OVFW = 1 + 3 * 4             # overflow row: unit, ok, null, big, lo_digits slots
EDGEW = 4                    # histogram edge: always, A, B, C limbs

Slot = Tuple[int, int, int]  # (absolute packed row, shift, bits); bits 0 = the word


def _limbs_of(value: int) -> Tuple[int, int, int]:
    """(A, B, C) base-10^6 limbs of a non-negative int < 10^19."""
    return value // 10**12, (value // 10**6) % 10**6, value % 10**6


# ---------------------------------------------------------------------------
# static planning
# ---------------------------------------------------------------------------


class _OpPlan:
    """Static device plan for one op: per-unit descriptors, or None where
    rows won by that unit must fold to the row path."""

    def __init__(self, op, units_desc: List[Optional[dict]]):
        self.op = op
        self.units_desc = units_desc


def edge_rows(edges: Sequence[int]) -> List[Tuple[int, int, int, int]]:
    """A histogram's edges as (always, A, B, C) rows: an edge <= 0 always
    holds (values are >= 0), else its base-10^6 limbs."""
    return [(1, 0, 0, 0) if e <= 0 else (0, *_limbs_of(int(e))) for e in edges]


def _qscsr_desc(u, plan) -> Optional[dict]:
    """Device descriptor for count_by/top_k over one concrete query key
    (``STRING:...uri.query.img``), or None when rows won by this unit must
    fold.  The device matches the key against every emitted segment name
    (ASCII case fold, last match wins) and groups the matched value spans;
    rows whose match or value the raw bytes cannot prove fold in the lane.
    Wildcard deliveries and non-ASCII or oversized keys keep the host
    path."""
    if plan.kind != "qscsr" or not plan.comp or plan.comp == "*":
        return None
    if plan.attr:
        return None
    if (plan.meta or "query") != "query":
        return None
    key_b = plan.comp.encode("utf-8")
    if not 0 < len(key_b) <= _QS_KEY_MAX or any(b >= 0x80 for b in key_b):
        return None
    return {"plan": plan, "qs_group": csr_group_key(plan), "qs_key": key_b}


def plan_aggregate(parser, spec: AggregateSpec) -> List[_OpPlan]:
    """Resolve the spec against the parser's units.  A unit contributes on
    the device only when its plan for the field decodes to the exact
    delivered value with no host involvement; everything else folds,
    statically per (op, unit).  Probe units never win; a unit with oracle
    fields has every row it wins folded (``AggTables``' oracle fold), so
    its descriptors are moot."""
    plans: List[_OpPlan] = []
    for op in spec.ops:
        descs: List[Optional[dict]] = []
        for ui, u in enumerate(parser.units):
            if u.plausibility_only or parser._unit_oracle_fields[ui]:
                descs.append(None)
                continue
            if op.op == "count":
                descs.append({})
                continue
            plan = u.plan_for(op.field)
            if op.op in ("count_by", "top_k"):
                descs.append({"plan": plan} if plan.kind == "span"
                             else _qscsr_desc(u, plan))
            elif op.op in ("sum", "histogram"):
                descs.append({"plan": plan}
                             if plan.kind == "long" and plan.scale == 1 else None)
            else:  # time_bucket
                descs.append({"plan": plan}
                             if plan.kind == "ts" and plan.comp == "epoch" else None)
        plans.append(_OpPlan(op, descs))
    return plans


def lane_key(op) -> Optional[tuple]:
    """Ops with the same key compile to one lane (and one reduction)."""
    if op.op in ("count_by", "top_k"):
        return (LANE_SPAN, op.field)
    if op.op in ("sum", "histogram"):
        return (LANE_LIMBS, op.field)
    if op.op == "time_bucket":
        return (LANE_TIME, op.field, op.width_s)
    return None


class AggTables(nn.Module):
    """One (parser, spec) as int32 descriptor tables for the three kernels.

    ``units`` [U]: each unit's row-0 row.  ``lanes`` rows (kind, first
    output row, width_s, first unit row); ``udesc`` U rows per lane (mode,
    null code, then 7 slot triples (row, shift, bits)): a span lane reads
    the span word (triple 0) or, for a query key, the group's ok slot
    (triple 0), (first segment word row, slot count, 0) and (key offset
    into ``keys``, key length, 0); a limbs lane hi, lo, d18, lo_digits,
    ok, null, big; a time lane c1, c2, off, ok.  ``ovf`` rows (unit, ok,
    null, big, lo_digits slots): every requested long / secmillis field
    of every unit, for the global Long-overflow fold.  ``sums`` rows
    (limbs lane row); ``hists`` rows (limbs lane row, first edge, edge
    count, first bin) over ``edges`` rows (always, A, B, C).  The grouping
    lanes are ``groups_py`` (lanes row, is-span).  Lane ``i``'s unit rows
    are ``udesc`` rows ``i * U`` to ``i * U + U - 1``; ``max_row`` is the
    highest packed row the tables name."""

    def __init__(self, parser, spec: AggregateSpec):
        super().__init__()
        units = list(parser.units)
        self.spec = spec
        self.op_plans = plan_aggregate(parser, spec)
        self.units_py = [u.row_offset for u in units]
        U = len(units)

        lane_index: Dict[tuple, int] = {}
        self.lanes_py: List[Tuple[int, int, int, int]] = []
        self.udesc_py: List[List[int]] = []
        self.op_lane: List[int] = []
        keys = bytearray()
        n_rows = 0
        for p in self.op_plans:
            key = lane_key(p.op)
            if key is None:
                self.op_lane.append(-1)
                continue
            if key in lane_index:
                self.op_lane.append(lane_index[key])
                continue
            kind = key[0]
            lane_index[key] = len(self.lanes_py)
            self.op_lane.append(len(self.lanes_py))
            width = p.op.width_s if kind == LANE_TIME else 0
            self.lanes_py.append((kind, n_rows, width, len(self.udesc_py)))
            n_rows += LANE_ROWS[kind]
            for u, d in zip(units, p.units_desc):
                self.udesc_py.append(self._unit_desc(u, kind, p.op.field, d, keys))
        self.n_lane_rows = n_rows

        self.ovf_py: List[List[int]] = []
        for ui, u in enumerate(units):
            if u.plausibility_only:
                continue
            if parser._unit_oracle_fields[ui]:
                # Oracle fold: the host oracle visits every line this unit
                # wins, so each of them folds -- an overflow row whose ok and
                # big slots read the unit's valid bit (set on every row it
                # wins) and whose null slot reads the escaped-quote bit
                # (rows with it fold anyway).
                valid_bit = (u.row_offset, 0, 1)
                esc_bit = (u.row_offset, ESC_QUOTE_BIT.bit_length() - 1, 1)
                self.ovf_py.append([ui, *valid_bit, *esc_bit, *valid_bit, *valid_bit])
                continue
            for fid in parser.requested:
                if u.plan_for(fid).kind not in ("long", "secmillis"):
                    continue
                row = [ui]
                for comp in ("ok", "null", "big", "lo_digits"):
                    row.extend(self._slot(u, fid, comp))
                self.ovf_py.append(row)

        # Reductions: one sum per limbs lane, one histogram per (lane,
        # edges), one grouping per span / time lane.
        self.sums_py: List[int] = []
        self.hists_py: List[Tuple[int, int, int, int]] = []
        self.edges_py: List[Tuple[int, int, int, int]] = []
        self.groups_py: List[Tuple[int, bool]] = []
        self.op_partial: List[Optional[int]] = []
        seen: Dict[tuple, int] = {}
        n_bins = 0
        for p, li in zip(self.op_plans, self.op_lane):
            op = p.op
            if li < 0:
                self.op_partial.append(None)
                continue
            kind, row = self.lanes_py[li][:2]
            if op.op == "sum":
                key = ("sum", li)
            elif op.op == "histogram":
                key = ("hist", li, op.edges)
            else:
                key = ("group", li)
            if key not in seen:
                if op.op == "sum":
                    seen[key] = len(self.sums_py)
                    self.sums_py.append(row)
                elif op.op == "histogram":
                    seen[key] = len(self.hists_py)
                    self.hists_py.append((row, len(self.edges_py), len(op.edges), n_bins))
                    n_bins += len(op.edges) + 1
                    self.edges_py.extend(edge_rows(op.edges))
                else:
                    seen[key] = len(self.groups_py)
                    self.groups_py.append((row, kind == LANE_SPAN))
            self.op_partial.append(seen[key])
        self.n_bins = n_bins

        # The highest packed row agg_lanes reads: each unit's row 0, every
        # slot a lane or the overflow fold names, a query key's segment words.
        self.max_row = max(
            self.units_py
            + [d[k] for d in self.udesc_py if d[0] == UNIT_SLOTS for k in range(2, len(d), 3)]
            + [r for d in self.udesc_py if d[0] == UNIT_QS for r in (d[2], d[5] + 2 * d[6] - 1)]
            + [d[k] for d in self.ovf_py for k in range(1, len(d), 3)])

        self.register_buffer("units", torch.tensor(self.units_py or [0], dtype=torch.int32))
        self.register_buffer("lanes", _i32(self.lanes_py or [()], LANEW))
        self.register_buffer("udesc", _i32(self.udesc_py or [()], UDW))
        self.register_buffer("ovf", _i32(self.ovf_py or [()], OVFW))
        self.register_buffer("keys", torch.tensor(list(keys) or [0], dtype=torch.int32))
        self.register_buffer("sums", torch.tensor(self.sums_py or [0], dtype=torch.int32))
        self.register_buffer("hists", _i32(self.hists_py or [()], 4))
        self.register_buffer("edges", _i32(self.edges_py or [()], EDGEW))

    @staticmethod
    def _slot(u, key: str, comp: str) -> Slot:
        r, shift, bits = u.layout.slots[key][comp]
        return (u.row_offset + r, shift, bits)

    def _unit_desc(self, u, kind: int, fid: str, d: Optional[dict],
                   keys: bytearray) -> List[int]:
        if d is None:
            return [UNIT_FOLD, 0]
        plan = d["plan"]
        if kind == LANE_SPAN and plan.kind == "qscsr":
            gkey = d["qs_group"]
            slots = u.layout.slots[gkey]
            first = self._slot(u, gkey, "s0_start")[0]
            for k in range(u.layout.csr_slots):
                # The kernel reads slot k's two words at rows first + 2k and
                # first + 2k + 1 in the packed layout's bit positions.
                assert slots[f"s{k}_start"] == (first - u.row_offset + 2 * k, 0, _SPAN_BITS)
                assert slots[f"s{k}_vstart"] == (first - u.row_offset + 2 * k + 1, 0, _SPAN_BITS)
            desc = [UNIT_QS, 0, *self._slot(u, gkey, "ok"),
                    first, u.layout.csr_slots, 0, len(keys), len(d["qs_key"]), 0]
            keys.extend(d["qs_key"])
            return desc
        if kind == LANE_SPAN:
            return [UNIT_SLOTS, 0, u.row_offset + u.layout.slots[fid]["start"][0], 0, 0]
        if kind == LANE_LIMBS:
            desc = [UNIT_SLOTS, _NULL_CODE.get(plan.null_mode, NULL_PLAIN)]
            for comp in ("hi", "lo", "d18", "lo_digits", "ok", "null", "big"):
                desc.extend(self._slot(u, fid, comp))
            return desc
        key = ts_group_key(plan)
        desc = [UNIT_SLOTS, 0]
        for comp in ("c1", "c2", "off", "ok"):
            desc.extend(self._slot(u, key, comp))
        return desc


# ---------------------------------------------------------------------------
# Plain versions of the three kernels.
# ---------------------------------------------------------------------------


def _read(packed: torch.Tensor, row: int, shift: int, bits: int) -> torch.Tensor:
    col = packed[row]
    if bits == 0:
        return col
    return (col >> shift) & ((1 << bits) - 1)


def _triple(d: Sequence[int], k: int) -> Slot:
    return tuple(d[2 + 3 * k:5 + 3 * k])


def _qs_key_lane(packed, buf, d, keys_py: bytes):
    """The query-key lane of one unit: (ok, null, vstart, vlen, fold) from
    the packed CSR segment table (the reference's _qs_key_lane)."""
    B, L = buf.shape
    dev = buf.device
    first, n_slots = d[5], d[6]
    off, klen = d[8], d[9]
    target = torch.tensor(list(keys_py[off:off + klen]), dtype=torch.int32, device=dev)
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    false = torch.zeros(B, dtype=torch.bool, device=dev)
    g_ok = _read(packed, *_triple(d, 0)) != 0
    matched, bad = false, false
    m_vs, m_vl, m_dec = zero, zero, false
    pos = torch.arange(klen, dtype=torch.int64, device=dev)[None, :]
    for k in range(n_slots):
        n_word, v_word = packed[first + 2 * k], packed[first + 2 * k + 1]
        st = n_word & _SPAN_MASK
        nl = (n_word >> _SPAN_BITS) & _SPAN_MASK
        dc = ((n_word >> 27) & 1) != 0
        nd = ((n_word >> 28) & 1) != 0
        nh = ((n_word >> 29) & 1) != 0
        vs = v_word & _SPAN_MASK
        vl = (v_word >> _SPAN_BITS) & _SPAN_MASK
        emitted = nl > 0
        bad = bad | (emitted & (nd | nh))
        is_m = emitted & (nl == klen)
        idx = (st[:, None].to(torch.int64) + pos).clamp(0, L - 1)
        g = torch.gather(buf, 1, idx).to(torch.int32)
        folded = torch.where((g >= 0x41) & (g <= 0x5A), g | 0x20, g)
        is_m = is_m & (folded == target[None, :]).all(dim=1)
        matched = matched | is_m
        m_vs = torch.where(is_m, vs, m_vs)
        m_vl = torch.where(is_m, vl, m_vl)
        m_dec = torch.where(is_m, dc, m_dec)
    return g_ok, ~matched, m_vs, m_vl, bad | (matched & m_dec)


def _frame_value_limbs(hi, lo, d18, ndig, dead):
    """Right-aligned (A, B, C) base-10^6 limbs of the left-aligned 19-digit
    long frame (hi = digits 0..8, lo = digits 9..17, d18 = digit 19):
    value = frame // 10^(19 - ndig); dead rows read zero digits."""
    hi = torch.where(dead, 0, hi).to(torch.int64)
    lo = torch.where(dead, 0, lo).to(torch.int64)
    d18 = torch.where(dead, 0, d18).to(torch.int64)
    digits = [(hi // 10 ** (8 - i)) % 10 for i in range(9)]
    digits += [(lo // 10 ** (17 - i)) % 10 for i in range(9, 18)]
    digits.append(d18)
    shift = (19 - ndig.to(torch.int64)).clamp(0, 19)
    for bit in (16, 8, 4, 2, 1):
        on = (shift & bit) != 0
        digits = [torch.where(on, digits[j - bit], digits[j]) if j >= bit
                  else torch.where(on, 0, digits[j]) for j in range(19)]
    a = sum(digits[j] * 10 ** (6 - j) for j in range(0, 7))
    b = sum(digits[j] * 10 ** (12 - j) for j in range(7, 13))
    c = sum(digits[j] * 10 ** (18 - j) for j in range(13, 19))
    return a, b, c


def _epoch_bucket(c1, c2, off, width_s):
    """(in_range, bucket) of a timestamp bundle: epoch seconds from the
    civil components (days-from-civil), floored to ``width_s`` buckets;
    years outside 1902..2037 compute as 2000 (those rows fold)."""
    c1 = c1.to(torch.int64)
    c2 = c2.to(torch.int64)
    year = c1 & 0x3FFF
    month = (c1 >> 14) & 0xF
    day = (c1 >> 18) & 0x1F
    hour = (c1 >> 23) & 0x1F
    minute = c2 & 0x3F
    second = (c2 >> 6) & 0x3F
    in_range = (year >= _TS_YEAR_MIN) & (year <= _TS_YEAR_MAX)
    y = torch.where(in_range, year, 2000) - (month <= 2).to(torch.int64)
    era = torch.div(torch.where(y >= 0, y, y - 399), 400, rounding_mode="floor")
    yoe = y - era * 400
    mp = torch.remainder(month + 9, 12)
    doy = torch.div(153 * mp + 2, 5, rounding_mode="floor") + day - 1
    doe = (yoe * 365 + torch.div(yoe, 4, rounding_mode="floor")
           - torch.div(yoe, 100, rounding_mode="floor") + doy)
    days = era * 146097 + doe - 719468
    secs = days * 86400 + hour * 3600 + minute * 60 + second - off.to(torch.int64)
    return in_range, torch.div(secs, width_s, rounding_mode="floor")


def agg_lanes_plain(tables: AggTables, packed: torch.Tensor, buf: torch.Tensor,
                    n_rows: int, host_kill: torch.Tensor, cls: torch.Tensor,
                    lanes: torch.Tensor):
    """Fill ``cls`` [B] uint8 and ``lanes`` [n_lane_rows, B] int32 (the
    per-row body of the reference's build_aggregate_fn up to the
    reductions).  Lanes hold the selected rows' values: a span lane start
    | len << 13 (-1 when not selected), a limbs lane A, B, C (A = -1 when
    not selected), a time lane the bucket (INT32_MAX when not selected)."""
    B = buf.shape[0]
    dev = buf.device
    U = len(tables.units_py)
    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    false = torch.zeros(B, dtype=torch.bool, device=dev)
    row0 = [packed[r] for r in tables.units_py]
    validity = torch.stack([(r & 1) != 0 for r in row0])
    plausible = torch.stack([(r & 2) != 0 for r in row0])
    valid_any = validity.any(dim=0)
    idx = torch.arange(U, device=dev)[:, None]
    winner = torch.where(valid_any, torch.where(validity, idx, U).amin(dim=0), 0)
    if U > 1:
        p = plausible.to(torch.int32)
        earlier = p.cumsum(dim=0) - p
        valid_any = valid_any & (earlier.gather(0, winner[None, :])[0] == 0)
    plaus_any = plausible.any(dim=0)
    live = torch.arange(B, device=dev) < n_rows
    csr_over = false
    for r in row0:
        csr_over = csr_over | ((r & CSR_OVERFLOW_BIT) != 0)
    force_fold = live & ((host_kill != 0) | csr_over)
    base_valid = valid_any & live & ~force_fold
    w_row0 = torch.stack(row0).gather(0, winner[None, :])[0]
    fold = base_valid & ((w_row0 & ESC_QUOTE_BIT) != 0)
    keys_py = bytes(tables.keys.tolist())

    computed = []
    for kind, _, width, u0 in tables.lanes_py:
        descs = tables.udesc_py[u0:u0 + U]
        uncovered = false
        for ui, d in enumerate(descs):
            if d[0] == UNIT_FOLD:
                uncovered = uncovered | (winner == ui)
        if kind == LANE_SPAN:
            s, ln, ok, nul, ampfix = zero, zero, false, false, false
            for ui, d in enumerate(descs):
                if d[0] == UNIT_FOLD:
                    continue
                selu = winner == ui
                if d[0] == UNIT_QS:
                    q_ok, q_nul, q_vs, q_vl, q_fold = _qs_key_lane(packed, buf, d, keys_py)
                    s = torch.where(selu, q_vs.to(torch.int64), s)
                    ln = torch.where(selu, q_vl.to(torch.int64), ln)
                    ok = torch.where(selu, q_ok, ok)
                    nul = torch.where(selu, q_nul, nul)
                    ampfix = torch.where(selu, q_fold, ampfix)
                    continue
                w = packed[d[2]].to(torch.int64)
                s = torch.where(selu, w & _SPAN_MASK, s)
                ln = torch.where(selu, (w >> _SPAN_BITS) & _SPAN_MASK, ln)
                ok = torch.where(selu, ((w >> (2 * _SPAN_BITS)) & 1) != 0, ok)
                nul = torch.where(selu, ((w >> (2 * _SPAN_BITS + 1)) & 1) != 0, nul)
                ampfix = torch.where(selu, ((w >> (2 * _SPAN_BITS + 2)) & 3) != 0, ampfix)
            fold = fold | (base_valid & (uncovered | ampfix))
            computed.append((s | (ln << _SPAN_BITS), ok & ~nul))
        elif kind == LANE_LIMBS:
            hi, lo, d18, ndig = zero, zero, zero, zero
            ok, nul, big, excl_zero, incl_null = false, false, false, false, false
            for ui, d in enumerate(descs):
                if d[0] == UNIT_FOLD:
                    continue
                selu = winner == ui
                vals = [_read(packed, *_triple(d, k)) for k in range(7)]
                hi = torch.where(selu, vals[0].to(torch.int64), hi)
                lo = torch.where(selu, vals[1].to(torch.int64), lo)
                d18 = torch.where(selu, vals[2].to(torch.int64), d18)
                ndig = torch.where(selu, vals[3].to(torch.int64), ndig)
                ok = torch.where(selu, vals[4] != 0, ok)
                nul = torch.where(selu, vals[5] != 0, nul)
                big = torch.where(selu, vals[6] != 0, big)
                if d[1] == NULL_ZERO:
                    excl_zero = excl_zero | selu
                elif d[1] == NULL_DASH:
                    incl_null = incl_null | selu
            a, b, c = _frame_value_limbs(hi, lo, d18, ndig, ~ok | big | nul)
            fold = fold | (base_valid & uncovered)
            is_zero = (a == 0) & (b == 0) & (c == 0)
            sel_extra = torch.where(nul, incl_null, ~(excl_zero & is_zero))
            computed.append(((a, b, c), ok & sel_extra))
        else:
            c1, c2, off, ok = zero, zero, zero, false
            for ui, d in enumerate(descs):
                if d[0] == UNIT_FOLD:
                    continue
                selu = winner == ui
                c1 = torch.where(selu, _read(packed, *_triple(d, 0)).to(torch.int64), c1)
                c2 = torch.where(selu, _read(packed, *_triple(d, 1)).to(torch.int64), c2)
                off = torch.where(selu, _read(packed, *_triple(d, 2)).to(torch.int64), off)
                ok = torch.where(selu, _read(packed, *_triple(d, 3)) != 0, ok)
            in_range, bucket = _epoch_bucket(c1, c2, off, width)
            fold = fold | (base_valid & (uncovered | (ok & ~in_range)))
            computed.append((bucket, ok))

    # Global Long-overflow fold: a winner delivering any requested numeric
    # field with the big bit or a full 19-digit frame folds the row.
    for d in tables.ovf_py:
        ok = _read(packed, *d[1:4]) != 0
        nul = _read(packed, *d[4:7]) != 0
        big = _read(packed, *d[7:10]) != 0
        nd = _read(packed, *d[10:13])
        fold = fold | (base_valid & (winner == d[0]) & ok & ~nul & (big | (nd >= 19)))

    invalid = live & ~valid_any & ~force_fold
    reject = invalid & ~plaus_any
    c = torch.where(force_fold | invalid | (base_valid & fold), 1, 0)
    c = torch.where(reject, 2, c)
    c = torch.where(live, c, 3)
    cls.copy_(c)
    counted = c == 0
    for (kind, row, _, _), (value, sel) in zip(tables.lanes_py, computed):
        sel = sel & counted
        if kind == LANE_SPAN:
            lanes[row] = torch.where(sel, value, -1)
        elif kind == LANE_LIMBS:
            lanes[row] = torch.where(sel, value[0], -1)
            lanes[row + 1] = torch.where(sel, value[1], 0)
            lanes[row + 2] = torch.where(sel, value[2], 0)
        else:
            lanes[row] = torch.where(sel, value, INT32_MAX)
    return cls, lanes


def sum_tiling(B: int) -> Tuple[int, int]:
    """(tile, ntiles) of the sum tiles: 4096-row tiles, one when B is
    smaller (the reference's min(padded_b, SUM_TILE)); the last may be
    partial."""
    if B == 0:
        return SUM_TILE, 0
    tile = min(B, SUM_TILE)
    return tile, -(-B // tile)


def agg_reduce_plain(tables: AggTables, cls: torch.Tensor, lanes: torch.Tensor,
                     counts: torch.Tensor, tiles: torch.Tensor):
    """Fill ``counts`` [1 + n_bins] (n_device, then every histogram's
    bins) and ``tiles`` [n_sums, ntiles, 3, 2] (per sum, per tile, per limb
    the sums of its low and high 16 bits)."""
    B = cls.shape[0]
    tile, ntiles = sum_tiling(B)
    counts[0] = (cls == 0).sum()
    for si, row in enumerate(tables.sums_py):
        sel = lanes[row] != -1
        for j in range(3):
            v = torch.where(sel, lanes[row + j], 0).to(torch.int64)
            v = torch.nn.functional.pad(v, (0, ntiles * tile - B)).view(ntiles, tile)
            tiles[si, :, j, 0] = (v & 0xFFFF).sum(dim=1)
            tiles[si, :, j, 1] = (v >> 16).sum(dim=1)
    for row, e0, ne, b0 in tables.hists_py:
        a, b, c = lanes[row], lanes[row + 1], lanes[row + 2]
        sel = a != -1
        bin_of = torch.zeros(B, dtype=torch.int64, device=cls.device)
        for always, ea, eb, ec in tables.edges_py[e0:e0 + ne]:
            if always:
                ge = torch.ones(B, dtype=torch.bool, device=cls.device)
            else:
                ge = (a > ea) | ((a == ea) & ((b > eb) | ((b == eb) & (c >= ec))))
            bin_of = bin_of + ge.to(torch.int64)
        for k in range(ne + 1):
            counts[1 + b0 + k] = (sel & (bin_of == k)).sum()
    return counts, tiles


def agg_group_plain(lane: torch.Tensor, buf: torch.Tensor, spans: bool,
                    groups: torch.Tensor, n_groups: torch.Tensor):
    """Exact distinct-value grouping of one lane (torch.unique over the
    key bytes and length, or over the buckets): fills the first n rows of
    ``groups`` with (count, rep_row, rep_start, rep_len) per distinct span
    key, or (bucket, count) per distinct bucket, and ``n_groups`` [1]."""
    B, L = buf.shape
    dev = buf.device
    rows = torch.nonzero(lane != (-1 if spans else INT32_MAX)).flatten()
    if rows.numel() == 0:
        n_groups[0] = 0
        return groups, n_groups
    if spans:
        w = lane[rows].to(torch.int64)
        s, ln = w & _SPAN_MASK, (w >> _SPAN_BITS) & _SPAN_MASK
        width = int(ln.max())
        pos = torch.arange(width, device=dev)[None, :]
        idx = (s[:, None] + pos).clamp(max=L - 1)
        bts = torch.gather(buf[rows], 1, idx).to(torch.int32)
        key = torch.cat([ln[:, None].to(torch.int32),
                         torch.where(pos < ln[:, None], bts, 0)], dim=1)
        _, inverse, cnt = torch.unique(key, dim=0, return_inverse=True,
                                       return_counts=True)
        n = cnt.numel()
        first = torch.full((n,), rows.numel(), dtype=torch.int64, device=dev)
        first = first.scatter_reduce(0, inverse, torch.arange(rows.numel(), device=dev),
                                     reduce="amin")
        out = torch.stack([cnt, rows[first], s[first], ln[first]], dim=1)
    else:
        uniq, cnt = torch.unique(lane[rows], return_counts=True)
        n = cnt.numel()
        out = torch.stack([uniq.to(torch.int64), cnt], dim=1)
    groups[:n] = out.to(torch.int32)
    n_groups[0] = n
    return groups, n_groups


# ---------------------------------------------------------------------------
# The executor: the port of build_aggregate_fn as a launch sequence.
# ---------------------------------------------------------------------------


class AggregateExecutor(nn.Module):
    """(buf [B, L] uint8, lengths [B] int32, n_rows, host_kill [B] uint8)
    -> the partials on the batch's device: ``cls`` [B] uint8, ``counts``
    [1 + n_bins] int32, ``tiles`` [n_sums, ntiles, 3, 2] int32 and per
    grouping lane ``(groups [B, 4 or 2], n_groups [1])`` int32.

    Launches the parser's ``UnitsExecutor`` kernels (its own copy, with no
    view rows: the aggregate reads none), then ``agg_lanes``,
    ``agg_reduce`` and one ``agg_group`` per distinct grouping lane."""

    def __init__(self, parser, spec: AggregateSpec):
        super().__init__()
        self.units = UnitsExecutor(parser.units)
        self.tables = AggTables(parser, spec)

    def forward(self, buf: torch.Tensor, lengths: torch.Tensor, n_rows: int,
                host_kill: torch.Tensor) -> Dict[str, Any]:
        return self.group(*self.partials(buf, lengths, n_rows, host_kill), buf)

    def partials(self, buf: torch.Tensor, lengths: torch.Tensor, n_rows: int,
                 host_kill: torch.Tensor):
        """(cls, lanes, counts, tiles) of one batch, or one data shard, on
        its device: the parse kernels, ``agg_lanes`` and ``agg_reduce``."""
        from ..tpu import kernels

        packed = self.units(buf, lengths)
        cls, lanes = kernels.agg_lanes(self.tables, packed, buf, n_rows, host_kill)
        counts, tiles = kernels.agg_reduce(self.tables, cls, lanes)
        return cls, lanes, counts, tiles

    def group(self, cls: torch.Tensor, lanes: torch.Tensor, counts: torch.Tensor,
              tiles: torch.Tensor, buf: torch.Tensor) -> Dict[str, Any]:
        """The partials dict: one ``agg_group`` per grouping lane over the
        whole batch's lanes and bytes."""
        from ..tpu import kernels

        groups = [kernels.agg_group(lanes[row], buf, spans)
                  for row, spans in self.tables.groups_py]
        return {"cls": cls, "counts": counts, "tiles": tiles, "groups": groups}


def aggregate_shards(executors: Dict[torch.device, AggregateExecutor],
                     bufs: Sequence[torch.Tensor], lengths: Sequence[torch.Tensor],
                     kills: Sequence[torch.Tensor], n: int,
                     home: torch.device) -> Dict[str, Any]:
    """The aggregate of a data-sharded batch (the reference's mesh
    aggregate, data-sharded in, replicated out): each shard's
    ``partials`` on its device (rows at or past ``n`` are padding), then
    on ``home`` the class planes and lanes side by side, the counts and
    bins added, the sum tiles concatenated (``accumulate_partials`` adds
    every tile), and one ``agg_group`` per lane over the gathered lanes
    and the shards' bytes -- the single-device grouping, so keys, counts
    and capacity are its own."""
    from ..parallel.mesh import gather_columns

    parts, r0 = [], 0
    for buf, ln, kill in zip(bufs, lengths, kills):
        n_rows = max(0, min(buf.shape[0], n - r0))
        parts.append(executors[buf.device].partials(buf, ln, n_rows, kill))
        r0 += buf.shape[0]
    cls = gather_columns([p[0] for p in parts], n, home)
    lanes = gather_columns([p[1] for p in parts], n, home)
    if len(parts) == 1 and bufs[0].shape[0] == n and bufs[0].device == home:
        _, _, counts, tiles = parts[0]   # one shard: the batch itself
        return executors[home].group(cls, lanes, counts, tiles, bufs[0])
    counts = torch.stack([p[2].to(home) for p in parts]).sum(dim=0, dtype=torch.int32)
    tiles = torch.cat([p[3].to(home) for p in parts], dim=1)
    buf = torch.cat([b.to(home) for b in bufs])[:n]
    return executors[home].group(cls, lanes, counts, tiles, buf)


# ---------------------------------------------------------------------------
# host side: fetch + accumulate
# ---------------------------------------------------------------------------


def _pow2_at_least(n: int, cap: int) -> int:
    k = 1
    while k < n:
        k <<= 1
    return min(k, cap)


def _to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Copy device tensors back (pinned, non-blocking, one synchronize)."""
    if not tensors or not tensors[0].is_cuda:
        return [t.numpy() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [h.numpy() for h in host]


def fetch_partials(out: Dict[str, Any], tables: AggTables,
                   B: int) -> Tuple[Dict[str, Any], int]:
    """Copy the partials back: the class plane (1 byte a row), the counts
    and tiles, each grouping lane's group count, then a power-of-two
    prefix of its group array sized by that count, so the copy scales
    with distinct keys, not batch size.  Ops that compile to one
    reduction share one copy.  Returns (host partials in the reference's
    ``op{i}_*`` form, bytes copied)."""
    ns = [n for _, n in out["groups"]]
    cls, counts, tiles, *ns = _to_host([out["cls"], out["counts"], out["tiles"], *ns])
    n_groups = [int(n[0]) for n in ns]
    prefixes = _to_host([g[:_pow2_at_least(n, B)] for (g, _), n in
                         zip(out["groups"], n_groups) if n > 0])
    nbytes = cls.nbytes + counts.nbytes + tiles.nbytes + 4 * len(ns)
    nbytes += sum(p.nbytes for p in prefixes)
    group_arrays = iter(prefixes)
    groups = [next(group_arrays) if n > 0
              else np.zeros((0, 4 if spans else 2), dtype=np.int32)
              for n, (_, spans) in zip(n_groups, tables.groups_py)]
    fetched: Dict[str, Any] = {"cls": cls, "n_device": int(counts[0])}
    for i, (p, part) in enumerate(zip(tables.op_plans, tables.op_partial)):
        op = p.op.op
        if op == "sum":
            fetched[f"op{i}_tiles"] = tiles[part]
        elif op == "histogram":
            b0, ne = tables.hists_py[part][3], tables.hists_py[part][2]
            fetched[f"op{i}_bins"] = counts[1 + b0:1 + b0 + ne + 1]
        elif op != "count":
            fetched[f"op{i}_n"] = n_groups[part]
            fetched[f"op{i}_groups"] = groups[part]
    return fetched, int(nbytes)


def accumulate_partials(state: AggregateState, spec: AggregateSpec,
                        fetched: Dict[str, Any], buf: np.ndarray) -> None:
    """Fold one batch's device partials into the state.  Key bytes for
    the grouping ops come from the host copy of the batch buffer: the
    representative (row, start, len) triples index it, so no span bytes
    cross back from the card."""
    n_device = fetched["n_device"]
    for i, op in enumerate(spec.ops):
        if op.op == "count":
            state.data[i] += n_device
        elif op.op in ("count_by", "top_k"):
            acc = state.data[i]
            groups = fetched[f"op{i}_groups"]
            for g in range(fetched[f"op{i}_n"]):
                cnt, row, s, ln = (int(x) for x in groups[g])
                raw = bytes(buf[row, s:s + ln])
                key = _canon_key(raw.decode("utf-8", errors="replace"))
                acc[key] = acc.get(key, 0) + cnt
        elif op.op == "sum":
            tiles = fetched[f"op{i}_tiles"].astype(object)
            limbs = []
            for j in range(3):
                lo = int(tiles[:, j, 0].sum())
                hi = int(tiles[:, j, 1].sum())
                limbs.append(lo + (hi << 16))
            state.data[i] += limbs[0] * 10**12 + limbs[1] * 10**6 + limbs[2]
        elif op.op == "histogram":
            bins = fetched[f"op{i}_bins"]
            for b in range(len(bins)):
                state.data[i][b] += int(bins[b])
        else:  # time_bucket
            acc = state.data[i]
            groups = fetched[f"op{i}_groups"]
            for g in range(fetched[f"op{i}_n"]):
                bucket, cnt = int(groups[g, 0]), int(groups[g, 1])
                acc[bucket] = acc.get(bucket, 0) + cnt


__all__ = [
    "AggTables", "AggregateExecutor", "aggregate_shards", "plan_aggregate", "fetch_partials",
    "accumulate_partials", "agg_lanes_plain", "agg_reduce_plain",
    "agg_group_plain", "sum_tiling", "SUM_TILE",
]
