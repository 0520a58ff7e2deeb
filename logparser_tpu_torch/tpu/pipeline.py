"""Device pipeline: split + typed post-stages -> ONE packed [K, B] int32.

The port of the reference package's ``tpu/pipeline.py`` for the Apache
and NGINX paths of this slice.  Host data (field plans, the packed
bit-slot layout, format units) is copied; the device computation is
eleven hand-written CUDA kernels (``kernels.py``, sources in ``csrc/``)
run by :class:`UnitsExecutor`, the port of ``build_units_jnp_fn``:

1. ``split``       — the split program: token cursors, valid, plausible,
                     esc_hit (:func:`compute_split` is its plain version);
2. ``span_stages`` — CLF dash, first-line and protocol splits, ``%b``
                     limb frame (and the number -> CLF conversion), NGINX
                     seconds-with-millis and upstream-list elements, view
                     prefix words (:func:`span_stages_plain`);
3. ``timestamp``   — the ``DeviceTimeLayout`` segments at a per-row
                     cursor, the offset tail, the resolver and range
                     checks (``timeparse.parse_timestamp_fields``); for a
                     %Z layout it stops at the zone and wall minute, and
   ``zone_lookup`` — resolves them through the tzdata tables
                     (``timeparse.resolve_zone_offset``);
4. ``uri_split``   — one URI split per (token, steps) group: sub-spans,
                     fix / amp flags, line constraints, the port long
                     (:func:`uri_split_plain`);
5. ``csr_split``   — one query-string or cookie split per group: packed
                     segment words and overflow (:func:`csr_split_plain`);
   ``setcookie_split`` — one Set-Cookie split per group, with the expires
                     rejoin and its bad rows (:func:`setcookie_split_plain`);
   ``muid``        — one mod_unique_id decode per group
                     (:func:`muid_plain`);
   ``ipv4_spans``  — one dotted-quad parse per IP token that GeoIP
                     groups read (the value, ok, has_colon;
                     :func:`ipv4_spans_plain`), then
   ``geo_lookup``  — one range join per GeoIP group into its flattened
                     .mmdb table (:func:`geo_lookup_plain`);
6. ``pack_rows``   — bit-packing of every component into ``[K, B]``, the
                     row-0 verdict bits and line constraints in plan
                     order, and the winner-merged view rows
                     (:func:`pack_rows_plain`).

Stages 2 to 5 write "components": one ``[B]`` int32 row per value a
layout slot receives, in a ``[n_comp, B]`` tensor that stage 6 packs;
stages 4 and 5 read their input spans from rows earlier stages wrote.
The per-parser constants (program, plans, layout) become small int32
tables uploaded once (the ``*Tables`` modules below) and passed to every
launch.  The plain versions run on the CPU; on a CUDA tensor the wrappers
launch the kernels or raise.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dataclass_field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..dissectors.timelayout import MONTHS_SHORT
from ..geoip.device import lookup_rows_plain, u32_bits
from . import postproc, timeparse
from .program import CS_ANY, DeviceProgram


@dataclass(frozen=True)
class FieldPlan:
    """How one requested field is produced on device.

    A token capture plus a chain of span-transform ``steps`` (the
    first-line split ``("fl", part)``, the protocol split ``("pv",
    part)``, the URI split ``("uri", part)``) ending in a terminal decode
    ``kind``: ``span`` (the sub-span itself), ``long`` (digit span ->
    int64, ``null_mode`` handles the CLF '-'), ``ts`` (timestamp ->
    component bundle; ``comp`` names the output, ``meta`` carries the
    DeviceTimeLayout), ``qscsr`` (a query-string, cookie or Set-Cookie
    wildcard: ``comp`` is the name or ``*``, ``meta`` the mode ``"query"``
    / ``"cookie"`` / ``"setcookie"``, ``attr`` a Set-Cookie attribute),
    ``secmillis`` (``<seconds>.<millis>`` -> int64 milliseconds times
    ``scale``), ``geo`` (an IP's GeoIP column: ``comp`` the column,
    ``meta`` (database tag, column, GeoDeviceTable)), ``muid`` (a
    mod_unique_id output, ``comp`` its name), ``ulist`` (an NGINX
    upstream-list element, ``meta`` (index, "value" / "redirected")) or
    ``host`` (not device-resolvable).  ``null_mode`` ``zero_null`` is
    the number -> CLF conversion (0 reads null)."""

    field_id: str                 # cleaned "TYPE:path"
    kind: str                     # span | long | ts | qscsr | secmillis | geo | muid | ulist | host
    token_index: int = -1
    steps: Tuple[Tuple[str, str], ...] = ()
    comp: str = ""
    meta: object = None
    null_mode: str = ""           # "" | dash_null | dash_zero | zero_null
    scale: int = 1
    attr: str = ""


# ---------------------------------------------------------------------------
# Packed output layout: every output component is a bit slot (row, shift,
# bits) in the [K, B] int32 result.  Span kinds pack start|len|ok|null
# into ONE row (13+13+1+1 bits; L is capped at 8191); numeric/epoch aux
# bits share trailing "meta" rows.
# ---------------------------------------------------------------------------

_SPAN_BITS = 13          # start / len each; supports L up to 8191
_SPAN_MASK = (1 << _SPAN_BITS) - 1

Slot = Tuple[int, int, int]   # (row, shift, bits); bits=0 -> full int32 row

# row 0 bit assignments: bit 0 = line validity, bit 1 = plausibility,
# bit 2 = CSR slot overflow (a query string with more segments than
# slots, or a URI / query span longer than its scan window), bit 3 = the
# valid line's quoted-field split consumed a backslash-escaped separator.
CSR_OVERFLOW_BIT = 4
ESC_QUOTE_BIT = 8

# Segment slots per CSR wildcard split (query params).  A line with more
# segments than slots raises CSR_OVERFLOW_BIT and goes to the host;
# TorchBatchParser reacts by doubling the slots (up to CSR_SLOTS_MAX) and
# re-running the batch.
CSR_SLOTS = 16
CSR_SLOTS_MAX = 128
# Scan windows, in span bytes per slot: csr_split scans at most
# slots * CSR_WINDOW_PER_SLOT bytes of a query span, uri_split at most
# slots * URI_WINDOW_PER_SLOT bytes of a URI (192 at 16 slots, 1536 at
# the cap); a longer span raises the same overflow bit.
CSR_WINDOW_PER_SLOT = 8
URI_WINDOW_PER_SLOT = 12

# Split flags (the split kernel's per-line output word).
SPLIT_VALID = 1
SPLIT_PLAUSIBLE = 2
SPLIT_ESC_HIT = 4


def ts_group_key(plan: FieldPlan) -> str:
    """All ts plans over the same token+steps share one component bundle."""
    return f"@ts:{plan.token_index}:{plan.steps!r}"


def csr_group_key(plan: FieldPlan) -> str:
    """All qscsr plans over the same token+steps+mode share one segment
    table."""
    return f"@qs:{plan.token_index}:{plan.meta}:{plan.steps!r}"


def geo_group_key(plan: FieldPlan) -> str:
    """All geo plans over the same token+steps+database share one range
    join (``plan.meta[0]`` is the database's tag)."""
    return f"@geo:{plan.token_index}:{plan.meta[0]}:{plan.steps!r}"


def muid_group_key(plan: FieldPlan) -> str:
    """All mod_unique_id plans over the same token+steps share one decode."""
    return f"@muid:{plan.token_index}:{plan.steps!r}"


# The separator of each CSR mode (a Set-Cookie list has its own split).
CSR_SEPARATORS = {"query": b"&", "cookie": b"; "}


@dataclass
class PackedLayout:
    """Bit-slot map for the packed [K, B] int32 output (row 0 = validity).

    Timestamp component bundles are shared: every ``ts`` plan on the same
    (token, steps) maps to one ``@ts:...`` slot group with rows ``c1``
    (year|month<<14|day<<18|hour<<23), ``c2`` (minute|second<<6|
    milli<<12), ``off`` (raw UTC offset seconds) and an ``ok`` bit."""

    slots: Dict[str, Dict[str, Slot]] = dataclass_field(default_factory=dict)
    n_rows: int = 1
    csr_slots: int = CSR_SLOTS

    @classmethod
    def for_plans(
        cls, plans: Sequence[FieldPlan], csr_slots: int = CSR_SLOTS
    ) -> "PackedLayout":
        layout = cls(csr_slots=csr_slots)
        aux_needs: List[Tuple[str, str, int]] = []  # (slot_key, comp, bits)
        for plan in plans:
            kind = plan.kind
            if kind == "host":
                continue
            if kind in ("span", "ulist"):
                r = layout.n_rows
                layout.n_rows += 1
                layout.slots[plan.field_id] = {
                    "start": (r, 0, _SPAN_BITS),
                    "len": (r, _SPAN_BITS, _SPAN_BITS),
                    "ok": (r, 2 * _SPAN_BITS, 1),
                    "null": (r, 2 * _SPAN_BITS + 1, 1),
                    "amp": (r, 2 * _SPAN_BITS + 2, 1),
                    "fix": (r, 2 * _SPAN_BITS + 3, 1),
                }
            elif kind in ("long", "secmillis"):
                rhi, rlo = layout.n_rows, layout.n_rows + 1
                layout.n_rows += 2
                layout.slots[plan.field_id] = {
                    "hi": (rhi, 0, 0),
                    "lo": (rlo, 0, 0),
                }
                aux_needs += [
                    (plan.field_id, "ok", 1),
                    (plan.field_id, "null", 1),
                    (plan.field_id, "lo_digits", 5),  # digit count <= 19
                    (plan.field_id, "d18", 4),        # the 19th frame digit
                    # >19-digit run, device-valid: the hi row carries
                    # start|len<<_SPAN_BITS for the host byte-patch.
                    (plan.field_id, "big", 1),
                ]
                if kind == "secmillis":
                    aux_needs.append((plan.field_id, "milli", 10))
            elif kind == "ts":
                key = ts_group_key(plan)
                if key not in layout.slots:
                    r = layout.n_rows
                    layout.n_rows += 3
                    layout.slots[key] = {
                        "c1": (r, 0, 0),
                        "c2": (r + 1, 0, 0),
                        "off": (r + 2, 0, 0),
                    }
                    aux_needs.append((key, "ok", 1))
            elif kind == "geo":
                key = geo_group_key(plan)
                if key not in layout.slots:
                    layout.slots[key] = {"row": (layout.n_rows, 0, 0)}
                    layout.n_rows += 1
                    aux_needs.append((key, "ok", 1))
            elif kind == "muid":
                key = muid_group_key(plan)
                if key not in layout.slots:
                    r = layout.n_rows
                    layout.n_rows += 4
                    layout.slots[key] = {"time": (r, 0, 0), "ip": (r + 1, 0, 0),
                                         "pid": (r + 2, 0, 0), "thread": (r + 3, 0, 0)}
                    aux_needs += [(key, "ok", 1), (key, "counter", 16)]
            elif kind == "qscsr":
                key = csr_group_key(plan)
                if key not in layout.slots:
                    slots: Dict[str, Slot] = {}
                    for k in range(csr_slots):
                        rn, rv = layout.n_rows, layout.n_rows + 1
                        layout.n_rows += 2
                        slots[f"s{k}_start"] = (rn, 0, _SPAN_BITS)
                        slots[f"s{k}_nlen"] = (rn, _SPAN_BITS, _SPAN_BITS)
                        slots[f"s{k}_eq"] = (rn, 2 * _SPAN_BITS, 1)
                        slots[f"s{k}_dec"] = (rn, 2 * _SPAN_BITS + 1, 1)
                        slots[f"s{k}_ndec"] = (rn, 2 * _SPAN_BITS + 2, 1)
                        slots[f"s{k}_nhigh"] = (rn, 2 * _SPAN_BITS + 3, 1)
                        slots[f"s{k}_vstart"] = (rv, 0, _SPAN_BITS)
                        slots[f"s{k}_vlen"] = (rv, _SPAN_BITS, _SPAN_BITS)
                    layout.slots[key] = slots
                    aux_needs.append((key, "ok", 1))
            else:
                raise ValueError(f"plan kind {kind!r} is not on this slice")
        # Aux bits share meta rows (30 usable bits per row: the sign bit
        # stays clear).
        shift = 30
        row = layout.n_rows - 1
        for fid, comp, bits in aux_needs:
            if shift + bits > 30:
                row = layout.n_rows
                layout.n_rows += 1
                shift = 0
            layout.slots.setdefault(fid, {})[comp] = (row, shift, bits)
            shift += bits
        return layout

    def get(self, packed: np.ndarray, field_id: str, comp: str) -> np.ndarray:
        """Decode one component from the packed [K, B] host array."""
        row, shift, bits = self.slots[field_id][comp]
        col = packed[row]
        if bits == 0:
            return col
        return (col >> shift) & ((1 << bits) - 1)

    def get_ts_components(self, packed: np.ndarray, plan: FieldPlan):
        """Decode a ts plan's shared component bundle -> (components, ok)."""
        key = ts_group_key(plan)
        c1 = self.get(packed, key, "c1")
        c2 = self.get(packed, key, "c2")
        comp = {
            "year": (c1 & 0x3FFF).astype(np.int64),
            "month": ((c1 >> 14) & 0xF).astype(np.int64),
            "day": ((c1 >> 18) & 0x1F).astype(np.int64),
            "hour": ((c1 >> 23) & 0x1F).astype(np.int64),
            "minute": (c2 & 0x3F).astype(np.int64),
            "second": ((c2 >> 6) & 0x3F).astype(np.int64),
            "milli": ((c2 >> 12) & 0x3FF).astype(np.int64),
            "offset_seconds": self.get(packed, key, "off").astype(np.int64),
        }
        ok = self.get(packed, key, "ok") != 0
        return comp, ok


@dataclass
class FormatUnit:
    """One registered LogFormat's compiled device pipeline: split program +
    per-field plans + packed row layout.  row_offset is its first row in
    the stacked multi-format output (that row is its validity row)."""

    program: DeviceProgram
    plans: List[FieldPlan]
    layout: PackedLayout
    row_offset: int = 0
    # An uncompilable format's separator-order probe: its one row carries
    # only the plausibility bit, so it never claims a line, only contests
    # later formats' claims.
    plausibility_only: bool = False

    def plan_for(self, field_id: str) -> FieldPlan:
        for p in self.plans:
            if p.field_id == field_id:
                return p
        return FieldPlan(field_id, "host")


def packed_row_count(units: Sequence[FormatUnit]) -> int:
    """Stacked packed rows of one executor pass over ``units`` (without
    the view rows): the D2H footprint the aggregate path compares with."""
    return sum(u.layout.n_rows for u in units)


def assign_row_offsets(units: Sequence[FormatUnit]) -> int:
    """Set each unit's row_offset; returns the stacked row count K."""
    off = 0
    for u in units:
        u.row_offset = off
        off += u.layout.n_rows
    return off


# Device-emitted Arrow view ingredients: 4 extra int32 rows per span field
# appended to the packed output.  Row 0 is the winner-merged span word
# (start | len<<13 | live<<26); rows 1-3 carry the span's first 12 bytes
# (LE-packed, masked beyond len).
VIEW_ROWS_PER_FIELD = 4
VIEW_LEN_SHIFT = _SPAN_BITS
VIEW_LIVE_SHIFT = 2 * _SPAN_BITS

ViewSpecs = Sequence[Tuple[str, Sequence[int]]]


# ---------------------------------------------------------------------------
# Kernel 1, plain version: the split program over dense [B, L] masks.
#
# Same contract as the reference's compute_split / compute_split_dense:
# per-token start/end cursors, validity, plausibility and esc_hit.
# Escape parity (Apache writes `\"` for a quote inside a quoted field): a
# quote-led separator occurrence behind an odd backslash run is data.  On
# the format's FINAL op skipping it is exact and sets esc_hit; on a
# non-final op the skip un-claims the line (the host regex might match
# there).  Plausibility is a sound over-approximation of "the format's
# regex could accept this line": every separator occurs in order, with a
# leading literal anchored at 0, the final literal at the line end, and a
# bounded to_end tail past its last violating byte.  First-index
# reductions use masked amin, never argmax, so ties cannot depend on the
# backend.
# ---------------------------------------------------------------------------

_BACKSLASH = 0x5C


def esc_quote_op_flags(program: DeviceProgram) -> Dict[int, bool]:
    """{op position: op is the program's final op} for every until_lit
    whose separator begins with a quote over an unconstrained capture."""
    ops = program.ops
    return {
        i: i == len(ops) - 1
        for i, op in enumerate(ops)
        if op.kind == "until_lit"
        and op.lit[:1] == b'"'
        and op.charset == CS_ANY
    }


def escaped_lead_positions(buf: torch.Tensor) -> torch.Tensor:
    """[B, L] bool: the backslash run right before p has odd length."""
    B, L = buf.shape
    pos = torch.arange(L, device=buf.device, dtype=torch.int32)[None, :]
    last_non_bs = torch.cummax(
        torch.where(buf != _BACKSLASH, pos, -1), dim=1
    ).values
    prev_last = torch.cat(
        [torch.full((B, 1), -1, dtype=torch.int32, device=buf.device),
         last_non_bs[:, :-1]], dim=1,
    )
    return (((pos - 1) - prev_last) & 1) == 1


def compute_split(
    program: DeviceProgram, buf: torch.Tensor, lengths: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the split program over a [B, L] uint8 buffer (lengths <= L).

    Returns (starts [T, B] int32, ends [T, B] int32, flags [B] int32) with
    flags = SPLIT_VALID | SPLIT_PLAUSIBLE | SPLIT_ESC_HIT bits."""
    B, L = buf.shape
    dev = buf.device
    pos = torch.arange(L, device=dev, dtype=torch.int32)[None, :]
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    len_col = lengths[:, None]

    lit_masks: Dict[bytes, torch.Tensor] = {}
    for lit in sorted({op.lit for op in program.ops if op.lit}):
        m = None
        for k, byte in enumerate(lit):
            part = postproc.shift_zero(buf, k) == byte
            m = part if m is None else (m & part)
        lit_masks[lit] = m & (pos + len(lit) <= len_col)

    cs_ok: Dict[str, torch.Tensor] = {}
    long_buf = None
    for op in program.ops:
        if op.kind != "lit" and op.charset != CS_ANY and op.charset not in cs_ok:
            if long_buf is None:
                long_buf = buf.long()
            table = torch.from_numpy(
                program.charset_table[program.charset_ids[op.charset]]
            ).to(dev)
            cs_ok[op.charset] = table[long_buf]

    esc_ops = esc_quote_op_flags(program)
    esc_mask = escaped_lead_positions(buf) if esc_ops else None
    esc_hit = torch.zeros(B, dtype=torch.bool, device=dev)

    def first_at_or_after(usable: torch.Tensor) -> torch.Tensor:
        return torch.where(usable, pos, L).amin(dim=1)

    def check_charset(start, end, op, valid):
        if op.charset != CS_ANY:
            outside = (pos < start[:, None]) | (pos >= end[:, None])
            valid = valid & (cs_ok[op.charset] | outside).all(dim=1)
        width = end - start
        ok = valid & (width >= op.min_len)
        if op.max_len:
            ok = ok & (width <= op.max_len)
        return ok

    n_tok = len(program.tokens)
    starts: List[torch.Tensor] = [zeros] * n_tok
    ends: List[torch.Tensor] = [zeros] * n_tok
    cursor = zeros
    valid = torch.ones(B, dtype=torch.bool, device=dev)
    for oi, op in enumerate(program.ops):
        if op.kind == "lit":
            ok = (lit_masks[op.lit] & (pos == cursor[:, None])).any(dim=1)
            valid = valid & ok
            cursor = cursor + len(op.lit)
        elif op.kind == "until_lit":
            usable = lit_masks[op.lit] & (pos >= cursor[:, None])
            if oi in esc_ops:
                found = first_at_or_after(usable & ~esc_mask)
                first_skip = first_at_or_after(usable & esc_mask)
                had_skip = first_skip < found
                if esc_ops[oi]:
                    esc_hit = esc_hit | had_skip
                else:
                    valid = valid & ~had_skip
            else:
                found = first_at_or_after(usable)
            token_valid = found < L
            start = cursor
            end = torch.where(token_valid, found, cursor)
            valid = check_charset(start, end, op, valid & token_valid)
            starts[op.token_index] = start
            ends[op.token_index] = end
            cursor = end + len(op.lit)
        elif op.kind == "to_end":
            start = cursor
            end = lengths
            valid = check_charset(start, end, op, valid)
            starts[op.token_index] = start
            ends[op.token_index] = end
            cursor = end
        else:  # pragma: no cover
            raise AssertionError(op.kind)
    valid = valid & (cursor == lengths)

    ops_list = list(program.ops)
    plausible = torch.ones(B, dtype=torch.bool, device=dev)
    p_cursor = zeros
    for idx, op in enumerate(ops_list):
        if not op.lit:
            continue  # to_end: handled via the preceding separator
        k = len(op.lit)
        remaining = ops_list[idx + 1:]
        is_final_sep = not any(o.lit for o in remaining)
        usable = lit_masks[op.lit]
        if idx == 0 and op.kind == "lit":
            usable = usable & (pos == 0)
        else:
            usable = usable & (pos >= p_cursor[:, None])
        if is_final_sep and not remaining:
            usable = usable & (pos == len_col - k)
        elif is_final_sep and remaining[0].kind == "to_end":
            tail = remaining[0]
            if tail.charset != CS_ANY and not tail.narrow:
                bad = ~cs_ok[tail.charset] & (pos < len_col)
                last_bad = torch.where(bad, pos, -1).amax(dim=1)
                usable = usable & (pos >= (last_bad - k + 1)[:, None])
        found = first_at_or_after(usable)
        plausible = plausible & (found < L)
        p_cursor = found + k

    flags = (valid.to(torch.int32) * SPLIT_VALID
             | plausible.to(torch.int32) * SPLIT_PLAUSIBLE
             | esc_hit.to(torch.int32) * SPLIT_ESC_HIT)
    return torch.stack(starts), torch.stack(ends), flags


# ---------------------------------------------------------------------------
# Per-parser tables: the program, plans and layout as small int32 arrays.
# ---------------------------------------------------------------------------

OP_LIT, OP_UNTIL, OP_TO_END = 0, 1, 2
_OP_KIND = {"lit": OP_LIT, "until_lit": OP_UNTIL, "to_end": OP_TO_END}
OPW = 9          # split op table width
MAX_PLANES = 31  # byte-class planes per program (bits of one uint32)
MAX_TOKENS = 64

TASK_SPAN, TASK_LONG, TASK_SECMILLIS = 0, 1, 2
PART_DIRECT, PART_METHOD, PART_URI, PART_PROTOCOL = 0, 1, 2, 3
PART_PV_PROTOCOL, PART_PV_VERSION = 4, 5   # "pv" sub-steps of the fl protocol
# Upstream-list elements: element 0 is the token's span (ok unless a CLF
# dash), a higher index is absent.
PART_ULIST0, PART_ULIST_ABSENT = 6, 7
# A long task's part: the plain long, or the number -> CLF conversion
# (no >19-digit patch; the task's last column is its leading-zero row).
LONG_PLAIN, LONG_ZERO_NULL = 0, 1
_FL_PART = {"method": PART_METHOD, "uri": PART_URI, "protocol": PART_PROTOCOL}
_PV_PART = {"protocol": PART_PV_PROTOCOL, "version": PART_PV_VERSION}
TASKW = 12       # span_stages task table width

# uri_split parts: spans write (start, len, ok, null, amp, fix); the port
# writes the long frame (hi, lo, d18, ndig, ok, null, big).
URI_PATH, URI_QUERY, URI_PROTOCOL, URI_USERINFO, URI_HOST, URI_REF, URI_PORT = range(7)
_URI_PART = {"path": URI_PATH, "query": URI_QUERY, "protocol": URI_PROTOCOL,
             "userinfo": URI_USERINFO, "host": URI_HOST, "ref": URI_REF,
             "port": URI_PORT}
URIW = 10        # uri_split part table width: part, clf, out0..out6, prefix row

# Line-constraint kinds of pack_rows, applied in plan order:
CONS_REQUIRE = 0       # valid &= comp != 0
CONS_CSR_OVERFLOW = 1  # o = comp != 0 & valid; valid &= ~o; bit 2 |= o
CONS_URI_OVERFLOW = 2  # o = comp != 0;         valid &= ~o; bit 2 |= o
CONS_FORBID = 3        # valid &= comp == 0 (an IPv6 literal on a geo token,
                       # a Set-Cookie quirk, a zero_null leading zero)
CONS_NEVER = 4         # valid = False (a plausibility-only probe unit)

# The rows ipv4_spans writes for one IP token in its unit's component
# block, which every geo group over the token reads (each writes its own
# geo_lookup row).
GEO_VALUE, GEO_IP_OK, GEO_COLON, GEO_CHAIN_OK = range(4)

# Rows of one muid group, in the order the muid kernel writes them.
MUID_ROWS = ("time", "ip", "pid", "thread", "counter", "ok")

# timestamp item kinds; a table item's entries are rows of ``entries``.
ITEM_LIT, ITEM_NUM, ITEM_MONTH, ITEM_DOW, ITEM_AMPM, ITEM_ZONE = range(6)
_TABLE_KIND = {("name", "month"): ITEM_MONTH, ("name", "dayofweek"): ITEM_DOW,
               ("ampm", "ampm"): ITEM_AMPM, ("zone", "zone"): ITEM_ZONE}
TAIL_KIND = {"": 0, "offset": 1, "offset_colon": 2}
MAX_UNITS = 8


def _i32(rows, width: int) -> torch.Tensor:
    arr = np.zeros((len(rows), width), dtype=np.int32)
    for i, r in enumerate(rows):
        arr[i, : len(r)] = r
    return torch.from_numpy(arr)


class SplitTables(nn.Module):
    """One program as int32 tables for the ``split`` kernel.

    Byte classes: planes ``[0, n_byte)`` are "byte == b" for each
    distinct separator byte, planes ``[n_byte, P)`` are "byte violates
    charset c" for each bounded charset an op validates; ``cls[v]`` has
    bit i set when byte value v is in plane i.  ``ops`` rows are
    (kind, lit, token, viol plane, min_len, max_len, esc mode
    0/1 final/2 non-final, plausibility flags 1 has-lit | 2 first-anchor |
    4 end-anchor, last-bad plane); ``lits`` rows are (length, plane of
    each byte)."""

    def __init__(self, program: DeviceProgram):
        super().__init__()
        self.program = program
        ops = list(program.ops)
        lits = sorted({op.lit for op in ops if op.lit})
        lit_bytes = sorted({b for lit in lits for b in lit})
        charsets = sorted({
            op.charset for op in ops
            if op.kind != "lit" and op.charset != CS_ANY
        })
        self.n_planes = len(lit_bytes) + len(charsets)
        if self.n_planes > MAX_PLANES:
            raise ValueError(f"{self.n_planes} byte classes (max {MAX_PLANES})")
        if len(program.tokens) > MAX_TOKENS:
            raise ValueError(f"{len(program.tokens)} tokens (max {MAX_TOKENS})")
        plane_of_byte = {b: i for i, b in enumerate(lit_bytes)}
        plane_of_cs = {cs: len(lit_bytes) + i for i, cs in enumerate(charsets)}
        cls = np.zeros(256, dtype=np.int64)
        for b, i in plane_of_byte.items():
            cls[b] |= 1 << i
        for cs, i in plane_of_cs.items():
            admitted = program.charset_table[program.charset_ids[cs]]
            cls[~admitted] |= 1 << i
        lit_id = {lit: i for i, lit in enumerate(lits)}
        esc = esc_quote_op_flags(program)
        rows = []
        for idx, op in enumerate(ops):
            pflags, lastbad = 0, -1
            if op.lit:
                pflags = 1
                remaining = ops[idx + 1:]
                is_final_sep = not any(o.lit for o in remaining)
                if idx == 0 and op.kind == "lit":
                    pflags |= 2
                if is_final_sep and not remaining:
                    pflags |= 4
                elif is_final_sep and remaining[0].kind == "to_end":
                    tail = remaining[0]
                    if tail.charset != CS_ANY and not tail.narrow:
                        lastbad = plane_of_cs[tail.charset]
            rows.append((
                _OP_KIND[op.kind],
                lit_id[op.lit] if op.lit else -1,
                op.token_index,
                plane_of_cs.get(op.charset, -1) if op.kind != "lit" else -1,
                op.min_len, op.max_len,
                0 if idx not in esc else (1 if esc[idx] else 2),
                pflags, lastbad,
            ))
        self.lit_width = 1 + max((len(lit) for lit in lits), default=0)
        self.has_esc = bool(esc)
        self.n_tok = len(program.tokens)
        self.register_buffer("cls", torch.from_numpy(cls.astype(np.uint32).view(np.int32)))
        self.register_buffer("ops", _i32(rows, OPW))
        self.register_buffer("lits", _i32(
            [(len(lit),) + tuple(plane_of_byte[b] for b in lit) for lit in lits],
            self.lit_width,
        ))




@dataclass
class _UriGroup:
    """One URI split (one per (token, steps) prefix): its input span --
    the token's cursors (``src`` all -1) or three span_stages rows (start,
    len, ok) -- the CLF dash flag of a direct token, its part rows and
    its two line-constraint rows."""

    token: int
    src: Tuple[int, int, int]
    dash: bool
    parts: List[Tuple] = dataclass_field(default_factory=list)
    cons: int = -1
    over: int = -1
    query: Tuple[int, int, int] = (-1, -1, -1)


@dataclass
class _CsrGroup:
    """One CSR split: its mode (``query`` / ``cookie`` / ``setcookie``),
    its input span (the rows of a URI query part, or ``src`` all -1: the
    cursors of ``token``), the first of its 2 x slots packed segment
    words, and its ok, overflow and (Set-Cookie) bad rows."""

    key: str
    mode: str
    token: int
    src: Tuple[int, int, int]
    words: int
    ok: int
    over: int
    bad: int = -1


@dataclass
class _MuidGroup:
    """One mod_unique_id decode: its token and the first of its 6 rows
    (MUID_ROWS)."""

    key: str
    token: int
    base: int


@dataclass
class _GeoGroup:
    """One GeoIP range join (one per ``geo_group_key``): its token, its
    GeoDeviceTable, the first of its token's 4 ipv4_spans rows (GEO_VALUE
    .. GEO_CHAIN_OK, shared by every group over the token) and its own
    geo_lookup row."""

    key: str
    token: int
    table: object
    ip: int = -1
    row: int = -1


@dataclass
class _UnitComps:
    """Component rows of one unit: span_stages tasks (rows [0,
    n_stage_rows)), then 4 rows (c1, c2, off, ok) per timestamp group, 4
    per IP token of the geo groups (``ip_groups``: (token, first row)) and
    one per geo group, then the URI and CSR groups' rows; the line
    constraints in the order pack_rows applies them and the slot every
    component is packed into."""

    tasks: List[Tuple] = dataclass_field(default_factory=list)
    n_stage_rows: int = 0
    ts_groups: List[Tuple[str, int, object]] = dataclass_field(default_factory=list)
    geo_groups: List[_GeoGroup] = dataclass_field(default_factory=list)
    ip_groups: List[Tuple[int, int]] = dataclass_field(default_factory=list)
    muid_groups: List[_MuidGroup] = dataclass_field(default_factory=list)
    uri_groups: List[_UriGroup] = dataclass_field(default_factory=list)
    csr_groups: List[_CsrGroup] = dataclass_field(default_factory=list)
    need_authority: bool = False
    constraints: List[Tuple[int, int]] = dataclass_field(default_factory=list)
    puts: List[Tuple[int, Slot]] = dataclass_field(default_factory=list)
    prefix: Dict[str, int] = dataclass_field(default_factory=dict)
    start_row: Dict[str, int] = dataclass_field(default_factory=dict)
    n_rows: int = 0


def _stage_part(steps) -> int:
    """The span_stages part of a span chain that needs no URI split."""
    if not steps:
        return PART_DIRECT
    if len(steps) == 1 and steps[0][0] == "fl":
        return _FL_PART[steps[0][1]]
    if len(steps) == 2 and steps[0] == ("fl", "protocol") and steps[1][0] == "pv":
        return _PV_PART[steps[1][1]]
    raise ValueError(f"span chain {steps} is not on this slice")


def _uri_chained(plan: FieldPlan) -> bool:
    return bool(plan.steps) and plan.steps[-1][0] == "uri"


def unit_components(unit: FormatUnit, view_fields: Sequence[str]) -> _UnitComps:
    """Assign component rows for one unit (the reference's compute_rows
    as tables): span_stages rows first, in plan order, then the
    timestamp, geo and muid groups, then one URI group per (token, steps)
    prefix and one CSR group per ``csr_group_key``.  A plausibility-only
    unit has no rows and one constraint that clears its valid bit."""
    uc = _UnitComps()
    if unit.plausibility_only:
        uc.constraints.append((0, CONS_NEVER))
        return uc
    plans = [p for p in unit.plans if p.kind != "host"]
    slots = unit.layout.slots
    view_set = set(view_fields)
    names: List[Tuple[object, str]] = []   # (slot key or None, comp) per row

    def row(key, comp: str) -> int:
        names.append((key, comp))
        return len(names) - 1

    def prefix_rows(fid: str) -> int:
        if fid not in view_set:
            return -1
        uc.prefix[fid] = row(None, "view0")
        row(None, "view1")
        row(None, "view2")
        uc.start_row[fid] = slots[fid]["start"][0]
        return uc.prefix[fid]

    chain: Dict[tuple, Tuple[int, int, int]] = {}
    long_ok: Dict[str, int] = {}
    lead0: Dict[str, int] = {}

    def stage_span(fid, key, tok, part) -> Tuple[int, int, int]:
        outs = [row(key, c) for c in ("start", "len", "ok", "null")]
        pfx = prefix_rows(fid) if key is not None else -1
        uc.tasks.append((TASK_SPAN, tok, part, 0, *outs, 0, 0, 0, pfx))
        return tuple(outs[:3])

    # Pass 1: span_stages tasks (direct / fl / pv spans, upstream-list
    # elements, direct longs, and the first-line URI span every URI split
    # over it reads) and the timestamp, geo and muid groups.
    for plan in plans:
        fid, tok = plan.field_id, plan.token_index
        if plan.kind in ("span", "long", "qscsr") and _uri_chained(plan):
            prefix = plan.steps[:-1]
            if prefix not in ((), (("fl", "uri"),)):
                raise ValueError(f"URI chain {plan.steps} is not on this slice")
            if prefix and (tok, prefix) not in chain:
                chain[(tok, prefix)] = stage_span(fid, None, tok, _stage_part(prefix))
        elif plan.kind == "span":
            src = stage_span(fid, fid, tok, _stage_part(plan.steps))
            chain.setdefault((tok, plan.steps), src)
        elif plan.kind == "ulist":
            if plan.steps:
                raise ValueError(f"ulist chain {plan.steps} is not on this slice")
            stage_span(fid, fid, tok,
                       PART_ULIST0 if plan.meta[0] == 0 else PART_ULIST_ABSENT)
        elif plan.kind == "long":
            if plan.steps or plan.scale != 1 or plan.null_mode not in (
                "", "dash_null", "dash_zero", "zero_null"
            ):
                raise ValueError(f"long plan {plan} is not on this slice")
            comps = ("hi", "lo", "d18", "lo_digits", "ok", "null", "big")
            outs = [row(fid, c) for c in comps]
            long_ok[fid] = outs[4]
            clf = int(plan.null_mode in ("dash_null", "dash_zero"))
            if plan.null_mode == "zero_null":
                lead0[fid] = row(None, "lead0")
                uc.tasks.append((TASK_LONG, tok, LONG_ZERO_NULL, clf, *outs, lead0[fid]))
            else:
                uc.tasks.append((TASK_LONG, tok, LONG_PLAIN, clf, *outs, -1))
        elif plan.kind == "secmillis":
            if plan.steps or plan.null_mode:
                raise ValueError(f"secmillis plan {plan} is not on this slice")
            comps = ("hi", "lo", "d18", "lo_digits", "ok", "null", "big", "milli")
            outs = [row(fid, c) for c in comps]
            long_ok[fid] = outs[4]
            uc.tasks.append((TASK_SECMILLIS, tok, 0, 0, *outs))
        elif plan.kind == "geo":
            if plan.steps:
                raise ValueError(f"geo chain {plan.steps} is not on this slice")
            key = geo_group_key(plan)
            if all(g.key != key for g in uc.geo_groups):
                uc.geo_groups.append(_GeoGroup(key, tok, plan.meta[2]))
        elif plan.kind == "ts":
            if plan.steps:
                raise ValueError(f"ts chain {plan.steps} is not on this slice")
            key = ts_group_key(plan)
            if all(k != key for k, _, _ in uc.ts_groups):
                uc.ts_groups.append((key, tok, plan.meta))
        elif plan.kind == "muid":
            if plan.steps:
                raise ValueError(f"muid chain {plan.steps} is not on this slice")
            key = muid_group_key(plan)
            if all(g.key != key for g in uc.muid_groups):
                uc.muid_groups.append(_MuidGroup(key, tok, -1))
        elif plan.kind != "qscsr" or plan.steps:
            raise ValueError(f"plan {plan.kind} {plan.steps} is not on this slice")
    uc.n_stage_rows = len(names)
    for key, _, _ in uc.ts_groups:
        for comp in ("c1", "c2", "off", "ok"):
            row(key, comp)
    ip_rows: Dict[int, int] = {}
    for g in uc.geo_groups:
        if g.token not in ip_rows:
            ip_rows[g.token] = row(None, "geo_value")
            for comp in ("geo_ip_ok", "geo_colon", "geo_chain_ok"):
                row(None, comp)
        g.ip = ip_rows[g.token]
        g.row = row(g.key, "row")
    uc.ip_groups = list(ip_rows.items())
    for g in uc.muid_groups:
        g.base = len(names)
        for comp in MUID_ROWS:
            row(g.key, comp)

    # Pass 2: URI and CSR groups, in plan order.
    uri_groups: Dict[tuple, _UriGroup] = {}
    csr_groups: Dict[str, _CsrGroup] = {}
    uc.need_authority = any(
        ("uri", part) in plan.steps for plan in plans
        for part in ("host", "userinfo", "port")
    )

    def uri_group(tok, prefix) -> _UriGroup:
        g = uri_groups.get((tok, prefix))
        if g is None:
            src = chain[(tok, prefix)] if prefix else (-1, -1, -1)
            g = _UriGroup(tok, src, dash=not prefix)
            g.cons, g.over = row(None, "uri_ok"), row(None, "uri_over")
            uri_groups[(tok, prefix)] = g
            uc.uri_groups.append(g)
        return g

    def uri_span(g: _UriGroup, fid, key, part: str) -> None:
        outs = [row(key, c) for c in ("start", "len", "ok", "null", "amp", "fix")]
        pfx = prefix_rows(fid) if key is not None else -1
        g.parts.append((_URI_PART[part], 0, *outs, -1, pfx))
        if part == "query" and g.query[0] < 0:
            g.query = tuple(outs[:3])

    def csr_group(plan, src) -> None:
        key = csr_group_key(plan)
        words = len(names)
        for k in range(unit.layout.csr_slots):
            row(key, f"@n{k}")
            row(key, f"@v{k}")
        cg = _CsrGroup(key, plan.meta, plan.token_index, src, words=words,
                       ok=row(key, "ok"), over=row(None, "csr_over"))
        if plan.meta == "setcookie":
            cg.bad = row(None, "setcookie_bad")
        csr_groups[key] = cg
        uc.csr_groups.append(cg)

    for plan in plans:
        if plan.kind == "qscsr" and not plan.steps:
            if csr_group_key(plan) not in csr_groups:
                csr_group(plan, (-1, -1, -1))
            continue
        if not _uri_chained(plan):
            continue
        fid, tok = plan.field_id, plan.token_index
        g = uri_group(tok, plan.steps[:-1])
        part = plan.steps[-1][1]
        if plan.kind == "span":
            uri_span(g, fid, fid, part)
        elif plan.kind == "long":
            if part != "port" or plan.scale != 1 or plan.null_mode not in (
                "", "dash_null", "dash_zero"
            ):
                raise ValueError(f"long plan {plan} is not on this slice")
            outs = [row(fid, c) for c in
                    ("hi", "lo", "d18", "lo_digits", "ok", "null", "big")]
            clf = int(plan.null_mode in ("dash_null", "dash_zero"))
            g.parts.append((URI_PORT, clf, *outs, -1))
        else:  # qscsr
            if plan.meta != "query" or part != "query":
                raise ValueError(f"{plan.meta} CSR {plan.steps} is not on this slice")
            if csr_group_key(plan) in csr_groups:
                continue
            if g.query[0] < 0:
                uri_span(g, fid, None, "query")
            csr_group(plan, g.query)
    uc.n_rows = len(names)

    # Pass 3: line constraints in plan order (the reference's running
    # `valid`), the URI constraints last (its line_constraints).
    seen = set()
    geo_ip = {g.key: g.ip for g in uc.geo_groups}
    for plan in plans:
        if plan.kind in ("long", "secmillis") and not plan.steps:
            uc.constraints.append((long_ok[plan.field_id], CONS_REQUIRE))
            if plan.field_id in lead0:
                uc.constraints.append((lead0[plan.field_id], CONS_FORBID))
        elif plan.kind == "geo" and ("geo", plan.token_index) not in seen:
            # An IPv6 literal: the host looks it up, the table is IPv4.
            # One constraint a token: its groups share the row.
            seen.add(("geo", plan.token_index))
            uc.constraints.append((geo_ip[geo_group_key(plan)] + GEO_COLON, CONS_FORBID))
        elif plan.kind == "ts" and ts_group_key(plan) not in seen:
            seen.add(ts_group_key(plan))
            g = [k for k, _, _ in uc.ts_groups].index(ts_group_key(plan))
            uc.constraints.append((uc.n_stage_rows + 4 * g + 3, CONS_REQUIRE))
        elif plan.kind == "qscsr" and csr_group_key(plan) not in seen:
            seen.add(csr_group_key(plan))
            cg = csr_groups[csr_group_key(plan)]
            if cg.bad >= 0:   # Set-Cookie host quirks: the oracle decides
                uc.constraints.append((cg.bad, CONS_FORBID))
            uc.constraints.append((cg.over, CONS_CSR_OVERFLOW))
    for g in uc.uri_groups:
        uc.constraints += [(g.cons, CONS_REQUIRE), (g.over, CONS_URI_OVERFLOW)]

    for r, (key, comp) in enumerate(names):
        if key is None:
            continue
        if comp.startswith("@n"):
            uc.puts.append((r, (slots[key][f"s{comp[2:]}_start"][0], 0, 0)))
        elif comp.startswith("@v"):
            uc.puts.append((r, (slots[key][f"s{comp[2:]}_vstart"][0], 0, 0)))
        else:
            uc.puts.append((r, slots[key][comp]))
    for g in uc.geo_groups:   # the token's chain_ok row, into each group's slot
        uc.puts.append((g.ip + GEO_CHAIN_OK, slots[g.key]["ok"]))
    return uc


class StageTables(nn.Module):
    """One unit's span_stages tasks: rows (kind, token, part, clf, out0..
    out6, prefix row) with output rows relative to the kernel's output.
    A span task writes (start, len, ok, null) and, when its field emits
    view rows, 3 prefix words from ``prefix row``; a long task writes
    (hi, lo, d18, ndig, ok, null, big); a secmillis task the same seven
    for the seconds part and the millis into its last column's row."""

    def __init__(self, uc: _UnitComps):
        super().__init__()
        self.tasks_py = list(uc.tasks)
        self.n_out = uc.n_stage_rows
        self.register_buffer("tasks", _i32(self.tasks_py, TASKW))


# Dynamic shared memory one block of an H100 may hold (227 KB), less 16
# bytes for the barrier of a kernel that stages its tables there.
SMEM_TABLE_BUDGET = 232_448 - 16


def _pad16(raw: bytes) -> bytes:
    """A table region padded to 16 bytes (a TMA bulk copy's granule)."""
    return raw + bytes(-len(raw) % 16)


class ZoneTables(nn.Module):
    """A ``ZoneDeviceTable`` for the ``zone_lookup`` kernel, as the one
    ``image`` each block stages into shared memory: the coarse index
    (uint16 [Z << (26 - index_bits)], :meth:`ZoneDeviceTable.coarse_index`,
    at most ``chain`` forward steps), ``packed`` [T, 2] (key, offset +
    bias, uint32) from byte ``packed_at`` and ``valid_until`` [Z] from
    ``valid_at``, each region padded to 16 bytes; ``smem_bytes`` in all.
    Raises ValueError when the image passes SMEM_TABLE_BUDGET, or the
    vocabulary has no transition or 65,536 of them."""

    def __init__(self, table):
        super().__init__()
        self.table = table
        T = len(table.keys)
        if T == 0:
            raise ValueError("an empty zone vocabulary has no table")
        index, self.chain = table.coarse_index()
        self.index_bits = table.INDEX_BITS
        self.n_zones = len(table.zones)
        self.n_transitions = T
        regions = [_pad16(index.tobytes()), _pad16(table.packed().tobytes()),
                   _pad16(table.valid_until.astype(np.int32).tobytes())]
        self.packed_at = len(regions[0])
        self.valid_at = self.packed_at + len(regions[1])
        self.smem_bytes = self.valid_at + len(regions[2])
        if self.smem_bytes > SMEM_TABLE_BUDGET:
            raise ValueError(
                f"zone tables need {self.smem_bytes} bytes of shared memory (index "
                f"{len(regions[0])}, {T} transitions {len(regions[1])}, windows "
                f"{len(regions[2])}); a block holds {SMEM_TABLE_BUDGET}")
        self.register_buffer("image", torch.from_numpy(
            np.frombuffer(b"".join(regions), dtype=np.int32).copy()))


class TsTables(nn.Module):
    """One timestamp group: the DeviceTimeLayout as the image the timestamp
    kernel reads (``index``, :func:`_ts_index`), the bytes a line's items
    and tail can read from its span start (``window``) and the kernel's
    register path for the layout (``fixed``, :func:`_fixed_layout`).  A %Z
    layout also carries its :class:`ZoneTables` (``zone``)."""

    def __init__(self, token_index: int, dl: timeparse.DeviceTimeLayout):
        super().__init__()
        self.token_index = token_index
        self.layout = dl
        self.tail = TAIL_KIND[dl.tail]
        self.window = sum(dl.windows()) + (timeparse.TAIL_WIDTH if dl.tail else 0)
        self.fixed = _fixed_layout(dl)
        self.register_buffer("index", torch.tensor(_ts_index(dl), dtype=torch.int32))
        self.zone = ZoneTables(dl.zone_table) if dl.zone_table is not None else None


# Apache's dd/MMM/yyyy:HH:mm:ss ZZ in English, item by item (kind, offset,
# width, field or text); the hour item is (num, 12, 2, hour or clock_hour).
_FIXED_ITEMS = (("num", 0, 2, "day"), ("lit", 2, 1, b"/"), ("name", 3, 3, "month"),
                ("lit", 6, 1, b"/"), ("num", 7, 4, "year"), ("lit", 11, 1, b":"), None,
                ("lit", 14, 1, b":"), ("num", 15, 2, "minute"), ("lit", 17, 1, b":"),
                ("num", 18, 2, "second"), ("lit", 20, 1, b" "))
_FIXED_HOURS = {"hour": 1, "clock_hour": 2}


def _fixed_layout(dl: timeparse.DeviceTimeLayout) -> int:
    """The timestamp kernel's register path: Apache's segment followed by
    a numeric offset (%t, strftime's %d/%b/%Y:%H:%M:%S %z), its hour the
    hour (1) or strftime's clock hour %H (2); else 0 (the interpreted
    path, %Z's included)."""
    if not (len(dl.segments) == 1 and dl.seg_widths == (21,) and dl.tail == "offset"
            and dl.zone_table is None and dl.min_prefix == 21
            and len(dl.segments[0]) == len(_FIXED_ITEMS)):
        return 0
    months = tuple(m.encode() for m in MONTHS_SHORT)
    hour = 0
    for it, want in zip(dl.segments[0], _FIXED_ITEMS):
        if want is None:
            if (it.kind, it.offset, it.width) != ("num", 12, 2) or it.field not in _FIXED_HOURS:
                return 0
            hour = _FIXED_HOURS[it.field]
            continue
        kind, off, width, what = want
        if (it.kind, it.offset, it.width) != (kind, off, width):
            return 0
        if (kind == "lit" and it.text != what) or (kind == "num" and it.field != what) or (
                kind == "name" and (it.field != what or it.table != months)):
            return 0
    return hour


_ZONE_TOKEN = frozenset(b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_/+-")


def _ts_pattern(data: bytes, fold: bool, nw: int) -> List[int]:
    """A pattern of the timestamp kernel: ``nw`` want words (the bytes
    little-endian, a letter lowered where it compares case-folded), then
    ``nw`` fold-mask words (0x20 at those letters)."""
    want, mask = bytearray(4 * nw), bytearray(4 * nw)
    for i, c in enumerate(data):
        letter = fold and ord("a") <= (c | 0x20) <= ord("z")
        want[i], mask[i] = (c | 0x20, 0x20) if letter else (c, 0)
    words = np.frombuffer(bytes(want) + bytes(mask), dtype="<u4").astype(np.int64)
    return [int(w) - (1 << 32) if w >= 1 << 31 else int(w) for w in words]


def _token_hash(token: bytes) -> int:
    """The timestamp kernel's hash of a zone token: its length, then its
    words with every byte OR 0x20 (case-folded letters; the other token
    bytes keep their identity), the last one cut to the token."""
    m = 0xFFFFFFFF
    h = (len(token) * 0x9E3779B1) & m
    folded = bytes(c | 0x20 for c in token)
    for k in range(0, len(folded), 4):
        h = ((h ^ int.from_bytes(folded[k:k + 4], "little")) * 0x85EBCA6B) & m
        h ^= h >> 13
    return h ^ (h >> 16)


def _ts_index(dl: timeparse.DeviceTimeLayout) -> List[int]:
    """The image the timestamp kernel stages into shared memory (its
    layout is spelled out in ``csrc/timestamp.cu``): the segment rows
    (width or -1, first item, item count) and item rows (kind, offset,
    width, arg, count), a numeric item's arg its index in
    ``timeparse.NUM_FIELDS``, any other item's its pattern or table in the
    image."""
    segs, n_items = [], 0
    for seg, seg_w in zip(dl.segments, dl.seg_widths):
        segs.append((seg_w, n_items, len(seg)))
        n_items += len(seg)
    head = [len(segs), n_items] + [v for row in segs for v in row]
    at = len(head) + 5 * n_items
    rows, blocks = [], []
    for it in (it for seg in dl.segments for it in seg):
        if it.kind == "num":
            rows.append((ITEM_NUM, it.offset, it.width, timeparse.NUM_FIELDS.index(it.field), 0))
            continue
        if it.kind == "lit":
            kind, count = ITEM_LIT, 0
            block = _ts_pattern(it.text, True, (it.width + 3) // 4)
        else:
            kind, count = _TABLE_KIND[it.kind, it.field], len(it.table)
            zone = kind == ITEM_ZONE
            nw = (max(len(e) for e in it.table) + 3) // 4
            recs = []
            for n, e in enumerate(it.table):
                fold = it.fold_flags[n] if zone else True
                zi = it.zone_idx[n] if zone else 0
                if zone and not (e and set(e) <= _ZONE_TOKEN):
                    raise ValueError(f"zone entry {e!r} is not a zone token")
                recs.append([len(e) | int(fold) << 8 | n << 16, zi]
                            + _ts_pattern(e, fold, nw))
            block = [2 + 2 * nw, recs[0][1]]
            if zone:
                nb = 2
                while nb < 2 * len(recs):
                    nb *= 2
                bucket = [_token_hash(e) & (nb - 1) for e in it.table]
                order = sorted(range(len(recs)), key=lambda n: (bucket[n], n))
                starts = np.searchsorted(np.array(sorted(bucket)), np.arange(nb + 1))
                block += [nb] + [int(x) for x in starts]
                recs = [recs[n] for n in order]
            block += [v for r in recs for v in r]
        rows.append((kind, it.offset, it.width, at, count))
        blocks += block
        at += len(block)
    return head + [v for row in rows for v in row] + blocks


# The most splitters a geo_lookup block stages: 32 KB of shared memory.
GEO_SPLITTERS = 8192


class IpTables(nn.Module):
    """One IP token for ``ipv4_spans``: the token and the first of the 4
    component rows (GEO_VALUE .. GEO_CHAIN_OK) that every geo group over
    it reads."""

    def __init__(self, token: int, base: int):
        super().__init__()
        self.token_index = token
        self.base = base


class GeoTables(nn.Module):
    """One GeoIP group for ``geo_lookup``: the token, the first of its
    token's 4 ipv4_spans rows (``ip``), its own row (``row``), and the
    table's ``starts`` / ``ends`` as int32 buffers (uint32 bit patterns),
    uploaded once.

    For the kernel's two-level search, ``image`` is what each block
    stages into shared memory: the splitters, every S-th start (S =
    2^``split_shift``, the least with ceil(K / S) <= GEO_SPLITTERS;
    ``n_split`` of them), and with S = 1 the ends from word ``ends_at``
    (else -1), each region padded with zeros to 16 bytes; ``smem_bytes``
    in all.  A key's search over the splitters leaves the S starts from
    its splitter on to search in device memory.  ``lockstep``: the keys
    whose device-memory searches one thread keeps in flight side by side
    -- 4 above S = 16 (halving steps, then a window), 2 up to it (the
    window alone), 1 at S = 1, where no level reads device memory."""

    def __init__(self, g: _GeoGroup):
        super().__init__()
        self.key = g.key
        self.token_index = g.token
        self.ip, self.row = g.ip, g.row
        self.table = g.table
        starts, ends = g.table.starts, g.table.ends
        K = len(starts)
        self.split_shift = 0
        while -(-K >> self.split_shift) > GEO_SPLITTERS:
            self.split_shift += 1
        regions = [starts[::1 << self.split_shift]]
        self.n_split = len(regions[0])
        if self.split_shift == 0 and K:
            regions.append(ends)
        regions = [np.concatenate([r, np.zeros(-len(r) % 4, dtype=np.uint32)]) for r in regions]
        self.ends_at = len(regions[0]) if len(regions) == 2 else -1
        image = np.concatenate(regions) if regions else np.zeros(0, np.uint32)
        self.smem_bytes = 4 * len(image)
        self.lockstep = 4 if self.split_shift > 4 else (2 if self.split_shift else 1)
        self.register_buffer("starts", u32_bits(starts))
        self.register_buffer("ends", u32_bits(ends))
        self.register_buffer("image", u32_bits(image))


class UriTables(nn.Module):
    """One URI group for the ``uri_split`` kernel: the input (token, or
    the span_stages rows of its start / len / ok), the CLF dash flag,
    ``need_authority``, the scan window, the constraint rows and ``parts``
    rows (part, clf, out0..out6, prefix row), rows relative to the unit's
    component block."""

    def __init__(self, g: _UriGroup, need_authority: bool, window: int):
        super().__init__()
        self.token_index = g.token
        self.src = g.src
        self.dash = g.dash
        self.need_authority = need_authority
        self.window = window
        self.cons, self.over = g.cons, g.over
        self.parts_py = list(g.parts)
        self.register_buffer("parts", _i32(self.parts_py, URIW))


class CsrTables(nn.Module):
    """One CSR group: for ``csr_split`` a query string or a Cookie header
    -- the rows of its input span (a URI query part: the split starts
    past a leading '?' and the URI encode set flags names and values) or
    its token's cursors (a CLF dash reads not-ok) -- its separator, slot
    count and scan window; for ``setcookie_split`` a Set-Cookie list over
    its token's cursors.  Output rows: 2 packed words per slot, ok,
    overflow and, for a Set-Cookie list, bad."""

    def __init__(self, g: _CsrGroup, slots: int):
        super().__init__()
        self.key = g.key
        self.mode = g.mode
        self.token_index = g.token
        self.src = g.src
        self.slots = slots
        self.window = CSR_WINDOW_PER_SLOT * slots
        self.words, self.ok, self.over, self.bad = g.words, g.ok, g.over, g.bad
        self.sep = CSR_SEPARATORS.get(g.mode, b"")
        self.uri_encoded = g.src[0] >= 0
        self.register_buffer("cls", torch.from_numpy(
            postproc.csr_class_table(self.uri_encoded, self.sep or b"&").astype(np.int32)))


class MuidTables(nn.Module):
    """One mod_unique_id group for the ``muid`` kernel: its token and the
    first of its 6 rows of the unit block."""

    def __init__(self, g: _MuidGroup):
        super().__init__()
        self.key = g.key
        self.token_index = g.token
        self.base = g.base


class UnitTables(nn.Module):
    """One unit's tables; its components start at row ``comp_base`` of
    the executor's component tensor."""

    def __init__(self, unit: FormatUnit, uc: _UnitComps, comp_base: int):
        super().__init__()
        self.split = SplitTables(unit.program)
        self.stages = StageTables(uc)
        self.ts = nn.ModuleList(TsTables(tok, dl) for _, tok, dl in uc.ts_groups)
        self.ip = nn.ModuleList(IpTables(tok, base) for tok, base in uc.ip_groups)
        self.geo = nn.ModuleList(GeoTables(g) for g in uc.geo_groups)
        self.muid = nn.ModuleList(MuidTables(g) for g in uc.muid_groups)
        window = URI_WINDOW_PER_SLOT * unit.layout.csr_slots
        self.uri = nn.ModuleList(UriTables(g, uc.need_authority, window)
                                 for g in uc.uri_groups)
        self.csr = nn.ModuleList(CsrTables(g, unit.layout.csr_slots)
                                 for g in uc.csr_groups)
        self.comp_base = comp_base
        self.n_comp = uc.n_rows


class PackTables(nn.Module):
    """Packing for all units: ``units`` rows (row offset, first
    constraint, constraint count) with ``cons`` rows (component, kind)
    in the order the constraints apply; ``rows`` (unit whose validity row
    this is or -1, first slot, slot count) per output row; ``slots``
    (component, shift, bits); ``views`` (view field, unit, packed row of
    its span word, first prefix component) per (view field, decodable
    unit); ``view_of`` [V, U] the index in ``views`` of each (view field,
    unit) entry, -1 where the unit does not decode the field (the last
    such entry where one repeats: repeats are equal)."""

    def __init__(self, units: Sequence[FormatUnit], ucs: Sequence[_UnitComps],
                 bases: Sequence[int], view_specs: ViewSpecs):
        super().__init__()
        if len(units) > MAX_UNITS:
            raise ValueError(f"{len(units)} formats (max {MAX_UNITS})")
        self.K = sum(u.layout.n_rows for u in units)
        self.U = len(units)
        self.V = len(view_specs)
        unit_rows, cons, per_row = [], [], [[] for _ in range(self.K)]
        row_unit = [-1] * self.K
        for ui, (u, uc, base) in enumerate(zip(units, ucs, bases)):
            unit_rows.append((u.row_offset, len(cons), len(uc.constraints)))
            cons.extend((base + c, kind) for c, kind in uc.constraints)
            row_unit[u.row_offset] = ui
            for c, (r, shift, bits) in uc.puts:
                per_row[u.row_offset + r].append((base + c, shift, bits))
        rows, slots = [], []
        for r in range(self.K):
            rows.append((row_unit[r], len(slots), len(per_row[r])))
            slots.extend(per_row[r])
        views = []
        for vi, (fid, unit_idx) in enumerate(view_specs):
            for ui in unit_idx:
                uc, base = ucs[ui], bases[ui]
                views.append((vi, ui, units[ui].row_offset + uc.start_row[fid],
                              base + uc.prefix[fid]))
        self.units_py, self.cons_py, self.rows_py = unit_rows, cons, rows
        self.slots_py, self.views_py = slots, views
        self.register_buffer("units", _i32(unit_rows, 3))
        self.register_buffer("cons", _i32(cons or [(0, 0)], 2))
        self.register_buffer("rows", _i32(rows, 3))
        self.register_buffer("slots", _i32(slots or [(0, 0, 0)], 3))
        self.register_buffer("views", _i32(views or [(0, 0, 0, 0)], 4))
        self.n_views = len(views)
        view_of = np.full((max(self.V, 1), self.U), -1, dtype=np.int32)
        for i, (vi, ui, _, _) in enumerate(views):
            view_of[vi, ui] = i
        self.view_of_py = view_of[:self.V].tolist()
        self.register_buffer("view_of", torch.from_numpy(view_of))


# ---------------------------------------------------------------------------
# Kernels 2, 4, 5 and 6, plain versions.
# ---------------------------------------------------------------------------


def _clf_dash(buf: torch.Tensor, s: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Token-level CLF null: the span is a lone '-'."""
    return ((e - s) == 1) & (postproc.gather_span_bytes(buf, s, 1)[:, 0] == ord("-"))


def span_stages_plain(
    tables: StageTables, buf: torch.Tensor, starts: torch.Tensor,
    ends: torch.Tensor, out: torch.Tensor,
) -> torch.Tensor:
    """Fill ``out`` [n_out, B] int32 with every span / long task's
    components (the span-chain, upstream-list and numeric branches of the
    reference's compute_rows, plus span_prefix_words for view fields)."""
    B = buf.shape[0]
    fl_cache: Dict[int, Dict[str, torch.Tensor]] = {}
    false_b = torch.zeros(B, dtype=torch.bool, device=buf.device)
    for task in tables.tasks_py:
        kind, tok, part, clf = task[:4]
        s, e = starts[tok], ends[tok]
        if kind == TASK_SPAN:
            o_start, o_len, o_ok, o_null = task[4:8]
            pfx = task[11]
            if part == PART_DIRECT:
                start, end = s, e
                ok = torch.ones(B, dtype=torch.bool, device=buf.device)
                null = _clf_dash(buf, s, e)
            elif part == PART_ULIST0:
                start, end, ok, null = s, e, ~_clf_dash(buf, s, e), false_b
            elif part == PART_ULIST_ABSENT:
                start, end, ok, null = s, s, false_b, false_b
            else:
                fl = fl_cache.get(tok)
                if fl is None:
                    fl = fl_cache[tok] = postproc.split_firstline(buf, s, e)
                name = {PART_METHOD: "method", PART_URI: "uri"}.get(part, "proto")
                start, end = fl[f"{name}_start"], fl[f"{name}_end"]
                ok = fl["ok"] & fl["has_protocol"] if name == "proto" else fl["ok"]
                null = false_b
                if part in (PART_PV_PROTOCOL, PART_PV_VERSION):
                    pv = postproc.split_protocol_version(buf, start, end)
                    if part == PART_PV_PROTOCOL:
                        end = pv["proto_end"]
                    else:
                        start, end = pv["ver_start"], pv["ver_end"]
                    null = pv["null"]
            out[o_start] = start
            out[o_len] = end - start
            out[o_ok] = ok.to(torch.int32)
            out[o_null] = null.to(torch.int32)
            if pfx >= 0:
                words = postproc.span_prefix_words(buf, start, end, ok & ~null)
                for k in range(3):
                    out[pfx + k] = words[k]
        elif kind == TASK_SECMILLIS:
            (hi, lo, d18, ndig), milli, is_null, ok = postproc.parse_secmillis_spans(
                buf, s, e)
            for o, v in zip(task[4:12], (hi, lo, d18, ndig, ok, is_null,
                                         torch.zeros_like(ok), milli)):
                out[o] = v.to(torch.int32)
        else:
            (hi, lo, d18, ndig), is_null, ok, big = postproc.parse_long_spans(
                buf, s, e, clf=bool(clf)
            )
            if part == LONG_ZERO_NULL:
                # No byte-patch for the CLF conversion (it compares the
                # string to "0"): a >19-digit run fails, and a leading
                # zero ("00", "007") goes to the host.
                ok, big = ok & ~big, false_b
                first = postproc.gather_span_bytes(buf, s, 1)[:, 0]
                out[task[11]] = (((e - s) > 1) & (first == ord("0"))).to(torch.int32)
            else:
                # >19-digit runs stay device-valid: the hi row carries the
                # span (start | len<<13) for the host byte-patch.
                blen = (e - s).clamp(max=_SPAN_MASK)
                hi = torch.where(big, s | (blen << _SPAN_BITS), hi)
                lo = torch.where(big, 0, lo)
                d18 = torch.where(big, 0, d18)
            for o, v in zip(task[4:11], (hi, lo, d18, ndig, ok, is_null, big)):
                out[o] = v.to(torch.int32)
    return out


def timestamp_plain(
    tables: TsTables, buf: torch.Tensor, starts: torch.Tensor,
    ends: torch.Tensor, out: torch.Tensor, zone_out: torch.Tensor = None,
) -> torch.Tensor:
    """Fill ``out`` [4, B] with the packed timestamp bundle (the ts branch
    of the reference's compute_rows): c1, c2, offset, ok.  For a %Z
    layout rows 2 and 3 hold the wall minute and the verdict so far, and
    ``zone_out`` [B] the zone index, for :func:`zone_lookup_plain`."""
    comp, ok = timeparse.parse_timestamp_fields(
        buf, starts[tables.token_index], ends[tables.token_index], tables.layout
    )
    c1 = (comp["year"].to(torch.int64) | (comp["month"].to(torch.int64) << 14)
          | (comp["day"].to(torch.int64) << 18)
          | (comp["hour"].to(torch.int64) << 23))
    c2 = (comp["minute"].to(torch.int64) | (comp["second"].to(torch.int64) << 6)
          | (comp["milli"].to(torch.int64) << 12))
    out[0] = postproc.wrap_i32(c1)
    out[1] = postproc.wrap_i32(c2)
    if "zone_idx" in comp:
        out[2] = comp["minutes"]
        zone_out.copy_(comp["zone_idx"])
    else:
        out[2] = comp["offset_seconds"]
    out[3] = ok.to(torch.int32)
    return out


def zone_lookup_plain(
    tables: ZoneTables, zone_idx: torch.Tensor, minutes: torch.Tensor,
    gate: torch.Tensor, out: torch.Tensor,
) -> torch.Tensor:
    """Fill ``out`` [2, B] with (offset seconds, ok) of ``ZoneDeviceTable
    .lookup``; with a ``gate`` row (a timestamp bundle's verdict so far)
    ok is the bundle's final verdict (``timeparse.resolve_zone_offset``)."""
    if gate is None:
        off, ok = tables.table.lookup(zone_idx, minutes)
    else:
        off, ok = timeparse.resolve_zone_offset(tables.table, zone_idx, minutes, gate != 0)
    out[0] = off
    out[1] = ok.to(torch.int32)
    return out


def ipv4_spans_plain(
    tables: IpTables, buf: torch.Tensor, starts: torch.Tensor,
    ends: torch.Tensor, out: torch.Tensor,
) -> torch.Tensor:
    """Fill ``out`` [4, B] with (value, ip_ok, has_colon, chain_ok) of an
    IP token's spans (``parse_ipv4_spans``; a token's own span is always
    there, chain_ok 1)."""
    value, ok, colon = postproc.parse_ipv4_spans(
        buf, starts[tables.token_index], ends[tables.token_index])
    out[0] = value
    out[1] = ok.to(torch.int32)
    out[2] = colon.to(torch.int32)
    out[3] = 1
    return out


def geo_lookup_plain(
    tables: GeoTables, keys: torch.Tensor, gate: torch.Tensor, out: torch.Tensor,
) -> torch.Tensor:
    """Fill ``out`` [B] with the row of each key in the flattened table
    (``GeoDeviceTable.lookup_rows``); with a ``gate`` row, 0 where the
    gate is 0 (the reference's ``where(ip_ok & chain_ok, rows, 0)``)."""
    rows = lookup_rows_plain(tables.starts, tables.ends, keys)
    if gate is not None:
        rows = torch.where(gate != 0, rows, 0)
    out.copy_(rows)
    return out


def _src_span(src, token, starts, ends, comps):
    """(start, end, ok) of a group's input: the token's cursors, or three
    component rows (start, len, ok)."""
    if src[0] < 0:
        s, e = starts[token], ends[token]
        return s, e, torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    s = comps[src[0]]
    return s, s + comps[src[1]], comps[src[2]] != 0


def uri_split_plain(
    tables: UriTables, buf: torch.Tensor, starts: torch.Tensor,
    ends: torch.Tensor, comps: torch.Tensor,
) -> torch.Tensor:
    """Fill one URI group's rows of the unit block ``comps`` (the uri
    step of the reference's compute_rows: split_uri_fast, the line
    constraints ``ok | ~ok_in`` and ``overflow & ok_in``, each part's span
    or port long frame, and view prefix words)."""
    s, e, ok_in = _src_span(tables.src, tables.token_index, starts, ends, comps)
    B = buf.shape[0]
    false_b = torch.zeros(B, dtype=torch.bool, device=buf.device)
    uri = postproc.split_uri_fast(
        buf, s, e, dash=_clf_dash(buf, s, e) if tables.dash else None,
        need_authority=tables.need_authority, window=tables.window,
    )
    comps[tables.cons] = (uri["ok"] | ~ok_in).to(torch.int32)
    comps[tables.over] = (uri["overflow"] & ok_in).to(torch.int32)
    step_ok = ok_in & uri["ok"]
    names = {URI_PATH: "path", URI_QUERY: "query", URI_PROTOCOL: "proto",
             URI_USERINFO: "userinfo", URI_HOST: "host", URI_PORT: "port"}
    for part, clf, *outs, pfx in tables.parts_py:
        if part == URI_PORT:
            (hi, lo, d18, ndig), is_null, ok, big = postproc.parse_long_spans(
                buf, uri["port_start"], uri["port_end"], clf=bool(clf))
            # A chained long takes no >19-digit patch: such runs fail.
            vals = (hi, lo, d18, ndig, ok & ~big, is_null, false_b)
            for o, v in zip(outs, vals):
                comps[o] = v.to(torch.int32)
            continue
        if part == URI_REF:
            start, end = s, s
            null, amp, fix = torch.ones_like(false_b), false_b, false_b
        else:
            n = names[part]
            start, end = uri[f"{n}_start"], uri[f"{n}_end"]
            null = uri.get(f"{n}_null", false_b)
            amp = uri["query_amp"] if part == URI_QUERY else false_b
            fix = uri.get(f"{n}_fix", false_b)
        for o, v in zip(outs, (start, end - start, step_ok, null, amp, fix)):
            comps[o] = v.to(torch.int32)
        if pfx >= 0:
            words = postproc.span_prefix_words(buf, start, end, step_ok & ~null,
                                               amp if part == URI_QUERY else None)
            for k in range(3):
                comps[pfx + k] = words[k]
    return comps


def csr_words(csr: Dict[str, object], k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slot k of a split_csr result as its two packed layout words: start
    | nlen<<13 | eq<<26 | dec<<27 | ndec<<28 | nhigh<<29 and vstart |
    vlen<<13 (the qscsr put of the reference's compute_rows)."""
    seg_s, seg_e, eq = csr["seg_start"][k], csr["seg_end"][k], csr["eq_pos"][k]
    seg_empty = seg_s >= seg_e
    nlen = torch.where(seg_empty, 0, eq - seg_s)
    has_eq = (~seg_empty) & (eq < seg_e)
    vstart = torch.minimum(eq + 1, seg_e)
    vlen = torch.where(has_eq, seg_e - vstart, 0)
    i32 = torch.int32
    n_word = ((torch.where(seg_empty, 0, seg_s) & _SPAN_MASK)
              | ((nlen & _SPAN_MASK) << _SPAN_BITS)
              | (has_eq.to(i32) << 26) | (csr["decode"][k].to(i32) << 27)
              | (csr["name_pct"][k].to(i32) << 28) | (csr["name_high"][k].to(i32) << 29))
    v_word = ((torch.where(has_eq, vstart, 0) & _SPAN_MASK)
              | ((vlen & _SPAN_MASK) << _SPAN_BITS))
    return n_word.to(i32), v_word.to(i32)


def csr_split_plain(
    tables: CsrTables, buf: torch.Tensor, comps: torch.Tensor,
    starts: torch.Tensor = None, ends: torch.Tensor = None,
) -> torch.Tensor:
    """Fill one query-string or cookie group's rows of the unit block
    ``comps`` (the qscsr branch of the reference's compute_rows: a URI
    query part starts past a leading '?', a token's span is not ok when
    it is a CLF dash, split_csr with the group's separator over the
    window, 2 packed words per slot, ok, and ``overflow & chain_ok``)."""
    s, e, chain_ok = _src_span(tables.src, tables.token_index, starts, ends, comps)
    if tables.src[0] >= 0:
        first = postproc.gather_span_bytes(buf, s, 1)[:, 0]
        s = torch.where((s < e) & (first == ord("?")), s + 1, s)
    else:
        chain_ok = chain_ok & ~_clf_dash(buf, s, e)
    csr = postproc.split_csr(buf, s, e, tables.slots, uri_encoded=tables.uri_encoded,
                             window=tables.window, sep=tables.sep)
    for k in range(tables.slots):
        n_word, v_word = csr_words(csr, k)
        comps[tables.words + 2 * k] = n_word
        comps[tables.words + 2 * k + 1] = v_word
    comps[tables.ok] = chain_ok.to(torch.int32)
    comps[tables.over] = (csr["overflow"] & chain_ok).to(torch.int32)
    return comps


def setcookie_split_plain(
    tables: CsrTables, buf: torch.Tensor, starts: torch.Tensor,
    ends: torch.Tensor, comps: torch.Tensor,
) -> torch.Tensor:
    """Fill one Set-Cookie group's rows of the unit block ``comps`` (the
    setcookie branch of the reference's compute_rows: not ok on a CLF
    dash, split_setcookie_csr, per slot the emitted part as start | nlen
    (to the name's end) | eq=emit and the whole part as the value, ok,
    ``bad & ok`` and ``overflow & ok``)."""
    s, e = starts[tables.token_index], ends[tables.token_index]
    ok = ~_clf_dash(buf, s, e)
    sc = postproc.split_setcookie_csr(buf, s, e, tables.slots)
    i32 = torch.int32
    for k in range(tables.slots):
        emit = sc["emit"][k]
        seg_s = torch.where(emit, sc["seg_start"][k], 0)
        nlen = torch.where(emit, sc["name_end"][k] - sc["seg_start"][k], 0)
        vlen = torch.where(emit, sc["seg_end"][k] - sc["seg_start"][k], 0)
        comps[tables.words + 2 * k] = ((seg_s & _SPAN_MASK)
                                       | ((nlen & _SPAN_MASK) << _SPAN_BITS)
                                       | (emit.to(i32) << 26)).to(i32)
        comps[tables.words + 2 * k + 1] = ((seg_s & _SPAN_MASK)
                                           | ((vlen & _SPAN_MASK) << _SPAN_BITS)).to(i32)
    comps[tables.ok] = ok.to(i32)
    comps[tables.bad] = (sc["bad"] & ok).to(i32)
    comps[tables.over] = (sc["overflow"] & ok).to(i32)
    return comps


def muid_plain(
    tables: MuidTables, buf: torch.Tensor, starts: torch.Tensor,
    ends: torch.Tensor, out: torch.Tensor,
) -> torch.Tensor:
    """Fill ``out`` [6, B] with one mod_unique_id group's rows (MUID_ROWS:
    the parse_mod_unique_id words and ok)."""
    words, ok = postproc.parse_mod_unique_id(
        buf, starts[tables.token_index], ends[tables.token_index])
    for r, name in enumerate(MUID_ROWS[:-1]):
        out[r] = words[name]
    out[5] = ok.to(torch.int32)
    return out


def pack_rows_plain(
    tables: PackTables, flags: torch.Tensor, comps: torch.Tensor,
) -> torch.Tensor:
    """[K + 4V, B] int32: every unit's packed rows (row 0: valid after the
    line constraints | plausible<<1 | overflow<<2 | esc_hit&valid<<3),
    then per view field the winner-merged span word and prefix words (the
    reference's compute_rows ``put`` + compute_view_rows)."""
    B = comps.shape[1]
    dev = comps.device
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    row0 = []
    for ui, (_, c0, nc) in enumerate(tables.units_py):
        f = flags[ui]
        valid = (f & SPLIT_VALID) != 0
        over = torch.zeros_like(valid)
        for c, kind in tables.cons_py[c0:c0 + nc]:
            if kind == CONS_NEVER:
                valid = torch.zeros_like(valid)
                continue
            hit = comps[c] != 0
            if kind == CONS_REQUIRE:
                valid = valid & hit
                continue
            if kind == CONS_FORBID:
                valid = valid & ~hit
                continue
            if kind == CONS_CSR_OVERFLOW:
                hit = hit & valid
            valid = valid & ~hit
            over = over | hit
        plaus = (f & SPLIT_PLAUSIBLE) != 0
        esc = (f & SPLIT_ESC_HIT) != 0
        row0.append(valid.to(torch.int32) | (plaus.to(torch.int32) << 1)
                    | (over.to(torch.int32) * CSR_OVERFLOW_BIT)
                    | ((esc & valid).to(torch.int32) * ESC_QUOTE_BIT))
    out = torch.empty((tables.K + VIEW_ROWS_PER_FIELD * tables.V, B),
                      dtype=torch.int32, device=dev)
    for r, (ui, s0, ns) in enumerate(tables.rows_py):
        acc = row0[ui] if ui >= 0 else zero
        for c, shift, bits in tables.slots_py[s0:s0 + ns]:
            v = comps[c]
            if bits:
                v = (v & ((1 << bits) - 1)) << shift
            acc = acc | v
        out[r] = acc

    if tables.V:
        # Winner = the first unit whose automaton accepted the line (the
        # reference's argmax of validity, 0 when none); contested when an
        # earlier unit is still plausible.
        validity = torch.stack([(r & 1) != 0 for r in row0])
        plausible = torch.stack([(r & 2) != 0 for r in row0])
        idx = torch.arange(tables.U, device=dev)[:, None]
        valid_any = validity.any(dim=0)
        winner = torch.where(validity, idx, tables.U).amin(dim=0)
        winner = torch.where(valid_any, winner, 0)
        earlier = plausible.to(torch.int32).cumsum(dim=0) - plausible.to(torch.int32)
        ep = earlier.gather(0, winner[None, :])[0]
        valid_any = valid_any & (ep == 0)
        merged = [zero] * tables.V
        pwords = [[zero] * 3 for _ in range(tables.V)]
        for vi, ui, wrow, p0 in tables.views_py:
            w = out[wrow]
            ok = ((w >> (2 * _SPAN_BITS)) & 1) != 0
            null = ((w >> (2 * _SPAN_BITS + 1)) & 1) != 0
            sel = (winner == ui) & valid_any & ok & ~null
            live_word = (w & ((1 << (2 * _SPAN_BITS)) - 1)) | (1 << VIEW_LIVE_SHIFT)
            merged[vi] = torch.where(sel, live_word, merged[vi])
            pwords[vi] = [torch.where(sel, comps[p0 + k], pwords[vi][k])
                          for k in range(3)]
        for vi in range(tables.V):
            base = tables.K + VIEW_ROWS_PER_FIELD * vi
            out[base] = merged[vi]
            for k in range(3):
                out[base + 1 + k] = pwords[vi][k]
    return out


# ---------------------------------------------------------------------------
# The executor: the port of build_units_jnp_fn as a launch sequence.
# ---------------------------------------------------------------------------


class UnitsExecutor(nn.Module):
    """(buf [B, L] uint8, lengths [B] int32) -> [K + 4V, B] int32 packed
    rows of every unit plus the view rows of ``view_specs``.

    Holds every per-parser table as a buffer, so ``.to(device)`` uploads
    them once.  Per unit it launches split, span_stages, one timestamp
    kernel per timestamp group (followed by one zone_lookup for a %Z
    layout), one ipv4_spans per IP token of the GeoIP groups, then one
    geo_lookup per GeoIP group, one muid
    per mod_unique_id group, one uri_split per URI group, one csr_split
    per query-string or cookie group and one setcookie_split per
    Set-Cookie group, then one pack_rows over all units.  The CUDA
    grid replaces the reference's 16k-row tiling."""

    def __init__(self, units: Sequence[FormatUnit], view_specs: ViewSpecs = ()):
        super().__init__()
        units = list(units)
        view_specs = [(fid, tuple(idx)) for fid, idx in view_specs]
        ucs, bases, base = [], [], 0
        for ui, u in enumerate(units):
            vf = [fid for fid, idx in view_specs if ui in idx]
            uc = unit_components(u, vf)
            ucs.append(uc)
            bases.append(base)
            base += uc.n_rows
        self.n_comp = base
        self.unit_tables = nn.ModuleList(
            UnitTables(u, uc, b) for u, uc, b in zip(units, ucs, bases)
        )
        self.pack = PackTables(units, ucs, bases, view_specs)

    @property
    def n_out_rows(self) -> int:
        return self.pack.K + VIEW_ROWS_PER_FIELD * self.pack.V

    def forward(self, buf: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        from . import kernels

        return kernels.pack_rows(self.pack, *self.components(buf, lengths))

    def components(self, buf: torch.Tensor, lengths: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(flags [U, B], comps [n_comp, B]): every launch before pack_rows,
        the inputs pack_rows packs."""
        from . import kernels

        B = buf.shape[0]
        flags = torch.empty((len(self.unit_tables), B), dtype=torch.int32,
                            device=buf.device)
        comps = torch.empty((self.n_comp, B), dtype=torch.int32, device=buf.device)
        for ui, t in enumerate(self.unit_tables):
            starts, ends, _ = kernels.split(t.split, buf, lengths, flags_out=flags[ui])
            block = comps[t.comp_base:t.comp_base + t.n_comp]
            a = t.stages.n_out
            if a:
                kernels.span_stages(t.stages, buf, starts, ends, out=block[:a])
            for g, ts in enumerate(t.ts):
                rows = block[a + 4 * g:a + 4 * g + 4]
                if ts.zone is None:
                    kernels.timestamp(ts, buf, starts, ends, out=rows)
                    continue
                zone = torch.empty(B, dtype=torch.int32, device=buf.device)
                kernels.timestamp(ts, buf, starts, ends, out=rows, zone_out=zone)
                kernels.zone_lookup(ts.zone, zone, rows[2], gate=rows[3], out=rows[2:4])
            for ip in t.ip:
                kernels.ipv4_spans(ip, buf, starts, ends, out=block[ip.base:ip.base + 4])
            for g in t.geo:
                kernels.geo_lookup(g, block[g.ip + GEO_VALUE],
                                   gate=block[g.ip + GEO_IP_OK], out=block[g.row])
            for u in t.uri:
                kernels.uri_split(u, buf, starts, ends, block)
            for m in t.muid:
                kernels.muid(m, buf, starts, ends, out=block[m.base:m.base + 6])
            for c in t.csr:
                if c.mode == "setcookie":
                    kernels.setcookie_split(c, buf, starts, ends, block)
                else:
                    kernels.csr_split(c, buf, block, starts, ends)
        return flags, comps
