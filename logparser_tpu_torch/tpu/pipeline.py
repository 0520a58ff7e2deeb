"""Device pipeline: split + typed post-stages -> ONE packed [K, B] int32.

The port of the reference package's ``tpu/pipeline.py`` for the Apache
``combined`` main path.  Host data (field plans, the packed bit-slot
layout, format units) is copied; the device computation is four
hand-written CUDA kernels (``kernels.py``, sources in ``csrc/``) run by
:class:`UnitsExecutor`, the port of ``build_units_jnp_fn``:

1. ``split``       — the split program: token cursors, valid, plausible,
                     esc_hit (:func:`compute_split` is its plain version);
2. ``span_stages`` — CLF dash, first-line split, ``%b`` limb frame, view
                     prefix words (:func:`span_stages_plain`);
3. ``timestamp``   — the ``DeviceTimeLayout`` items
                     (``timeparse.parse_device_timestamp``);
4. ``pack_rows``   — bit-packing of every component into ``[K, B]``, the
                     row-0 verdict bits and line constraints, and the
                     winner-merged view rows (:func:`pack_rows_plain`).

Stages 2 and 3 write "components": one ``[B]`` int32 row per value a
layout slot receives, in a ``[n_comp, B]`` tensor that stage 4 packs.
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

from . import postproc, timeparse
from .program import CS_ANY, DeviceProgram


@dataclass(frozen=True)
class FieldPlan:
    """How one requested field is produced on device.

    A token capture plus a chain of span-transform ``steps`` (here only
    the first-line split ``("fl", part)``) ending in a terminal decode
    ``kind``: ``span`` (the sub-span itself), ``long`` (digit span ->
    int64, ``null_mode`` handles the CLF '-'), ``ts`` (timestamp ->
    component bundle; ``comp`` names the output, ``meta`` carries the
    DeviceTimeLayout) or ``host`` (not device-resolvable)."""

    field_id: str                 # cleaned "TYPE:path"
    kind: str                     # span | long | ts | host
    token_index: int = -1
    steps: Tuple[Tuple[str, str], ...] = ()
    comp: str = ""
    meta: object = None
    null_mode: str = ""           # "" | dash_null | dash_zero
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
# bit 2 = CSR slot overflow (no CSR stage on this slice, so never set),
# bit 3 = the valid line's quoted-field split consumed a backslash-escaped
# separator.
ESC_QUOTE_BIT = 8
CSR_SLOTS = 16

# Split flags (the split kernel's per-line output word).
SPLIT_VALID = 1
SPLIT_PLAUSIBLE = 2
SPLIT_ESC_HIT = 4


def ts_group_key(plan: FieldPlan) -> str:
    """All ts plans over the same token+steps share one component bundle."""
    return f"@ts:{plan.token_index}:{plan.steps!r}"


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
            if kind == "span":
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
            elif kind == "long":
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

    def plan_for(self, field_id: str) -> FieldPlan:
        for p in self.plans:
            if p.field_id == field_id:
                return p
        return FieldPlan(field_id, "host")


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


def _shift_zero(x: torch.Tensor, k: int) -> torch.Tensor:
    """Left-shift columns by k, zero-filling the tail."""
    if k <= 0:
        return x
    B, L = x.shape
    if k >= L:
        return torch.zeros_like(x)
    return torch.cat([x[:, k:], torch.zeros((B, k), dtype=x.dtype,
                                            device=x.device)], dim=1)


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
            part = _shift_zero(buf, k) == byte
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

TASK_SPAN, TASK_LONG = 0, 1
PART_DIRECT, PART_METHOD, PART_URI, PART_PROTOCOL = 0, 1, 2, 3
_FL_PART = {"method": PART_METHOD, "uri": PART_URI, "protocol": PART_PROTOCOL}
TASKW = 12       # span_stages task table width

ITEM_LIT, ITEM_NUM, ITEM_NAME = 0, 1, 2
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
class _UnitComps:
    """Component rows of one unit: span_stages tasks, timestamp groups,
    line constraints and the slot every component is packed into."""

    tasks: List[Tuple] = dataclass_field(default_factory=list)
    n_stage_rows: int = 0
    ts_groups: List[Tuple[str, int, object]] = dataclass_field(default_factory=list)
    constraints: List[int] = dataclass_field(default_factory=list)
    puts: List[Tuple[int, Slot]] = dataclass_field(default_factory=list)
    prefix: Dict[str, int] = dataclass_field(default_factory=dict)
    start_row: Dict[str, int] = dataclass_field(default_factory=dict)

    @property
    def n_rows(self) -> int:
        return self.n_stage_rows + 4 * len(self.ts_groups)


def unit_components(unit: FormatUnit, view_fields: Sequence[str]) -> _UnitComps:
    """Assign component rows for one unit: span_stages rows first (in
    plan order), then 4 rows (c1, c2, off, ok) per timestamp group."""
    uc = _UnitComps()
    slots = unit.layout.slots
    view_set = set(view_fields)
    stage: List[Tuple[str, str]] = []   # (slot key, comp) per stage row

    def row(key: str, comp: str) -> int:
        stage.append((key, comp))
        return len(stage) - 1

    for plan in unit.plans:
        if plan.kind == "host":
            continue
        fid = plan.field_id
        if plan.kind == "span":
            if plan.steps and plan.steps[0][0] != "fl" or len(plan.steps) > 1:
                raise ValueError(f"span chain {plan.steps} is not on this slice")
            part = _FL_PART[plan.steps[0][1]] if plan.steps else PART_DIRECT
            outs = [row(fid, c) for c in ("start", "len", "ok", "null")]
            pfx = -1
            if fid in view_set:
                pfx = len(stage)
                uc.prefix[fid] = pfx
                for k in range(3):
                    stage.append(("@view", f"{fid}:{k}"))
            uc.start_row[fid] = slots[fid]["start"][0]
            uc.tasks.append((TASK_SPAN, plan.token_index, part, 0,
                             *outs, 0, 0, 0, pfx))
        elif plan.kind == "long":
            if plan.steps or plan.scale != 1 or plan.null_mode not in (
                "", "dash_null", "dash_zero"
            ):
                raise ValueError(f"long plan {plan} is not on this slice")
            comps = ("hi", "lo", "d18", "lo_digits", "ok", "null", "big")
            outs = [row(fid, c) for c in comps]
            uc.constraints.append(outs[4])
            clf = int(plan.null_mode in ("dash_null", "dash_zero"))
            uc.tasks.append((TASK_LONG, plan.token_index, 0, clf, *outs, -1))
        elif plan.kind == "ts":
            if plan.steps:
                raise ValueError(f"ts chain {plan.steps} is not on this slice")
            key = ts_group_key(plan)
            if all(k != key for k, _, _ in uc.ts_groups):
                uc.ts_groups.append((key, plan.token_index, plan.meta))
        else:
            raise ValueError(f"plan kind {plan.kind!r} is not on this slice")
    uc.n_stage_rows = len(stage)
    for r, (key, comp) in enumerate(stage):
        if key != "@view":
            uc.puts.append((r, slots[key][comp]))
    for g, (key, _, _) in enumerate(uc.ts_groups):
        base = uc.n_stage_rows + 4 * g
        for k, comp in enumerate(("c1", "c2", "off", "ok")):
            uc.puts.append((base + k, slots[key][comp]))
        uc.constraints.append(base + 3)
    return uc


class StageTables(nn.Module):
    """One unit's span_stages tasks: rows (kind, token, part, clf, out0..
    out6, prefix row) with output rows relative to the kernel's output.
    A span task writes (start, len, ok, null) and, when its field emits
    view rows, 3 prefix words from ``prefix row``; a long task writes
    (hi, lo, d18, ndig, ok, null, big)."""

    def __init__(self, uc: _UnitComps):
        super().__init__()
        self.tasks_py = list(uc.tasks)
        self.n_out = uc.n_stage_rows
        self.register_buffer("tasks", _i32(self.tasks_py, TASKW))


class TsTables(nn.Module):
    """One timestamp group: the DeviceTimeLayout's items as rows (kind,
    offset, width, arg) -- arg is the literal's offset into ``text`` or
    the numeric field's index in ``timeparse.NUM_FIELDS`` -- and the month
    name table as rows (length, bytes...)."""

    def __init__(self, token_index: int, dl: timeparse.DeviceTimeLayout):
        super().__init__()
        if len(dl.segments) != 1 or dl.seg_widths[0] < 0 or dl.tail != "offset":
            raise ValueError("only a fixed-width timestamp with a ZZ offset is on this slice")
        self.token_index = token_index
        self.layout = dl
        self.seg_w = dl.seg_widths[0]
        items, text, names = [], [], []
        for it in dl.segments[0]:
            if it.kind == "lit":
                items.append((ITEM_LIT, it.offset, it.width, len(text)))
                text.extend(it.text)
            elif it.kind == "num" and it.field in timeparse.NUM_FIELDS:
                items.append((ITEM_NUM, it.offset, it.width,
                              timeparse.NUM_FIELDS.index(it.field)))
            elif it.kind == "name" and it.field == "month" and not names:
                items.append((ITEM_NAME, it.offset, it.width, 0))
                names = [(len(e),) + tuple(e) for e in it.table]
            else:
                raise ValueError(f"timestamp item {it} is not on this slice")
        self.name_width = 1 + max((len(n) - 1 for n in names), default=0)
        self.register_buffer("items", _i32(items, 4))
        self.register_buffer("text", torch.tensor(text or [0], dtype=torch.int32))
        self.register_buffer("names", _i32(names or [(0,)], self.name_width))


class UnitTables(nn.Module):
    """One unit's tables; its components start at row ``comp_base`` of
    the executor's component tensor."""

    def __init__(self, unit: FormatUnit, uc: _UnitComps, comp_base: int):
        super().__init__()
        self.split = SplitTables(unit.program)
        self.stages = StageTables(uc)
        self.ts = nn.ModuleList(TsTables(tok, dl) for _, tok, dl in uc.ts_groups)
        self.comp_base = comp_base
        self.n_comp = uc.n_rows


class PackTables(nn.Module):
    """Packing for all units: ``units`` rows (row offset, first
    constraint, constraint count) with ``cons`` the constraint component
    rows; ``rows`` (unit whose validity row this is or -1, first slot,
    slot count) per output row; ``slots`` (component, shift, bits);
    ``views`` (view field, unit, packed row of its span word, first
    prefix component) per (view field, decodable unit)."""

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
            cons.extend(base + c for c in uc.constraints)
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
        self.register_buffer("cons", torch.tensor(cons or [0], dtype=torch.int32))
        self.register_buffer("rows", _i32(rows, 3))
        self.register_buffer("slots", _i32(slots or [(0, 0, 0)], 3))
        self.register_buffer("views", _i32(views or [(0, 0, 0, 0)], 4))
        self.n_views = len(views)


# ---------------------------------------------------------------------------
# Kernels 2 and 4, plain versions.
# ---------------------------------------------------------------------------


def span_stages_plain(
    tables: StageTables, buf: torch.Tensor, starts: torch.Tensor,
    ends: torch.Tensor, out: torch.Tensor,
) -> torch.Tensor:
    """Fill ``out`` [n_out, B] int32 with every span / long task's
    components (the span-chain and numeric branches of the reference's
    compute_rows, plus span_prefix_words for view fields)."""
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
                # Token-level CLF null: the span is a lone '-'.
                null = ((e - s) == 1) & (
                    postproc.gather_span_bytes(buf, s, 1)[:, 0] == ord("-")
                )
            else:
                fl = fl_cache.get(tok)
                if fl is None:
                    fl = fl_cache[tok] = postproc.split_firstline(buf, s, e)
                name = {PART_METHOD: "method", PART_URI: "uri",
                        PART_PROTOCOL: "proto"}[part]
                start, end = fl[f"{name}_start"], fl[f"{name}_end"]
                ok = fl["ok"] & fl["has_protocol"] if part == PART_PROTOCOL else fl["ok"]
                null = false_b
            out[o_start] = start
            out[o_len] = end - start
            out[o_ok] = ok.to(torch.int32)
            out[o_null] = null.to(torch.int32)
            if pfx >= 0:
                words = postproc.span_prefix_words(buf, start, end, ok & ~null)
                for k in range(3):
                    out[pfx + k] = words[k]
        else:
            (hi, lo, d18, ndig), is_null, ok, big = postproc.parse_long_spans(
                buf, s, e, clf=bool(clf)
            )
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
    ends: torch.Tensor, out: torch.Tensor,
) -> torch.Tensor:
    """Fill ``out`` [4, B] with the packed timestamp bundle: c1, c2, off,
    ok (the ts branch of the reference's compute_rows)."""
    comp, ok = timeparse.parse_device_timestamp(
        buf, starts[tables.token_index], ends[tables.token_index], tables.layout
    )
    c1 = (comp["year"].to(torch.int64) | (comp["month"].to(torch.int64) << 14)
          | (comp["day"].to(torch.int64) << 18)
          | (comp["hour"].to(torch.int64) << 23))
    c2 = (comp["minute"].to(torch.int64) | (comp["second"].to(torch.int64) << 6)
          | (comp["milli"].to(torch.int64) << 12))
    out[0] = postproc.wrap_i32(c1)
    out[1] = postproc.wrap_i32(c2)
    out[2] = comp["offset_seconds"]
    out[3] = ok.to(torch.int32)
    return out


def pack_rows_plain(
    tables: PackTables, flags: torch.Tensor, comps: torch.Tensor,
) -> torch.Tensor:
    """[K + 4V, B] int32: every unit's packed rows (row 0: valid after the
    line constraints | plausible<<1 | esc_hit&valid<<3), then per view
    field the winner-merged span word and prefix words (the reference's
    compute_rows ``put`` + compute_view_rows)."""
    B = comps.shape[1]
    dev = comps.device
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    row0 = []
    for ui, (_, c0, nc) in enumerate(tables.units_py):
        f = flags[ui]
        valid = (f & SPLIT_VALID) != 0
        for c in tables.cons_py[c0:c0 + nc]:
            valid = valid & (comps[c] != 0)
        plaus = (f & SPLIT_PLAUSIBLE) != 0
        esc = (f & SPLIT_ESC_HIT) != 0
        row0.append(valid.to(torch.int32) | (plaus.to(torch.int32) << 1)
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
    them once.  Per unit it launches split, span_stages and one
    timestamp kernel per timestamp group, then one pack_rows over all
    units.  The CUDA grid replaces the reference's 16k-row tiling."""

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

        B = buf.shape[0]
        flags = torch.empty((len(self.unit_tables), B), dtype=torch.int32,
                            device=buf.device)
        comps = torch.empty((self.n_comp, B), dtype=torch.int32, device=buf.device)
        for ui, t in enumerate(self.unit_tables):
            starts, ends, _ = kernels.split(t.split, buf, lengths, flags_out=flags[ui])
            a = t.comp_base
            if t.stages.n_out:
                kernels.span_stages(t.stages, buf, starts, ends,
                                    out=comps[a:a + t.stages.n_out])
            a += t.stages.n_out
            for g, ts in enumerate(t.ts):
                kernels.timestamp(ts, buf, starts, ends,
                                  out=comps[a + 4 * g:a + 4 * g + 4])
        return kernels.pack_rows(self.pack, flags, comps)
