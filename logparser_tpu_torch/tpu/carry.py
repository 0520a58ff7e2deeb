"""Carrying compiled parsers across as plain data.

This system has no weights: what plays their part is the compiled state
of a parser -- per format unit the split program (ops, tokens, charset
table), the field plans, the packed bit-slot layout and the timestamp
layouts.  :func:`unit_to_plain` writes that state as plain Python and
numpy data (tuples, dicts, ``np.ndarray``); :func:`units_from_reference`
rebuilds the port's :class:`~.pipeline.FormatUnit` objects from it.  The
same plain schema extracted from the reference package's units (which the
tests do, without this package importing JAX) lets both packages run the
identical program.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

from ..dissectors.timelayout import LocaleData
from .pipeline import FieldPlan, FormatUnit, PackedLayout
from .program import DeviceProgram, SplitOp, TokenSpec
from .timeparse import DeviceTimeLayout, _DevItem

Plain = Dict[str, Any]

_LOCALE_KEYS = ("tag", "months_short", "months_full", "days_short",
                "days_full", "ampm", "week_first_day", "week_min_days")
_ITEM_KEYS = ("kind", "offset", "width", "field", "text", "table",
              "zone_idx", "fold_flags")


def _locale_to_plain(loc) -> Plain:
    return {k: (tuple(v) if isinstance(v, (list, tuple)) else v)
            for k, v in ((k, getattr(loc, k)) for k in _LOCALE_KEYS)}


def time_layout_to_plain(dl) -> Plain:
    return {
        "segments": tuple(
            tuple(tuple(getattr(it, k) for k in _ITEM_KEYS) for it in seg)
            for seg in dl.segments
        ),
        "seg_widths": tuple(dl.seg_widths),
        "tail": dl.tail,
        "default_offset_seconds": dl.default_offset_seconds,
        "min_prefix": dl.min_prefix,
        "locale": _locale_to_plain(dl.locale) if dl.locale is not None else None,
        "zone_table": dl.zone_table is not None,
    }


def unit_to_plain(unit) -> Plain:
    """One unit's compiled state as plain data (works on any object with
    the FormatUnit / DeviceProgram / FieldPlan / PackedLayout attributes)."""
    prog = unit.program
    plans = []
    for p in unit.plans:
        meta = time_layout_to_plain(p.meta) if p.kind == "ts" else None
        plans.append((p.field_id, p.kind, p.token_index, tuple(p.steps),
                      p.comp, meta, p.null_mode, p.scale, p.attr))
    return {
        "program": {
            "log_format": prog.log_format,
            "ops": tuple((op.kind, bytes(op.lit), op.token_index, op.charset,
                          op.min_len, op.max_len, op.narrow) for op in prog.ops),
            "tokens": tuple((t.index, t.charset, t.min_len, t.max_len, t.narrow,
                             tuple(tuple(o) for o in t.outputs))
                            for t in prog.tokens),
            "charset_table": np.asarray(prog.charset_table, dtype=bool),
            "charset_ids": dict(prog.charset_ids),
            "max_lit_len": prog.max_lit_len,
        },
        "plans": tuple(plans),
        "layout": {
            "slots": {k: dict(v) for k, v in unit.layout.slots.items()},
            "n_rows": unit.layout.n_rows,
            "csr_slots": unit.layout.csr_slots,
        },
        "row_offset": unit.row_offset,
        "plausibility_only": bool(getattr(unit, "plausibility_only", False)),
    }


def _time_layout_from_plain(d: Plain) -> DeviceTimeLayout:
    if d["zone_table"]:
        raise ValueError("zone-text timestamp layouts are a later slice")
    loc = d["locale"]
    return DeviceTimeLayout(
        segments=tuple(tuple(_DevItem(*it) for it in seg) for seg in d["segments"]),
        seg_widths=tuple(d["seg_widths"]),
        tail=d["tail"],
        default_offset_seconds=d["default_offset_seconds"],
        locale=None if loc is None else LocaleData(**loc),
        min_prefix=d["min_prefix"],
    )


def program_from_plain(p: Plain) -> DeviceProgram:
    """The ``program`` part of the plain schema -> a DeviceProgram."""
    return DeviceProgram(
        log_format=p["log_format"],
        ops=tuple(SplitOp(*op) for op in p["ops"]),
        tokens=[TokenSpec(i, cs, mn, mx, nr, [tuple(o) for o in outs])
                for i, cs, mn, mx, nr, outs in p["tokens"]],
        charset_table=np.array(p["charset_table"], dtype=bool),
        charset_ids=dict(p["charset_ids"]),
        max_lit_len=p["max_lit_len"],
    )


def units_from_reference(plain: Sequence[Plain]) -> List[FormatUnit]:
    """Plain per-unit data (``unit_to_plain``'s schema) -> the port's
    FormatUnits.  Plausibility-only probe units are a later slice."""
    units: List[FormatUnit] = []
    for d in plain:
        if d["plausibility_only"]:
            raise ValueError("plausibility-only units are a later slice")
        program = program_from_plain(d["program"])
        plans = []
        for fid, kind, tok, steps, comp, meta, null_mode, scale, attr in d["plans"]:
            plans.append(FieldPlan(
                fid, kind, tok, tuple(tuple(s) for s in steps), comp,
                _time_layout_from_plain(meta) if kind == "ts" else meta,
                null_mode, scale, attr,
            ))
        lay = d["layout"]
        layout = PackedLayout(
            slots={k: {c: tuple(s) for c, s in v.items()}
                   for k, v in lay["slots"].items()},
            n_rows=lay["n_rows"], csr_slots=lay["csr_slots"],
        )
        units.append(FormatUnit(program, plans, layout, d["row_offset"]))
    return units
