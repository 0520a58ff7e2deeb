"""TorchBatchParser: a LogFormat + requested fields -> packed device
parse on the card -> columnar :class:`BatchResult`.

The port of the reference package's ``tpu/batch.py`` for this slice:

- plan resolution chases each token output through the consumer edges
  the slice runs (direct token outputs, the first-line split, the
  timestamp bundle, the CLF -> number conversion); a field reached any
  other way, or by more than one path, raises
  :class:`UnsupportedFieldError` naming the slice that brings it;
- the batch goes host -> device once (pinned buffer, ``non_blocking`` on
  the current stream), through the four kernels (``UnitsExecutor``), and
  back once as the packed ``[K + 4V, B]`` int32;
- materialization decides, per line, the winning format, validity and
  plausibility, and decodes span / long / timestamp columns on the host
  (int64 numpy), including the Long-overflow patch of ``%b``.

Lines the reference sends to its host oracle (device-invalid but still
plausible, contested, truncated) are returned in ``needs_host`` with all
fields None and ``valid`` False: the per-line oracle is a later slice.
Definitely-bad lines (implausible for every format) are plain invalid.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from ..dissectors.timelayout import APACHE_LAYOUT
from ..dissectors.tokenformat import UnsupportedFormatError
from ..httpd.apache import NAMED_FORMATS, ApacheLogFormat
from . import postproc, timefields
from .pipeline import (
    FieldPlan,
    FormatUnit,
    PackedLayout,
    UnitsExecutor,
    _SPAN_BITS,
    assign_row_offsets,
    ts_group_key,
)
from .program import CS_CLF_DIGITS, CS_DIGITS, DeviceProgram, compile_device_program
from .runtime import encode_batch
from .timeparse import compile_layout_for_device

__all__ = ["TorchBatchParser", "BatchResult", "UnsupportedFieldError",
           "UnsupportedFormatError", "cleanup_field_value"]


class UnsupportedFieldError(ValueError):
    """A requested field needs a stage this slice of the port does not run
    (or the host oracle); the message names the ROADMAP slice."""


def cleanup_field_value(field_value: str) -> str:
    """Normalize ``TYPE:path`` -- TYPE upper, path lower."""
    colon = field_value.find(":")
    if colon == -1:
        return field_value.lower()
    return field_value[:colon].upper() + ":" + field_value[colon + 1:].lower()


# ---------------------------------------------------------------------------
# The consumer edges of the reference's dissector graph reachable from the
# tokens of this port: input type -> [(consumer, [(out type, out name)])].
# ---------------------------------------------------------------------------

_TIME_OUTPUTS = [
    ("TIME.DAY", "day"), ("TIME.MONTHNAME", "monthname"),
    ("TIME.MONTH", "month"), ("TIME.WEEK", "weekofweekyear"),
    ("TIME.YEAR", "weekyear"), ("TIME.YEAR", "year"), ("TIME.HOUR", "hour"),
    ("TIME.MINUTE", "minute"), ("TIME.SECOND", "second"),
    ("TIME.MILLISECOND", "millisecond"), ("TIME.MICROSECOND", "microsecond"),
    ("TIME.NANOSECOND", "nanosecond"), ("TIME.DATE", "date"),
    ("TIME.TIME", "time"), ("TIME.ZONE", "timezone"), ("TIME.EPOCH", "epoch"),
    ("TIME.DAY", "day_utc"), ("TIME.MONTHNAME", "monthname_utc"),
    ("TIME.MONTH", "month_utc"), ("TIME.WEEK", "weekofweekyear_utc"),
    ("TIME.YEAR", "weekyear_utc"), ("TIME.YEAR", "year_utc"),
    ("TIME.HOUR", "hour_utc"), ("TIME.MINUTE", "minute_utc"),
    ("TIME.SECOND", "second_utc"), ("TIME.MILLISECOND", "millisecond_utc"),
    ("TIME.MICROSECOND", "microsecond_utc"),
    ("TIME.NANOSECOND", "nanosecond_utc"), ("TIME.DATE", "date_utc"),
    ("TIME.TIME", "time_utc"),
]

_CONSUMERS: Dict[str, List[Tuple[str, List[Tuple[str, str]]]]] = {
    "TIME.STAMP": [("timestamp", _TIME_OUTPUTS)],
    "HTTP.FIRSTLINE": [("firstline", [
        ("HTTP.METHOD", "method"), ("HTTP.URI", "uri"),
        ("HTTP.PROTOCOL_VERSION", "protocol"),
    ])],
    "HTTP.PROTOCOL_VERSION": [("protocol_version", [
        ("HTTP.PROTOCOL", ""), ("HTTP.PROTOCOL.VERSION", "version"),
    ])],
    "HTTP.URI": [("uri", [
        ("HTTP.PROTOCOL", "protocol"), ("HTTP.USERINFO", "userinfo"),
        ("HTTP.HOST", "host"), ("HTTP.PORT", "port"), ("HTTP.PATH", "path"),
        ("HTTP.QUERYSTRING", "query"), ("HTTP.REF", "ref"),
    ])],
    "HTTP.QUERYSTRING": [("querystring", [("STRING", "*")])],
    "BYTESCLF": [("clf_to_number", [("BYTES", "")])],
    "BYTES": [("number_to_clf", [("BYTESCLF", "")])],
}

# Where each unported edge lands in ROADMAP.md.
_LATER = {
    "uri": "slice 2 (split_uri_fast, ROADMAP queue A item 1)",
    "querystring": "slice 2 (split_csr, ROADMAP queue A item 1)",
    "protocol_version": "split_protocol_version (ROADMAP queue A item 1)",
    "number_to_clf": "the zero->null CLF conversion (ROADMAP queue A item 5)",
    "timestamp": "the host oracle port (ROADMAP queue A item 3)",
    "multi": "the host oracle port (ROADMAP queue A item 3): more than one producer",
    "none": "no producer in this LogFormat",
}


def _host(field_id: str, why: str) -> FieldPlan:
    return FieldPlan(field_id, "host", meta=_LATER[why])


class TorchBatchParser:
    """Compiles one LogFormat (or several, one per line, in registration
    order) + requested fields into the port's device executor.

    ``device`` defaults to ``"cuda"`` and raises when CUDA is absent; the
    CPU runs the kernels' plain versions and must be asked for
    (``device="cpu"``)."""

    def __init__(self, log_format: str, fields: Sequence[str],
                 device: Union[str, torch.device, None] = None):
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchBatchParser: CUDA was asked for but is not available "
                "(pass device='cpu' to run the plain PyTorch versions)"
            )
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.log_format = log_format
        self.requested = list(dict.fromkeys(cleanup_field_value(f) for f in fields))
        self.units: List[FormatUnit] = []
        for fmt in _split_formats(log_format):
            prog = compile_device_program(ApacheLogFormat(fmt))
            plans = [self._resolve(prog, fid) for fid in self.requested]
            self.units.append(FormatUnit(prog, plans, PackedLayout.for_plans(plans)))
        if not self.units:
            raise UnsupportedFormatError(f"no LogFormat in {log_format!r}")
        assign_row_offsets(self.units)
        self.plan_by_id = {fid: self.units[0].plan_for(fid) for fid in self.requested}
        for fid, plan in self.plan_by_id.items():
            groups = {_plan_group(u.plan_for(fid)) for u in self.units}
            if len(groups) != 1:
                raise UnsupportedFieldError(
                    f"{fid}: decoded differently per format ({sorted(groups)}); "
                    f"needs {_LATER['timestamp']}"
                )
        self.view_specs = [
            (fid, tuple(range(len(self.units))))
            for fid in self.requested if _plan_group(self.plan_by_id[fid]) == "span"
        ]
        self.executor = UnitsExecutor(self.units, self.view_specs).to(self.device)

    # -- plan resolution -------------------------------------------------

    def _resolve(self, program: DeviceProgram, field_id: str) -> FieldPlan:
        """The one device plan producing ``field_id``; raises unless
        exactly one chase path reaches it and every step is ported."""
        ftype, _, path = field_id.partition(":")
        candidates: List[FieldPlan] = []
        for tok in program.tokens:
            for out_type, out_name in tok.outputs:
                candidates.extend(self._chase(
                    field_id, ftype, path, tok, out_type, out_name,
                    vctx=("", "", 1), steps=(), device_ok=True, why="",
                    depth=6, visited=frozenset(),
                ))
        if len(candidates) == 1 and candidates[0].kind != "host":
            return candidates[0]
        if not candidates:
            why = _LATER["none"]
        elif len(candidates) > 1:
            why = _LATER["multi"]
        else:
            why = candidates[0].meta
        raise UnsupportedFieldError(f"{field_id}: {why}")

    @staticmethod
    def _terminal_plan(field_id, tok, vctx, steps, device_ok, why) -> FieldPlan:
        if not device_ok:
            return FieldPlan(field_id, "host", meta=why)
        parse, null_mode, scale = vctx
        if parse == "":
            if steps:
                return FieldPlan(field_id, "span", tok.index, steps)
            if tok.charset == CS_DIGITS and not tok.narrow:
                return FieldPlan(field_id, "long", tok.index)
            if tok.charset == CS_CLF_DIGITS and not tok.narrow:
                return FieldPlan(field_id, "long", tok.index, null_mode="dash_null")
            return FieldPlan(field_id, "span", tok.index)
        return FieldPlan(field_id, parse, tok.index, steps,
                         null_mode=null_mode, scale=scale)

    @staticmethod
    def _step_spec(consumer: str, oname: str, vctx, steps, device_ok, why):
        """(kind, vctx, steps, device_ok, why[, comp, meta]) of one edge."""
        parse = vctx[0]
        if consumer == "clf_to_number" and parse == "":
            return ("value", ("long", "dash_zero", vctx[2]), steps, device_ok, why)
        if consumer == "firstline" and parse == "":
            return ("span", vctx, steps + (("fl", oname),), device_ok, why)
        if consumer == "timestamp" and parse == "":
            dl = None
            if oname in timefields.DEVICE_COMPONENTS:
                dl = compile_layout_for_device(APACHE_LAYOUT)
            return ("ts", vctx, steps, device_ok and dl is not None,
                    why or _LATER["timestamp"], oname, dl)
        return ("value", vctx, steps, False, why or _LATER.get(consumer, _LATER["timestamp"]))

    def _chase(self, field_id, ftype, path, tok, t, name, vctx, steps,
               device_ok, why, depth, visited) -> List[FieldPlan]:
        """Every way (t:name), reached from ``tok`` via ``steps``, leads to
        the requested (ftype:path) -- the mirror of the reference's
        TpuBatchParser._chase over the edges above."""
        if t == ftype and name == path:
            return [self._terminal_plan(field_id, tok, vctx, steps, device_ok, why)]
        if (t, name) in visited:
            return []
        if not (name == "" or path == name or path.startswith(name + ".")):
            return []
        if depth == 0:
            return [_host(field_id, "multi")]
        visited = visited | {(t, name)}
        plans: List[FieldPlan] = []
        for consumer, outputs in _CONSUMERS.get(t, ()):
            for ot, oname in outputs:
                if oname == "*":
                    if ot == ftype and path.startswith(name + "."):
                        plans.append(FieldPlan(field_id, "host", meta=_LATER[consumer]))
                    continue
                new_name = (name + "." + oname if name else oname) if oname else name
                if not (path == new_name or path.startswith(new_name + ".")):
                    continue
                spec = self._step_spec(consumer, oname, vctx, steps, device_ok, why)
                if spec[0] == "ts":
                    _, _, nsteps, ndev, nwhy, comp, meta = spec
                    if path == new_name and ot == ftype:
                        plans.append(
                            FieldPlan(field_id, "ts", tok.index, nsteps,
                                      comp=comp, meta=meta)
                            if ndev else FieldPlan(field_id, "host", meta=nwhy)
                        )
                    continue
                _, nctx, nsteps, ndev, nwhy = spec
                if path == new_name and ot == ftype:
                    plans.append(self._terminal_plan(
                        field_id, tok, nctx, nsteps, ndev, nwhy))
                else:
                    plans.extend(self._chase(
                        field_id, ftype, path, tok, ot, new_name, nctx,
                        nsteps, ndev, nwhy, depth - 1, visited,
                    ))
        return plans

    # -- parsing ---------------------------------------------------------

    def parse_batch(self, lines: Sequence[Union[bytes, str]]) -> "BatchResult":
        t0 = time.perf_counter()
        buf, lengths, overflow = encode_batch(lines)
        stage = {"encode": time.perf_counter() - t0}
        packed = self._run_device(buf, lengths, stage)
        t1 = time.perf_counter()
        result = self._materialize(list(lines), buf, lengths, overflow, packed)
        stage["materialize"] = time.perf_counter() - t1
        result.stage_seconds = stage
        result.d2h_bytes = int(packed.nbytes)
        return result

    def _run_device(self, buf: np.ndarray, lengths: np.ndarray,
                    stage: Dict[str, float]) -> np.ndarray:
        """One H2D copy, the kernels, one D2H copy of the packed rows.
        On the card the device stages are timed with CUDA events."""
        if self.device.type == "cpu":
            t0 = time.perf_counter()
            out = self.executor(torch.from_numpy(buf), torch.from_numpy(lengths))
            stage["kernels"] = time.perf_counter() - t0
            return out.numpy()
        t0 = time.perf_counter()
        host_buf = torch.from_numpy(buf).pin_memory()
        host_len = torch.from_numpy(lengths).pin_memory()
        host_out = torch.empty((self.executor.n_out_rows, buf.shape[0]),
                               dtype=torch.int32, pin_memory=True)
        stage["pin"] = time.perf_counter() - t0
        with torch.cuda.device(self.device):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            dbuf = host_buf.to(self.device, non_blocking=True)
            dlen = host_len.to(self.device, non_blocking=True)
            ev[1].record()
            packed = self.executor(dbuf, dlen)
            ev[2].record()
            host_out.copy_(packed, non_blocking=True)
            ev[3].record()
            ev[3].synchronize()
        stage["h2d"] = ev[0].elapsed_time(ev[1]) / 1e3
        stage["kernels"] = ev[1].elapsed_time(ev[2]) / 1e3
        stage["d2h"] = ev[2].elapsed_time(ev[3]) / 1e3
        return host_out.numpy()

    def _materialize(self, lines, buf, lengths, overflow, packed) -> "BatchResult":
        """Per-line verdicts (the reference's _fetch_packed) and the span /
        long / ts columns (its _materialize_packed) from the packed rows."""
        B = len(lines)
        row0 = np.stack([packed[u.row_offset, :B] for u in self.units])
        validity = (row0 & 1) != 0
        plausible = (row0 & 2) != 0
        valid = validity.any(axis=0)
        winner = np.where(valid, validity.argmax(axis=0), -1)
        plausible_any = plausible.any(axis=0)
        if len(self.units) > 1:
            earlier = np.cumsum(plausible, axis=0) - plausible
            contested = np.take_along_axis(
                earlier, np.maximum(winner, 0)[None, :], axis=0
            )[0] > 0
            winner = np.where(contested, -1, winner)
            valid = valid & ~contested
        for i in overflow:
            # Truncated lines: the device saw a prefix only.
            valid[i] = False
            winner[i] = -1
            plausible_any[i] = True

        columns: Dict[str, Dict[str, np.ndarray]] = {}
        patches = []  # (fid, big rows, overflow rows, wide, hi row)
        ts_cache: Dict[tuple, tuple] = {}
        for fid in self.requested:
            group = _plan_group(self.plan_by_id[fid])
            col = _empty_column(group, B)
            for ui, u in enumerate(self.units):
                sel = winner == ui
                if not sel.any():
                    continue
                plan = u.plan_for(fid)
                block = packed[u.row_offset:u.row_offset + u.layout.n_rows]

                def get(key, comp, _u=u, _block=block):
                    return _u.layout.get(_block, key, comp)[:B]

                if plan.kind == "span":
                    starts = get(fid, "start")
                    col["starts"] = np.where(sel, starts, col["starts"])
                    col["ends"] = np.where(sel, starts + get(fid, "len"), col["ends"])
                    col["ok"] = np.where(sel, get(fid, "ok") != 0, col["ok"])
                    col["null"] = np.where(sel, get(fid, "null") != 0, col["null"])
                elif plan.kind == "ts":
                    key = (ui, ts_group_key(plan))
                    if key not in ts_cache:
                        comp, ok = u.layout.get_ts_components(block, plan)
                        ts_cache[key] = ({k: v[:B] for k, v in comp.items()},
                                         ok[:B], {})
                    comp, ok, derive_memo = ts_cache[key]
                    values = timefields.derive(comp, plan.comp, derive_memo,
                                               locale=plan.meta.locale)
                    col["values"] = np.where(sel, values, col["values"])
                    col["ok"] = np.where(sel, ok, col["ok"])
                else:  # long
                    is_null = get(fid, "null") != 0
                    big = get(fid, "big") != 0
                    hi_row = get(fid, "hi")
                    values, ovf, wide = postproc.combine_long_limbs(
                        hi_row, get(fid, "lo"), get(fid, "d18"),
                        get(fid, "lo_digits"), is_null,
                    )
                    ovf = ovf & ~big & ~is_null
                    row_ok = get(fid, "ok") != 0
                    of_sel = sel & row_ok & valid & (ovf | big)
                    if of_sel.any():
                        patches.append((fid, of_sel & big, of_sel & ovf, wide, hi_row))
                    col["values"] = np.where(sel, values, col["values"])
                    col["null"] = np.where(sel, is_null, col["null"])
                    col["ok"] = np.where(sel, row_ok, col["ok"])
                    if plan.null_mode == "dash_zero":
                        col["null_zero"] = np.where(sel, True, col["null_zero"])
            columns[fid] = col

        # Long overflow (every token of this port has a STRING cast, so the
        # reference delivers the exact integer): 19-digit values beyond
        # Long.MAX from the uint64 frame, >19-digit runs byte-patched from
        # the buffer; a run whose unchecked tail is not all digits goes to
        # the host like any device reject.
        overrides: Dict[str, Dict[int, Any]] = {fid: {} for fid in columns}
        demoted = set()
        span_mask = (1 << _SPAN_BITS) - 1
        for fid, big_rows, ovf_rows, wide, hi_row in patches:
            ov = overrides[fid]
            for i in np.nonzero(ovf_rows)[0]:
                ov[int(i)] = int(wide[i])
            for i in np.nonzero(big_rows)[0]:
                i = int(i)
                word = int(hi_row[i])
                start = word & span_mask
                raw = bytes(buf[i, start:start + (word >> _SPAN_BITS)])
                if raw.isdigit():
                    ov[i] = int(raw)
                else:
                    demoted.add(i)
        for i in demoted:
            valid[i] = False
            winner[i] = -1
            plausible_any[i] = True
            for ov in overrides.values():
                ov.pop(i, None)
        needs_host = np.nonzero(~valid & plausible_any)[0].astype(np.int64)
        return BatchResult(lines, buf, lengths, valid, columns, overrides,
                           needs_host, winner)


def _split_formats(log_format: str) -> List[str]:
    formats: List[str] = []
    for fmt in log_format.splitlines():
        if not fmt.strip() or fmt in formats:
            continue
        if "%" not in fmt and fmt.lower() not in NAMED_FORMATS:
            raise UnsupportedFormatError(
                f"{fmt!r}: only Apache LogFormats are on this slice "
                "(nginx: ROADMAP queue A item 5)"
            )
        formats.append(fmt)
    return formats


def _plan_group(plan: FieldPlan) -> str:
    """Merge group: plans in the same group share column arrays."""
    if plan.kind == "span":
        return "span"
    if plan.kind == "long":
        return "numeric"
    if plan.kind == "ts":
        return "numeric" if timefields.is_numeric_output(plan.comp) else "obj"
    return "host"


def _empty_column(group: str, B: int) -> Dict[str, Any]:
    if group == "span":
        return {"kind": "span", "starts": np.zeros(B, dtype=np.int32),
                "ends": np.zeros(B, dtype=np.int32),
                "ok": np.zeros(B, dtype=bool), "null": np.zeros(B, dtype=bool)}
    if group == "obj":
        return {"kind": "obj", "values": np.full(B, None, dtype=object),
                "ok": np.zeros(B, dtype=bool)}
    return {"kind": "numeric", "values": np.zeros(B, dtype=np.int64),
            "null": np.zeros(B, dtype=bool), "null_zero": np.zeros(B, dtype=bool),
            "ok": np.zeros(B, dtype=bool)}


class BatchResult:
    """Columnar parse result over one batch.

    ``valid[i]`` is the device verdict; ``needs_host`` lists the rows the
    reference would re-parse on its host oracle (their fields read None
    here); ``format_index[i]`` is the winning format (-1 = none)."""

    def __init__(self, lines, buf, lengths, valid, columns, overrides,
                 needs_host, format_index):
        self._lines = lines
        self.buf = buf
        self.lengths = lengths
        self.valid = valid
        self._columns = columns
        self._overrides = overrides
        self.needs_host = needs_host
        self.format_index = format_index
        self.lines_read = len(lines)
        self.stage_seconds: Dict[str, float] = {}
        self.d2h_bytes = 0

    def field_ids(self) -> List[str]:
        return list(self._columns)

    def to_pylist(self, field_id: str) -> List[Any]:
        """One column as Python values (strings / ints / None)."""
        field_id = cleanup_field_value(field_id)
        col = self._columns[field_id]
        overrides = self._overrides.get(field_id, {})
        kind = col["kind"]
        out: List[Any] = []
        for i in range(self.lines_read):
            if i in overrides:
                out.append(overrides[i])
            elif not self.valid[i] or not col["ok"][i]:
                out.append(None)
            elif kind == "numeric":
                if col["null"][i]:
                    out.append(0 if col["null_zero"][i] else None)
                else:
                    out.append(int(col["values"][i]))
            elif kind == "obj":
                v = col["values"][i]
                out.append(v.item() if isinstance(v, np.generic) else v)
            elif col["null"][i]:
                out.append(None)
            else:
                raw = bytes(self.buf[i, int(col["starts"][i]):int(col["ends"][i])])
                out.append(raw.decode("utf-8", errors="replace"))
        return out

    def to_dict(self) -> Dict[str, List[Any]]:
        return {fid: self.to_pylist(fid) for fid in self._columns}

    def to_arrow(self):
        """A pyarrow Table: string columns for spans and text outputs,
        int64 for numbers (the zero-copy string_view tier is a later
        slice)."""
        import pyarrow as pa

        arrays = []
        for fid, col in self._columns.items():
            values = self.to_pylist(fid)
            if col["kind"] == "span":
                arrays.append(pa.array(values, type=pa.string()))
            elif col["kind"] == "numeric":
                arrays.append(pa.array(values, type=pa.int64()))
            else:
                arrays.append(pa.array(values))
        return pa.table(arrays, names=list(self._columns))
