"""TorchBatchParser: a LogFormat + requested fields -> packed device
parse on the card -> columnar :class:`BatchResult`.

The port of the reference package's ``tpu/batch.py`` for this slice:

- Apache LogFormats and NGINX log_formats (one per line; Apache is
  chosen first, as in the reference);
- plan resolution chases each token output through the consumer edges
  the port runs (direct token outputs, the first-line split, the
  protocol-version split, the URI split, the query-string, cookie and
  Set-Cookie wildcards with the Set-Cookie attributes, the timestamp
  bundle of ``%t`` / ``$time_local`` and of each strftime ``%{format}t``
  type, the CLF <-> number conversions, NGINX's seconds-with-millis and
  milli -> micro conversions and upstream-list elements, mod_unique_id,
  the ``type_remappings`` edges, a remapped wildcard parameter's screen
  resolution, and the GeoIP dissectors given as ``extra_dissectors``); a
  field reached any other way, or by more than one path, is a "host"
  plan that the host oracle delivers, except the fields of a later slice
  and fields with no producer, which raise :class:`UnsupportedFieldError`;
  a format the split cannot run becomes a plausibility-only probe unit;
- a batch goes host -> device once (framed straight into pinned memory
  by the native framer, or pinned after the numpy loop; ``non_blocking``
  copies), through the kernels (``UnitsExecutor``), and back once as the
  packed ``[K + 4V, B]`` int32, into pinned memory behind an event; a
  batch whose row 0 carries the CSR overflow bit doubles the query-string
  slots (up to ``CSR_SLOTS_MAX``) and runs again.  ``parse_batch`` takes
  a line list, ``parse_blob`` newline-delimited bytes, and
  ``parse_batch_stream`` overlaps the host's encode and materialization
  with the card's work on the neighbouring batches;
- materialization decides, per line, the winning format, validity and
  plausibility, and decodes span / long / timestamp columns on the host
  (int64 numpy), including the Long-overflow patch of ``%b``, the
  per-row URI repair of ``fix`` spans, the query-string parameters,
  cookies and Set-Cookie cookies and attributes, ``seconds * 1000 +
  millis`` (times the scale), the mod_unique_id words and the GeoIP
  columns (vocabulary strings, NaN / -1 -> None); ``to_arrow`` builds
  the reference's Arrow columns.

Lines the device cannot finish (invalid but still plausible, contested,
truncated, or a query value whose decode fails) and lines won by a
format that cannot supply every requested field go to the host oracle,
the reference's per-line engine (``httpd.parser.HttpdLoglineParser``),
one serial pass; their values are its values, and ``needs_host`` lists
them.  Definitely-bad lines (implausible for every format) are invalid
without a visit.

``aggregate_batch`` / ``aggregate_blob`` / ``aggregate_batch_stream``
are the analytics pushdown: the same kernels, then the aggregate kernels
over the packed rows on the card, and only the partials come back; every
row the device cannot finish exactly replays through ``parse_batch`` and
is folded in from its delivered values.

Every entry runs over a data-axis mesh: ``data_parallel=N`` takes the
largest power of two <= N of ``parallel.mesh.local_devices()``, and
without it (or at a width of 1) the mesh is the parser's device alone.
The batch is padded to a multiple of the width, each shard's rows go
from the pinned buffer to their device and through the executor there,
and the packed rows (an aggregate's class plane, lanes and partials) are
assembled on the mesh's home device and copied back once; a CSR regrow
is decided over all shards and re-runs every shard.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.casts import Cast
from ..core.exceptions import OracleEngineError
from ..dissectors.cookies import parse_attrs
from ..dissectors.screenres import ScreenResolutionDissector
from ..dissectors.strftime_stamp import UnsupportedStrfField, compile_strftime
from ..dissectors.timelayout import APACHE_LAYOUT, TimeLayout
from ..dissectors.tokenformat import STRING_ONLY, UnsupportedFormatError
from ..dissectors.uri import _BAD_ESCAPE_PATTERN, _encode_bad_uri_chars, _percent_decode
from ..dissectors.utils import resilient_url_decode
from ..geoip.device import _EXTRACTORS, GeoDeviceTable
from ..geoip.dissectors import AbstractGeoIPDissector
from ..geoip.mmdb import MMDBReader
from ..httpd.apache import ApacheLogFormat, looks_like_apache_format
from ..httpd.nginx import NginxLogFormat, additional_consumers, looks_like_nginx_format
from ..httpd.parser import HttpdLoglineParser
from ..native import _count_lines, encode_blob, framer
from ..parallel.mesh import (
    ShardedUnits,
    dp_device_count,
    dp_shardings,
    make_mesh,
    padded_rows,
    scatter_rows,
)
from . import postproc, timefields
from .pipeline import (
    CSR_OVERFLOW_BIT,
    CSR_SLOTS,
    CSR_SLOTS_MAX,
    VIEW_ROWS_PER_FIELD,
    FieldPlan,
    FormatUnit,
    PackedLayout,
    UnitsExecutor,
    _SPAN_BITS,
    assign_row_offsets,
    csr_group_key,
    geo_group_key,
    muid_group_key,
    packed_row_count,
    ts_group_key,
)
from .program import (
    CS_CLF_DIGITS,
    CS_DIGITS,
    DeviceProgram,
    compile_device_program,
    compile_plausibility_program,
)
from .runtime import encode_lines
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
# A strftime token's TIME.STRFTIME_... type gets _STRFTIME_CONSUMERS when
# its format compiles to a layout (TorchBatchParser._consumers_of).
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
    "HTTP.COOKIES": [("cookies", [("HTTP.COOKIE", "*")])],
    "HTTP.SETCOOKIES": [("setcookies", [("HTTP.SETCOOKIE", "*")])],
    "BYTESCLF": [("clf_to_number", [("BYTES", "")])],
    "BYTES": [("number_to_clf", [("BYTESCLF", "")])],
    "MOD_UNIQUE_ID": [("muid", [
        ("TIME.EPOCH", "epoch"), ("IP", "ip"), ("PROCESSID", "processid"),
        ("COUNTER", "counter"), ("THREAD_INDEX", "threadindex"),
    ])],
    # The parser's second timestamp dissector (yyyy-MM-dd'T'HH:mm:ssXXX).
    "TIME.ISO8601": [("iso8601", _TIME_OUTPUTS)],
}
_STRFTIME_CONSUMERS = [
    ("timestamp", _TIME_OUTPUTS),
    # The raw value re-emitted as TIME.LOCALIZEDSTRING (keeps the path).
    ("localized", [("TIME.LOCALIZEDSTRING", "")]),
]
_SETCOOKIE_ATTRS = ("value", "path", "domain", "comment", "expires")
# The CSR mode of each wildcard consumer (csr_group_key's meta).
_CSR_MODE = {"querystring": "query", "cookies": "cookie", "setcookies": "setcookie"}


def _strftime_layout(strfformat: str) -> Optional[TimeLayout]:
    """A %{format}t token's layout; None when the format does not compile
    (the token then has no timestamp consumers, as in the reference)."""
    try:
        return compile_strftime(strfformat)
    except UnsupportedStrfField:
        return None


# The fields this port does not deliver yet, and the ROADMAP item that
# brings each; every other field the device cannot decode is a "host" plan,
# delivered by the host oracle.
_LATER = {
    "localized": "TIME.LOCALIZEDSTRING values of strftime timestamps "
                 "(ROADMAP queue A item 5)",
    "none": "no producer in this LogFormat",
    "iso8601": "compile_java_pattern for TIME.ISO8601 (ROADMAP queue A item 5)",
}


class TorchBatchParser:
    """Compiles one LogFormat (or several, one per line, in registration
    order) + requested fields into the port's device executor.

    ``device`` defaults to ``"cuda"`` and raises when CUDA is absent; the
    CPU runs the kernels' plain versions and must be asked for
    (``device="cpu"``).  ``extra_dissectors`` are the reference's keyword:
    GeoIP dissectors over an ``IP`` token resolve to device range joins
    (one flattened table per database).  ``type_remappings`` are the
    reference's keyword too: {field path: type or types}; the chase
    re-types that path's value (mod_unique_id's ``%{UNIQUE_ID}e`` as
    ``MOD_UNIQUE_ID``).  ``data_parallel`` is the reference's keyword:
    the largest power of two <= it of ``parallel.mesh.local_devices()``
    (of the parser's device type) holds the batch's row shards, and the
    mesh's first device becomes ``device``; <= 1, or a resolution of 1,
    makes a one-device mesh of ``device``."""

    def __init__(self, log_format: str, fields: Sequence[str],
                 device: Union[str, torch.device, None] = None,
                 extra_dissectors: Optional[Sequence[Any]] = None,
                 type_remappings: Optional[Dict[str, Any]] = None,
                 data_parallel: Optional[int] = None):
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchBatchParser: CUDA was asked for but is not available "
                "(pass device='cpu' to run the plain PyTorch versions)"
            )
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.data_parallel = data_parallel
        self._mesh = self._build_mesh(data_parallel, self.device)
        if self._mesh.home.type != self.device.type:
            raise ValueError(f"data_parallel={data_parallel}: the mesh's devices are "
                             f"{self._mesh.home.type}, the parser's {self.device}")
        self.device = self._mesh.home
        self.log_format = log_format
        self.requested = list(dict.fromkeys(cleanup_field_value(f) for f in fields))
        self._remaps: Dict[str, Tuple[str, ...]] = {}
        for path, types in (type_remappings or {}).items():
            types = [types] if isinstance(types, str) else types
            key = path.strip().lower()
            self._remaps[key] = tuple(sorted(set(self._remaps.get(key, ()))
                                             | {t.strip().upper() for t in types}))
        self.csr_slots = CSR_SLOTS
        self.units: List[FormatUnit] = []
        self._strftime: Dict[str, Optional[TimeLayout]] = {}
        self._geo_tables: Dict[Tuple[str, str], Optional[GeoDeviceTable]] = {}
        formats = _log_formats(log_format)
        if not formats:
            raise UnsupportedFormatError(f"no LogFormat in {log_format!r}")
        self._consumers = _consumer_table(
            any(isinstance(f, NginxLogFormat) for f in formats), extra_dissectors or ())
        for fmt in formats:
            for ftype, strf in fmt.strftime_types.items():
                self._strftime[ftype] = _strftime_layout(strf)
        for fmt in formats:
            try:
                prog = compile_device_program(fmt)
            except UnsupportedFormatError:
                # A format the split cannot run still contests the others'
                # lines: a separator-order probe, its valid bit never set.
                self.units.append(FormatUnit(
                    compile_plausibility_program(fmt), [],
                    PackedLayout.for_plans([], self.csr_slots), plausibility_only=True))
                continue
            plans = [self._resolve(prog, fid) for fid in self.requested]
            self.units.append(FormatUnit(prog, plans,
                                         PackedLayout.for_plans(plans, self.csr_slots)))
        assign_row_offsets(self.units)
        if all(u.plausibility_only for u in self.units):
            raise UnsupportedFormatError(
                f"no format of {log_format!r} compiles to a device split")
        for fid in self.requested:
            if all(u.plan_for(fid).meta == _LATER["none"]
                   for u in self.units if not u.plausibility_only):
                raise UnsupportedFieldError(f"{fid}: {_LATER['none']}")
        # The merged plan of each field: the first non-host plan across the
        # formats (the columns' kind); lines won by a format whose plan
        # decodes differently, or not at all, take the field from the host
        # oracle (_unit_decodable).
        self.plan_by_id = {fid: self._merged_plan(fid) for fid in self.requested}
        # Without a device field the row path runs no device pass.
        self._device_fields = any(p.kind != "host" for u in self.units for p in u.plans)
        self._build_oracle(log_format, type_remappings, extra_dissectors)
        # Per unit: the fields the oracle supplies for the lines it wins.
        self._unit_oracle_fields: List[List[str]] = [
            [fid for fid in self.requested if not self._unit_decodable(u, fid)]
            for u in self.units
        ]
        self.view_specs = []
        for fid in self.requested:
            if _plan_group(self.plan_by_id[fid]) != "span":
                continue
            unit_idx = tuple(i for i, u in enumerate(self.units)
                             if not u.plausibility_only and self._unit_decodable(u, fid))
            if unit_idx:
                self.view_specs.append((fid, unit_idx))
        self._sharded: Dict[bool, ShardedUnits] = {}   # by emit_views
        self._copy_stream = None   # the side stream of staged H2D copies
        # (canonical spec, device) -> (CSR slots it was built at, AggregateExecutor)
        self._agg_executors: Dict[Tuple[str, torch.device], Tuple[int, Any]] = {}

    def _build_oracle(self, log_format: str, type_remappings, extra_dissectors) -> None:
        """The host oracle (the reference's): a stateless multi-format root
        -- a line's format is chosen by registration order alone, as on the
        device -- with the same remappings and extra dissectors, delivering
        every requested field; the casts of each field type its values."""
        self.oracle = HttpdLoglineParser(_CollectingRecord, log_format)
        self.oracle.all_dissectors[0].stateless = True
        self.oracle.apply_config(type_remappings, extra_dissectors)
        self.oracle.add_parse_target("set_value", list(self.requested))
        self.oracle.assemble_dissectors()
        casts = {fid: self.oracle.get_casts(fid) for fid in self.requested}
        # Setter-cast dispatch flags (LONG, DOUBLE) per field.
        self._cast_flags = {fid: (Cast.LONG in c, Cast.DOUBLE in c)
                            for fid, c in casts.items() if c is not None}
        # Long-overflow delivery per field: a STRING cast stores the digits
        # (delivered as the exact int), LONG alone stores None, anything
        # else re-parses the line on the host.
        self._overflow_delivery = {
            fid: ("int" if c is not None and Cast.STRING in c
                  else "null" if c is not None and Cast.LONG in c and Cast.DOUBLE not in c
                  else "oracle")
            for fid, c in casts.items()}

    def _merged_plan(self, field_id: str) -> FieldPlan:
        for u in self.units:
            p = u.plan_for(field_id)
            if p.kind != "host":
                return p
        return FieldPlan(field_id, "host")

    def _unit_decodable(self, unit: FormatUnit, field_id: str) -> bool:
        """Can lines won by ``unit`` take this field from the device?"""
        merged = self.plan_by_id[field_id]
        if merged.kind == "host":
            return False
        return _plan_group(unit.plan_for(field_id)) == _plan_group(merged)

    @staticmethod
    def _build_mesh(data_parallel: Optional[int], device: torch.device):
        """The data-axis mesh a ``data_parallel`` request resolves to on
        this host; ``device`` alone for no request or a 1-wide one."""
        n = dp_device_count(int(data_parallel)) if data_parallel and int(data_parallel) > 1 else 1
        return make_mesh(n_data=n) if n > 1 else make_mesh(1, devices=[device])

    @property
    def mesh_devices(self) -> int:
        """How many devices the batch is laid over."""
        return self._mesh.size

    @property
    def executor(self) -> UnitsExecutor:
        """The home device's executor, with view rows."""
        return self._executor_for(True).executors[self.device]

    def _scatter(self, B: int, *tensors: torch.Tensor, non_blocking: bool = False):
        """Each tensor's rows of a B-row batch as the mesh's shards (the
        batch padded to the mesh width with zero rows), each on its
        device: one list per tensor."""
        shards = dp_shardings(self._mesh, padded_rows(self._mesh, B))
        return [scatter_rows(t, shards, B, non_blocking) for t in tensors]

    @staticmethod
    def _plan_group(plan: FieldPlan) -> str:
        """A plan's merge group (AggregateSpec.validate_for reads it, as
        it reads the reference's TpuBatchParser._plan_group)."""
        return _plan_group(plan)

    def _grow_csr_slots(self) -> bool:
        """Adaptive CSR: double the query-string slot count (bounded by
        CSR_SLOTS_MAX; the scan windows scale along) and rebuild the
        layouts and the executor's tables.  False at the cap (those lines
        stay in ``needs_host``)."""
        if self.csr_slots >= CSR_SLOTS_MAX:
            return False
        self.csr_slots *= 2
        for u in self.units:
            u.layout = PackedLayout.for_plans(u.plans, self.csr_slots)
        assign_row_offsets(self.units)
        self._sharded = {}
        return True

    # -- plan resolution -------------------------------------------------

    def _resolve(self, program: DeviceProgram, field_id: str) -> FieldPlan:
        """The device plan producing ``field_id``, or a "host" plan (the
        oracle delivers it) unless exactly one chase path reaches it and
        every step is ported: with more than one producer the oracle
        delivers every value in graph order and the record keeps the last.
        Raises for the fields of a later slice (``_LATER``); a field with
        no producer in this format is a host plan whose meta says so."""
        ftype, _, path = field_id.partition(":")
        candidates: List[FieldPlan] = []
        for tok in program.tokens:
            for out_type, out_name in tok.outputs:
                candidates.extend(self._chase(
                    field_id, ftype, path, tok, out_type, out_name,
                    vctx=("", "", 1), steps=(), device_ok=True, why=None,
                    depth=6, visited=frozenset(),
                ))
        if len(candidates) == 1 and candidates[0].kind != "host":
            return candidates[0]
        if not candidates:
            # Raised by __init__ when no format has a producer.
            return FieldPlan(field_id, "host", meta=_LATER["none"])
        later = [c.meta for c in candidates if c.kind == "host" and c.meta]
        if later:
            raise UnsupportedFieldError(f"{field_id}: {later[0]}")
        return FieldPlan(field_id, "host")

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

    def _consumers_of(self, t: str):
        """[(consumer, outputs, dissector or None)] of type ``t``."""
        if t in self._strftime:
            if self._strftime[t] is None:
                return ()
            return [(c, outs, None) for c, outs in _STRFTIME_CONSUMERS]
        return self._consumers.get(t, ())

    def _geo_table_for(self, d: AbstractGeoIPDissector) -> Optional[GeoDeviceTable]:
        """The flattened device table of ``d``'s database (built once per
        database and dissector class); None when it cannot be built."""
        key = (type(d).__name__, d.database_file_name)
        if key not in self._geo_tables:
            try:
                columns = [o.partition(":")[2] for o in d.get_possible_output()
                           if o.partition(":")[2] in _EXTRACTORS]
                self._geo_tables[key] = GeoDeviceTable(
                    MMDBReader(d.database_file_name), columns)
            except Exception:  # noqa: BLE001 -- any unreadable database
                self._geo_tables[key] = None
        return self._geo_tables[key]

    def _step_spec(self, t: str, consumer: str, oname: str, vctx, steps, device_ok,
                   why, dissector=None):
        """(kind, vctx, steps, device_ok, why[, comp, meta]) of the edge
        from type ``t`` through ``consumer`` to output ``oname``; kinds
        ``ts``, ``geo`` and ``ulist`` are terminal (comp, meta follow)."""
        parse = vctx[0]
        if consumer == "clf_to_number" and parse == "":
            return ("value", ("long", "dash_zero", vctx[2]), steps, device_ok, why)
        if consumer == "number_to_clf" and parse == "":
            return ("value", ("long", "zero_null", vctx[2]), steps, device_ok, why)
        if consumer == "muid":
            return ("muid", vctx, steps, device_ok and parse == "", why, oname, None)
        if consumer == "secmillis" and parse == "":
            return ("value", ("secmillis", "", vctx[2]), steps, device_ok, why)
        if consumer == "millis_to_micros":
            # Only a seconds-with-millis value scales on the device.
            return ("value", (parse or "long", vctx[1], vctx[2] * 1000), steps,
                    device_ok and parse == "secmillis", why)
        if consumer == "geo":
            table = self._geo_table_for(dissector) if device_ok and parse == "" else None
            if table is not None and oname in table.columns:
                tag = f"{type(dissector).__name__}:{dissector.database_file_name}"
                return ("geo", vctx, steps, device_ok, why, oname, (tag, oname, table))
            return ("geo", vctx, steps, False, why, oname, None)
        if consumer == "ulist":
            # An indexed upstream-list element; only a STRING-only output
            # is delivered from the span (numeric lists type their values
            # through the host's casts).
            index, _, which = oname.partition(".")
            casts = (dissector.output_original_casts if which == "value"
                     else dissector.output_redirected_casts)
            ok = parse == "" and index.isdigit() and casts == STRING_ONLY
            return ("ulist", vctx, steps, device_ok and ok, why,
                    oname, (int(index), which) if index.isdigit() else None)
        if consumer == "firstline" and parse == "":
            return ("span", vctx, steps + (("fl", oname),), device_ok, why)
        if consumer == "protocol_version" and parse == "":
            part = "version" if oname else "protocol"
            return ("span", vctx, steps + (("pv", part),), device_ok, why)
        if consumer == "uri" and parse == "":
            if oname == "port":
                # The port is numeric on the host: a long over the span.
                return ("value", ("long", vctx[1], vctx[2]),
                        steps + (("uri", oname),), device_ok, why)
            return ("span", vctx, steps + (("uri", oname),), device_ok, why)
        if consumer == "timestamp" and parse == "":
            dl = None
            if oname in timefields.DEVICE_COMPONENTS:
                layout = APACHE_LAYOUT if t == "TIME.STAMP" else self._strftime[t]
                try:
                    dl = compile_layout_for_device(layout)
                except ValueError:
                    dl = None   # a format the layout compiler rejects: host
            return ("ts", vctx, steps, device_ok and dl is not None, why, oname, dl)
        if consumer == "iso8601":
            return ("ts", vctx, steps, False, why or _LATER["iso8601"], oname, None)
        return ("value", vctx, steps, False, why or _LATER.get(consumer))

    def _chase(self, field_id, ftype, path, tok, t, name, vctx, steps,
               device_ok, why, depth, visited, remapped=False) -> List[FieldPlan]:
        """Every way (t:name), reached from ``tok`` via ``steps``, leads to
        the requested (ftype:path) -- the mirror of the reference's
        TpuBatchParser._chase over the edges above.  A type remapping of
        ``name`` re-delivers the value under each mapped type (once: the
        remapped chase does not remap again)."""
        if t == ftype and name == path:
            return [self._terminal_plan(field_id, tok, vctx, steps, device_ok, why)]
        if (t, name) in visited:
            return []
        if not (name == "" or path == name or path.startswith(name + ".")):
            return []
        if depth == 0:
            # A truncated path may still be a producer: count it as host.
            return [FieldPlan(field_id, "host")]
        visited = visited | {(t, name)}
        plans: List[FieldPlan] = []
        if not remapped:
            for ntype in self._remaps.get(name, ()):
                if ntype != t:
                    plans.extend(self._chase(
                        field_id, ftype, path, tok, ntype, name, vctx, steps,
                        device_ok, why, depth - 1, visited, remapped=True))
        for consumer, outputs, dissector in self._consumers_of(t):
            for ot, oname in outputs:
                if oname == "*":
                    plans.extend(self._wildcard(field_id, ftype, path, tok, consumer,
                                                ot, name, vctx, steps, device_ok, why))
                    if not remapped:
                        plans.extend(self._wildcard_remaps(
                            field_id, ftype, path, tok, consumer, name, vctx, steps,
                            device_ok))
                    continue
                new_name = (name + "." + oname if name else oname) if oname else name
                if not (path == new_name or path.startswith(new_name + ".")):
                    continue
                spec = self._step_spec(t, consumer, oname, vctx, steps, device_ok, why,
                                       dissector)
                if spec[0] in ("ts", "geo", "ulist", "muid"):
                    # Terminal values: nothing deeper.
                    kind, _, nsteps, ndev, nwhy, comp, meta = spec
                    if path == new_name and ot == ftype:
                        plans.append(
                            FieldPlan(field_id, kind, tok.index, nsteps,
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

    @staticmethod
    def _wildcard(field_id, ftype, path, tok, consumer, ot, name, vctx, steps,
                  device_ok, why) -> List[FieldPlan]:
        """Plans through a wildcard output: a query-string parameter, a
        cookie or a Set-Cookie cookie is a ``qscsr`` plan (``comp`` = the
        name or ``*``, ``meta`` the mode); a Set-Cookie cookie's attribute
        (``<name>.path``, ...) is one too, with ``attr`` set."""
        if not path.startswith(name + "."):
            return []
        rest = path[len(name) + 1:]
        device = vctx[0] == "" and device_ok
        mode = _CSR_MODE.get(consumer)
        if ot == ftype:
            if device and mode is not None:
                return [FieldPlan(field_id, "qscsr", tok.index, steps, comp=rest,
                                  meta=mode)]
            return [FieldPlan(field_id, "host", meta=why)]
        cname, _, attr = rest.rpartition(".")
        typed = ((ftype == "STRING" and attr in _SETCOOKIE_ATTRS)
                 or (ftype == "TIME.EPOCH" and attr == "expires"))
        if consumer == "setcookies" and cname and typed:
            if device:
                return [FieldPlan(field_id, "qscsr", tok.index, steps, comp=cname,
                                  meta=mode, attr=attr)]
            return [FieldPlan(field_id, "host", meta=why)]
        return []

    def _wildcard_remaps(self, field_id, ftype, path, tok, consumer, name, vctx,
                         steps, device_ok) -> List[FieldPlan]:
        """Plans through a wildcard parameter that a type remapping
        re-types (the reference's query.res -> SCREENRESOLUTION): the
        remapped value itself is a ``qscsr`` plan of a query or cookie
        wildcard, a ScreenResolutionDissector's width / height one with
        ``attr`` ("sres", separator, part); any other consumer of the
        remapped type is a host producer."""
        mode = {"querystring": "query", "cookies": "cookie"}.get(consumer)
        device = mode is not None and vctx[0] == "" and device_ok
        plans: List[FieldPlan] = []
        prefix = name + "."
        for remap_key, ntypes in self._remaps.items():
            if not remap_key.startswith(prefix):
                continue
            param = remap_key[len(prefix):]
            if path == remap_key:
                plans.extend(FieldPlan(field_id, "qscsr", tok.index, steps, comp=param,
                                       meta=mode) if device else FieldPlan(field_id, "host")
                             for ntype in ntypes if ntype == ftype)
                continue
            if not path.startswith(remap_key + "."):
                continue
            sub = path[len(remap_key) + 1:]
            for ntype in ntypes:
                for _, outputs, d in self._consumers_of(ntype):
                    for ot2, oname2 in outputs:
                        if oname2 == sub and ot2 == ftype:
                            if (device and isinstance(d, ScreenResolutionDissector)
                                    and oname2 in ("width", "height")):
                                plans.append(FieldPlan(
                                    field_id, "qscsr", tok.index, steps, comp=param,
                                    meta=mode, attr=("sres", d.separator, oname2)))
                            else:
                                plans.append(FieldPlan(field_id, "host"))
                        elif sub.startswith(oname2 + "."):
                            # Deeper chains through the remapped type: host.
                            plans.append(FieldPlan(field_id, "host"))
        return plans

    # -- parsing ---------------------------------------------------------
    #
    # A batch goes encode -> dispatch -> fetch -> materialize.  On the card
    # dispatch only enqueues (H2D, the kernels, the D2H into pinned host
    # memory, with events), so a stream can encode batch k + 1 and
    # materialize batch k while the card works; fetch waits on the D2H
    # event.  On the CPU dispatch runs the plain versions to the end.

    def parse_batch(self, lines: Sequence[Union[bytes, str]],
                    emit_views: Optional[bool] = None) -> "BatchResult":
        """Lines -> BatchResult.  ``emit_views=False`` runs the executor
        without the per-field view rows (less D2H; ``to_dict()`` and
        ``to_arrow()`` are the same either way)."""
        return self._finish(self._dispatch(self._encode(list(lines)), emit_views))

    def parse_blob(self, data: Union[bytes, bytearray, memoryview],
                   emit_views: Optional[bool] = None) -> "BatchResult":
        """Newline-delimited log bytes -> BatchResult without a Python line
        list: the native framer packs the padded [B, L] buffer straight
        from the blob (into pinned memory on the card), and a line
        materializes as bytes only when indexed.  Framing is
        ``native.encode_blob``'s: a final empty segment after a trailing
        newline is dropped and one trailing ``\\r`` per line is stripped."""
        batch = self._encode_blob(bytes(data))
        if isinstance(batch, _BlobLines):  # framer / view disagreement
            return self.parse_batch(list(batch), emit_views=emit_views)
        return self._finish(self._dispatch(batch, emit_views))

    def parse_batch_stream(self, batches, depth: int = 1,
                           emit_views: Optional[bool] = None,
                           stage_h2d: Optional[bool] = None):
        """One BatchResult per batch of lines, in order, each equal to its
        ``parse_batch``.  Up to ``depth`` batches are on the card at once:
        the host encodes batch k + 1 while batch k runs, and materializes
        batch k while batch k + 1 runs.  ``stage_h2d`` (default on) starts
        batch k + 1's H2D copy on a side stream before waiting for batch
        k's D2H.  A CSR regrow rebuilds the executor; every pending batch
        dispatched at the old slot count is dispatched again at its fetch."""
        stage_h2d = True if stage_h2d is None else stage_h2d
        depth = max(1, depth)
        pending: deque = deque()
        for lines in batches:
            batch = self._encode(list(lines))
            if stage_h2d:
                self._stage_h2d(batch)
            if len(pending) >= depth:
                fetched = self._fetch(pending.popleft())
                pending.append(self._dispatch(batch, emit_views))
                yield self._materialize_fetched(*fetched)
            else:
                pending.append(self._dispatch(batch, emit_views))
        while pending:
            yield self._finish(pending.popleft())

    def _executor_for(self, emit_views: Optional[bool]) -> ShardedUnits:
        """The mesh's executors with view rows (the default), or without
        them when ``emit_views`` is False; each built at first use."""
        views = emit_views is None or emit_views
        if views not in self._sharded:
            self._sharded[views] = ShardedUnits(
                self.units, self._mesh, self.view_specs if views else ())
        return self._sharded[views]

    def _encode(self, lines: List[Union[bytes, str]]) -> "_Batch":
        alloc = _PinnedAlloc() if self.device.type == "cuda" else None
        t0 = time.perf_counter()
        buf, lengths, overflow, framer = encode_lines(lines, alloc=alloc)
        return _Batch(lines, buf, lengths, overflow, framer,
                      time.perf_counter() - t0, alloc)

    def _encode_blob(self, data: bytes):
        """The blob framed as a _Batch, or its _BlobLines when the framer
        and the line view disagree on the count."""
        lines = _BlobLines(data)
        alloc = _PinnedAlloc() if self.device.type == "cuda" else None
        t0 = time.perf_counter()
        buf, lengths, overflow = encode_blob(data, alloc=alloc)
        if buf.shape[0] != len(lines):
            return lines
        return _Batch(lines, buf, lengths, overflow, framer(),
                      time.perf_counter() - t0, alloc)

    def _upload(self, batch: "_Batch", stream) -> None:
        """Pin (unless the framer wrote into pinned memory) and start the
        batch's H2D copy on ``stream``, between two events.  ``dbuf`` /
        ``dlen`` are the mesh's shards' rows, each copied straight
        from the pinned buffer to its device (on ``stream`` for the home
        device, on its own current stream for another; the events time
        the home device's copies)."""
        if batch.dbuf is not None:
            return
        t0 = time.perf_counter()
        host_buf, host_len = batch.pinned()
        batch.add("pin", time.perf_counter() - t0)
        compute = torch.cuda.current_stream(self.device)
        batch.h2d = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with torch.cuda.stream(stream):
            batch.h2d[0].record(stream)
            batch.dbuf, batch.dlen = self._scatter(batch.buf.shape[0], host_buf,
                                                   host_len, non_blocking=True)
            batch.h2d[1].record(stream)
        if stream != compute:
            # Made on the side stream, read on the compute stream.
            for t in batch.dbuf + batch.dlen:
                if t.device == self.device:
                    t.record_stream(compute)

    def _stage_h2d(self, batch: "_Batch") -> None:
        """Start the batch's H2D copy on the side copy stream, so that it
        overlaps the work already on the card (a no-op on the CPU)."""
        if self.device.type != "cuda" or not self._device_fields:
            return
        with torch.cuda.device(self.device):
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            self._upload(batch, self._copy_stream)

    def _dispatch(self, batch: "_Batch", emit_views: Optional[bool]) -> "_Pending":
        """Enqueue the batch's device pass at the current slot count (none
        when every requested field is the host oracle's, as in the
        reference: the oracle then judges every line)."""
        pend = _Pending(batch, emit_views, self.csr_slots)
        if not self._device_fields:
            return pend
        executor = self._executor_for(emit_views)
        if self.device.type == "cpu":
            t0 = time.perf_counter()
            B = batch.buf.shape[0]
            buf, lengths = torch.from_numpy(batch.buf), torch.from_numpy(batch.lengths)
            pend.packed = executor(*self._scatter(B, buf, lengths), B).numpy()
            batch.add("kernels", time.perf_counter() - t0)
            return pend
        with torch.cuda.device(self.device):
            compute = torch.cuda.current_stream(self.device)
            self._upload(batch, compute)
            # The kernels wait for the copy, wherever it ran.
            compute.wait_event(batch.h2d[1])
            pend.events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            pend.events[0].record()
            packed = executor(batch.dbuf, batch.dlen, batch.buf.shape[0])
            pend.events[1].record()
            pend.host_out = torch.empty(tuple(packed.shape), dtype=torch.int32,
                                        pin_memory=True)
            pend.host_out.copy_(packed, non_blocking=True)
            pend.events[2].record()
        return pend

    def _fetch(self, pend: "_Pending"):
        """Wait for one dispatched batch's packed rows: (batch, packed,
        regrows).  A batch dispatched before a regrow is dispatched again;
        a batch whose row 0 carries the CSR overflow bit doubles the slots
        (up to CSR_SLOTS_MAX) and runs again."""
        batch, B = pend.batch, pend.batch.buf.shape[0]
        regrows = 0
        while True:
            if pend.slots != self.csr_slots:
                pend = self._dispatch(batch, pend.emit_views)
            if pend.events is not None:
                ev = pend.events
                ev[2].synchronize()
                batch.count_h2d()
                batch.add("kernels", ev[0].elapsed_time(ev[1]) / 1e3)
                batch.add("d2h", ev[1].elapsed_time(ev[2]) / 1e3)
                pend.packed = pend.host_out.numpy()
            packed = pend.packed
            if packed is None:   # no device pass
                return batch, packed, regrows
            row0 = np.stack([packed[u.row_offset, :B] for u in self.units])
            if not ((row0 & CSR_OVERFLOW_BIT) != 0).any() or not self._grow_csr_slots():
                return batch, packed, regrows
            regrows += 1

    def _finish(self, pend: "_Pending") -> "BatchResult":
        return self._materialize_fetched(*self._fetch(pend))

    def _materialize_fetched(self, batch: "_Batch", packed: np.ndarray,
                             regrows: int) -> "BatchResult":
        t1 = time.perf_counter()
        result = self._materialize(batch.lines, batch.buf, batch.lengths,
                                   batch.overflow, packed)
        batch.add("materialize", time.perf_counter() - t1)
        result.stage_seconds = batch.stage
        result.d2h_bytes = 0 if packed is None else int(packed.nbytes)
        result.csr_regrows = regrows
        result.framer = batch.framer
        return result

    # -- analytics pushdown ----------------------------------------------

    def _resolve_agg_spec(self, spec):
        """An ``AggregateSpec`` passes through as it is; an op list or a
        JSON string is parsed and validated against this parser's fields
        (the reference's rule)."""
        from ..analytics.spec import AggregateSpec, parse_aggregate_config

        if isinstance(spec, AggregateSpec):
            return spec
        parsed = parse_aggregate_config(spec)
        if parsed is None:
            raise ValueError("aggregate: need a spec (op list, JSON string, "
                             "or AggregateSpec)")
        parsed.validate_for(self)
        return parsed

    def aggregate_batch(self, lines: Sequence[Union[bytes, str]], spec):
        """Parse and aggregate one batch on the device: an
        :class:`~logparser_tpu_torch.analytics.state.AggregateOutcome`
        whose ``state`` holds this batch's partial aggregates (merge
        across batches with ``AggregateState.merge``).  ``spec`` is an
        ``AggregateSpec``, an op list or a JSON string."""
        spec = self._resolve_agg_spec(spec)
        return self._finish_aggregate(self._dispatch_aggregate(
            self._encode(list(lines)), spec))

    def aggregate_blob(self, data: Union[bytes, bytearray, memoryview], spec):
        """``parse_blob``'s framing, ``aggregate_batch``'s delivery."""
        spec = self._resolve_agg_spec(spec)
        batch = self._encode_blob(bytes(data))
        if isinstance(batch, _BlobLines):  # framer / view disagreement
            return self.aggregate_batch(list(batch), spec)
        return self._finish_aggregate(self._dispatch_aggregate(batch, spec))

    def aggregate_batch_stream(self, batches, spec, depth: int = 1):
        """One AggregateOutcome per batch, in order, each equal to its
        ``aggregate_batch``.  Up to ``depth`` batches wait on the card
        while the host accumulates (and folds) the oldest one's partials:
        the accumulation of batch k overlaps the device work of k + 1."""
        spec = self._resolve_agg_spec(spec)
        depth = max(1, depth)
        pending: deque = deque()
        for lines in batches:
            pending.append(self._dispatch_aggregate(self._encode(list(lines)), spec))
            if len(pending) > depth:
                yield self._finish_aggregate(pending.popleft())
        while pending:
            yield self._finish_aggregate(pending.popleft())

    def _agg_executor(self, spec, device: Optional[torch.device] = None):
        """The aggregate executor of this parser and spec on ``device``
        (default the parser's), cached per (canonical spec, device, CSR
        slot count): a regrow rebuilds the layouts, so the executor
        rebuilds with them."""
        from ..analytics.device import AggregateExecutor

        device = self.device if device is None else device
        key = (spec.canonical_key(), device)
        cached = self._agg_executors.get(key)
        if cached is not None and cached[0] == self.csr_slots:
            return cached[1]
        ex = AggregateExecutor(self, spec).to(device)
        self._agg_executors[key] = (self.csr_slots, ex)
        return ex

    def _dispatch_aggregate(self, batch: "_Batch", spec) -> "_Pending":
        """Enqueue the aggregate's device pass; the pending batch keeps its
        executor (a later regrow builds another)."""
        B = batch.buf.shape[0]
        # Truncated lines: the device saw a prefix only; they fold.
        batch.host_kill = np.zeros(B, dtype=np.uint8)
        batch.host_kill[batch.overflow] = 1
        pend = _Pending(batch, None, self.csr_slots)
        pend.spec = spec
        pend.executor = self._agg_executor(spec)
        if self.device.type == "cpu":
            t0 = time.perf_counter()
            buf, lengths = torch.from_numpy(batch.buf), torch.from_numpy(batch.lengths)
            kill = torch.from_numpy(batch.host_kill)
            pend.out = self._aggregate_shards(spec, *self._scatter(B, buf, lengths, kill), B)
            batch.add("kernels", time.perf_counter() - t0)
            return pend
        with torch.cuda.device(self.device):
            compute = torch.cuda.current_stream(self.device)
            t0 = time.perf_counter()
            kill = torch.from_numpy(batch.host_kill).pin_memory()
            batch.add("pin", time.perf_counter() - t0)
            self._upload(batch, compute)
            pend.events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            (kills,) = self._scatter(B, kill, non_blocking=True)
            pend.events[0].record()
            pend.out = self._aggregate_shards(spec, batch.dbuf, batch.dlen, kills, B)
            pend.events[1].record()
        return pend

    def _aggregate_shards(self, spec, bufs, lengths, kills, B: int):
        """The mesh aggregate (the reference's data-sharded in, replicated
        out) over the shards' rows, lengths and host_kill planes."""
        from ..analytics.device import aggregate_shards

        executors = {b.device: self._agg_executor(spec, b.device) for b in bufs}
        return aggregate_shards(executors, bufs, lengths, kills, B, self.device)

    def _finish_aggregate(self, pend: "_Pending"):
        """Copy one aggregate's partials back, accumulate them, and replay
        its folded rows through ``parse_batch``."""
        from ..analytics.device import accumulate_partials, fetch_partials
        from ..analytics.state import AggregateOutcome, AggregateState

        batch, spec, ex = pend.batch, pend.spec, pend.executor
        lines, buf, stage = batch.lines, batch.buf, batch.stage
        B = buf.shape[0]
        if pend.events is not None:
            pend.events[1].synchronize()   # this batch's kernels, not later ones
        t0 = time.perf_counter()
        if pend.events is None:
            fetched, nbytes = fetch_partials(pend.out, ex.tables, B)
        else:
            with torch.cuda.device(self.device):
                if self._copy_stream is None:
                    self._copy_stream = torch.cuda.Stream(self.device)
                # The copies wait for this batch's kernels only, not for
                # batches dispatched after it.
                self._copy_stream.wait_event(pend.events[1])
                with torch.cuda.stream(self._copy_stream):
                    fetched, nbytes = fetch_partials(pend.out, ex.tables, B)
            batch.count_h2d()
            batch.add("kernels", pend.events[0].elapsed_time(pend.events[1]) / 1e3)
        pend.out = None
        stage["d2h"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        state = AggregateState(spec)
        accumulate_partials(state, spec, fetched, buf)
        stage["accumulate"] = time.perf_counter() - t1
        cls = fetched["cls"]
        n_device = int(np.count_nonzero(cls == 0))
        fold_rows = np.nonzero(cls == 1)[0]
        bad_rows = np.nonzero(cls == 2)[0]
        reject_items = [(int(i), "implausible", _raw_line_bytes(lines[int(i)]))
                        for i in bad_rows]
        needs_host = np.zeros(0, dtype=np.int64)
        good, bad = n_device, len(bad_rows)
        sub = None
        if len(fold_rows):
            # Exactness fold: every flagged row replays the row path (the
            # host oracle's rescue included) and is aggregated from its
            # delivered values.
            t2 = time.perf_counter()
            sub = self.parse_batch([lines[int(i)] for i in fold_rows], emit_views=False)
            state.update_from_result(sub)
            stage["fold"] = time.perf_counter() - t2
            needs_host = fold_rows[sub.needs_host].astype(np.int64)
            good += sub.good_lines
            bad += sub.bad_lines
            reject_items += [(int(fold_rows[j]), reason, sub.raw_line(j))
                             for j, reason in sub.reject_reasons.items()]
            reject_items.sort(key=lambda item: item[0])
        row_bytes = 4 * B * (packed_row_count(self.units)
                             + VIEW_ROWS_PER_FIELD * len(self.view_specs))
        out = AggregateOutcome(
            state, B, good, bad, needs_host, reject_items,
            device_rows=n_device, fold_rows=len(fold_rows), d2h_bytes=nbytes,
            row_path_d2h_bytes=row_bytes, stage_seconds=stage,
        )
        if sub is not None:
            out.rescue_reasons, out.rescue_wall_s = sub.rescue_reasons, sub.rescue_wall_s
        return out

    def _materialize(self, lines, buf, lengths, overflow, packed) -> "BatchResult":
        """Per-line verdicts (the reference's _fetch_packed), the span /
        long / ts columns (its _materialize_packed) from the packed rows,
        and the host oracle's rescue of the rows the device cannot finish."""
        B = len(lines)
        if packed is None:
            # No device verdict: the oracle judges every line.
            valid = np.zeros(B, dtype=bool)
            winner = np.full(B, -1, dtype=np.int64)
            plausible_any = np.ones(B, dtype=bool)
        else:
            row0 = np.stack([packed[u.row_offset, :B] for u in self.units])
            validity = (row0 & 1) != 0
            plausible = (row0 & 2) != 0
            valid = validity.any(axis=0)
            winner = np.where(valid, validity.argmax(axis=0), -1)
            plausible_any = plausible.any(axis=0)
        if packed is not None and len(self.units) > 1:
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
        patches = []  # (fid, plan, big rows, overflow rows, wide, hi row)
        ts_cache: Dict[tuple, tuple] = {}
        for fid in self.requested:
            merged = self.plan_by_id[fid]
            group = _plan_group(merged)
            col = _empty_column(group, B)
            if group == "span":
                # Which per-row repair `fix` rows need: the final uri step
                # decides (path / userinfo: %-repair + decode; query:
                # %-repair only).
                col["fix_mode"] = (merged.steps[-1][1] if merged.steps
                                   and merged.steps[-1][0] == "uri" else "")
            columns[fid] = col
            if group in ("wild", "host"):
                continue  # _materialize_csr below / the oracle
            for ui, u in enumerate(self.units):
                if not self._unit_decodable(u, fid):
                    continue   # lines won by this unit take the oracle's value
                sel = winner == ui
                if not sel.any():
                    continue
                plan = u.plan_for(fid)
                block = packed[u.row_offset:u.row_offset + u.layout.n_rows]

                def get(key, comp, _u=u, _block=block):
                    return _u.layout.get(_block, key, comp)[:B]

                if plan.kind in ("span", "ulist"):
                    starts = get(fid, "start")
                    col["starts"] = np.where(sel, starts, col["starts"])
                    col["ends"] = np.where(sel, starts + get(fid, "len"), col["ends"])
                    col["ok"] = np.where(sel, get(fid, "ok") != 0, col["ok"])
                    col["null"] = np.where(sel, get(fid, "null") != 0, col["null"])
                    col["amp"] = np.where(sel, get(fid, "amp") != 0, col["amp"])
                    col["fix"] = np.where(sel, get(fid, "fix") != 0, col["fix"])
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
                elif plan.kind == "muid":
                    key = muid_group_key(plan)
                    ok = get(key, "ok") != 0
                    row = {"epoch": "time", "ip": "ip", "processid": "pid",
                           "counter": "counter", "threadindex": "thread"}[plan.comp]
                    u32 = get(key, row).astype(np.int64) & 0xFFFFFFFF
                    if plan.comp == "ip":
                        dot = np.full(B, ".", dtype=object)
                        values = (_OCTETS[u32 >> 24] + dot + _OCTETS[(u32 >> 16) & 255]
                                  + dot + _OCTETS[(u32 >> 8) & 255] + dot
                                  + _OCTETS[u32 & 255])
                        values = np.where(ok, values, None)
                    else:
                        values = u32 * 1000 if plan.comp == "epoch" else u32
                    col["values"] = np.where(sel, values, col["values"])
                    col["ok"] = np.where(sel, ok, col["ok"])
                elif plan.kind == "geo":
                    _, column, table = plan.meta
                    key = geo_group_key(plan)
                    arr = table.arrays[column][get(key, "row")]
                    if column in table.vocabs:
                        values = table.vocab_arrays[column][arr]
                    else:   # float NaN / int -1: the miss
                        values = arr.astype(object)
                        values[np.isnan(arr) if arr.dtype.kind == "f" else arr < 0] = None
                    col["values"] = np.where(sel, values, col["values"])
                    col["ok"] = np.where(sel, get(key, "ok") != 0, col["ok"])
                else:  # long / secmillis
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
                        patches.append((fid, plan, of_sel & big, of_sel & ovf,
                                        wide, hi_row))
                    if plan.kind == "secmillis":
                        values = values * 1000 + get(fid, "milli")
                    if plan.scale != 1:
                        values = values * plan.scale
                    if plan.null_mode == "zero_null":
                        is_null = is_null | (values == 0)
                    col["values"] = np.where(sel, values, col["values"])
                    col["null"] = np.where(sel, is_null, col["null"])
                    col["ok"] = np.where(sel, row_ok, col["ok"])
                    if plan.null_mode == "dash_zero":
                        col["null_zero"] = np.where(sel, True, col["null_zero"])

        # Long overflow: 19-digit values beyond Long.MAX from the uint64
        # frame, >19-digit runs byte-patched from the buffer, delivered as
        # the oracle's casts would (_overflow_delivery); a run whose
        # unchecked tail is not all digits, and an overflow of any other
        # plan, re-parses the line on the host.
        overrides: Dict[str, Dict[int, Any]] = {fid: {} for fid in columns}
        demoted = set()
        span_mask = (1 << _SPAN_BITS) - 1
        for fid, plan, big_rows, ovf_rows, wide, hi_row in patches:
            mode = self._overflow_delivery.get(fid, "oracle")
            if (plan.kind != "long" or plan.steps or plan.scale != 1
                    or plan.null_mode == "zero_null" or mode not in ("int", "null")):
                demoted.update(int(i) for i in np.nonzero(big_rows | ovf_rows)[0])
                continue
            ov = overrides[fid]
            if mode == "null":
                for i in np.nonzero(big_rows | ovf_rows)[0]:
                    ov[int(i)] = None
                continue
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
        inv = ~valid
        bad = int(np.count_nonzero(inv & ~plausible_any))
        invalid_rows = set(np.nonzero(inv & plausible_any)[0].tolist())
        # Every row that ends invalid carries a reason: "implausible" (no
        # format plausible, no oracle visit), "oracle_reject" (the oracle
        # refused it) or "oracle_error" (the oracle itself failed).
        reject_reasons: Dict[int, str] = {
            int(i): "implausible" for i in np.nonzero(inv & ~plausible_any)[0]}
        # The oracle visits the lines no format accepted (but some format
        # could still match) and the lines won by a format that cannot
        # supply every requested field.
        need_oracle = set(invalid_rows)
        for ui, flds in enumerate(self._unit_oracle_fields):
            if flds:
                need_oracle.update(np.nonzero(winner == ui)[0].tolist())
        # Query parameters; a value whose decode fails fails the line on
        # the host, so those rows go there.
        for i in self._materialize_csr(packed, winner, valid, columns, overrides,
                                       buf, B):
            valid[i] = False
            winner[i] = -1
            for ov in overrides.values():
                ov.pop(i, None)
            invalid_rows.add(i)
            need_oracle.add(i)
        overflow_rows = {int(i) for i in overflow if 0 <= int(i) < B}
        rescue_reasons = {"overflow": 0, "device_reject": 0, "host_fields": 0}
        if need_oracle:
            rescue_reasons["overflow"] = len(overflow_rows & need_oracle)
            rescue_reasons["device_reject"] = len(invalid_rows - overflow_rows)
            rescue_reasons["host_fields"] = len(need_oracle - invalid_rows - overflow_rows)
        t_oracle = time.perf_counter()
        oracle_rows = sorted(need_oracle)
        results = self._run_oracle_many([lines[i] for i in oracle_rows])
        plans: Dict[Tuple[bool, int], tuple] = {}
        for i, values in zip(oracle_rows, results):
            is_invalid = i in invalid_rows
            if values is None or isinstance(values, OracleEngineError):
                # The oracle refused the line (or failed on it): an invalid
                # line is a reject; a device-valid one keeps its device
                # columns, its host fields unresolved.
                if is_invalid:
                    bad += 1
                    reject_reasons[i] = ("oracle_error" if isinstance(
                        values, OracleEngineError) else "oracle_reject")
                continue
            if is_invalid:
                valid[i] = True
            key = (is_invalid, int(winner[i]))
            if key not in plans:
                plans[key] = self._delivery_plan(
                    self.requested if is_invalid else self._unit_oracle_fields[winner[i]],
                    int(winner[i]), overrides)
            concrete, wild = plans[key]
            for fid, ov, mode in concrete:
                v = values.get(fid)
                if v is None or mode == "plain":
                    ov[i] = v
                elif mode == "num":
                    try:
                        ov[i] = int(v)
                    except (TypeError, ValueError):
                        ov[i] = None
                else:
                    ov[i] = _apply_setter_casts(v, *mode)
            for fid, ov, prefix in wild:
                # {relative name: value} from every delivered field under the
                # prefix (the oracle stores them under their TYPE:path ids).
                ov[i] = {k[len(prefix):]: v for k, v in values.items()
                         if k.startswith(prefix)}
        result = BatchResult(lines, buf, lengths, valid, columns, overrides,
                             np.asarray(oracle_rows, dtype=np.int64), winner)
        result.good_lines = B - bad
        result.bad_lines = bad
        result.reject_reasons = reject_reasons
        result.rescue_reasons = rescue_reasons
        result.rescue_wall_s = time.perf_counter() - t_oracle
        return result

    def _delivery_plan(self, fields, winner: int, overrides):
        """How the oracle's values of ``fields`` are delivered on a line
        won by ``winner`` (-1: none): (concrete [(fid, overrides, mode)],
        wildcards [(fid, overrides, prefix)]); the mode types the value as
        the winner's column would ("num"), by the field's setter casts
        ((has LONG, has DOUBLE)), or not at all ("plain")."""
        concrete, wild = [], []
        for fid in fields:
            if fid.endswith(".*"):
                wild.append((fid, overrides[fid], fid[:-1]))
                continue
            plan = self.units[winner].plan_for(fid) if winner >= 0 else self.plan_by_id[fid]
            flags = self._cast_flags.get(fid)
            if _plan_group(plan) == "numeric":
                mode = "num"
            elif flags and (flags[0] or flags[1]):
                mode = flags
            else:
                mode = "plain"
            concrete.append((fid, overrides[fid], mode))
        return concrete, wild

    def _run_oracle_many(self, lines) -> List[Any]:
        """The oracle over ``lines``, one serial pass: per line its values
        dict, None (refused) or an OracleEngineError."""
        decoded = [ln.decode("utf-8", errors="replace") if isinstance(ln, bytes) else ln
                   for ln in lines]
        return [rec if rec is None or isinstance(rec, OracleEngineError) else rec.values
                for rec in self.oracle.parse_many(decoded, _CollectingRecord)]

    def _materialize_csr(self, packed, winner, valid, columns, overrides, buf, B) -> set:
        """Query-string parameters, cookies and Set-Cookie cookies from the
        packed segment tables (the reference's _materialize_csr), for the
        rows each unit claims.  A concrete name fills its span column with
        the value of the last segment of that name (an override when that
        value was decoded); a ``.*`` field gets one dict per row; a
        Set-Cookie attribute parses the last matching cookie's text.
        Segments that need per-value Python take the reference's per-row
        path: a URI query name that needs %-repair, a flagged value of a
        query string over a token, a cookie with a flagged value or a
        whitespace / non-ASCII byte at a name or value edge (the host
        trims), a Set-Cookie name with such an edge.  The other rows
        decode flagged URI query values with the left-to-right '+' / %XX
        rule.  Returns the rows whose value decode failed."""
        failed: set = set()
        L = buf.shape[1]
        flat_buf = buf.reshape(-1)
        for ui, u in enumerate(self.units):
            qs = [(fid, u.plan_for(fid)) for fid in self.requested
                  if u.plan_for(fid).kind == "qscsr"]
            rows = np.nonzero((winner == ui) & valid)[0]
            if not qs or rows.size == 0:
                continue
            block = packed[u.row_offset:u.row_offset + u.layout.n_rows]
            by_key: Dict[str, List[Tuple[str, FieldPlan]]] = {}
            for fid, p in qs:
                by_key.setdefault(csr_group_key(p), []).append((fid, p))
            for key, flist in by_key.items():
                mode = flist[0][1].meta
                uri_chain = bool(flist[0][1].steps)
                slots = u.layout.slots[key]
                K = u.layout.csr_slots
                # Each slot packs into two rows (start... and vstart...):
                # gather both [K, rows] word blocks once, then the fields.
                words = {part: block[[slots[f"s{k}_{part}"][0] for k in range(K)]][:, rows]
                         for part in ("start", "vstart")}

                def mat(comp, _slots=slots, _words=words):
                    _, shift, bits = _slots[f"s0_{comp}"]
                    part = "vstart" if comp.startswith("v") else "start"
                    return ((_words[part] >> shift) & ((1 << bits) - 1)).astype(np.int64)

                ok = (u.layout.get(block, key, "ok")[:B][rows] != 0)
                SS, NL, VS, VL = mat("start"), mat("nlen"), mat("vstart"), mat("vlen")
                HE, DC, ND = (mat(c).astype(bool) for c in ("eq", "dec", "ndec"))
                emit = (NL > 0) & ok[None, :]

                def edge(S, N, _rows=rows):
                    # A byte <= 0x20 or >= 0x80 at either end of a span.
                    a = _rows[None, :] * L + S
                    first = flat_buf[np.where(N > 0, a, 0)]
                    last = flat_buf[np.where(N > 0, a + N - 1, 0)]
                    return (N > 0) & ((first <= 0x20) | (first >= 0x80)
                                      | (last <= 0x20) | (last >= 0x80))

                if mode == "setcookie":
                    emit &= HE
                    flag = edge(SS, NL)
                    VLe = VL
                elif mode == "cookie":
                    flag = DC | edge(SS, NL) | edge(VS, VL)
                    VLe = np.where(HE, VL, 0)
                else:
                    flag = ND if uri_chain else DC
                    VLe = np.where(HE, VL, 0)
                slow = (flag & emit).any(axis=0)
                fast = ~slow
                segs = _QuerySegments(buf, rows[fast], emit[:, fast], SS[:, fast],
                                      NL[:, fast], VS[:, fast], VLe[:, fast],
                                      DC[:, fast] & uri_chain)
                slow_dicts = {}
                for j in np.nonzero(slow)[0].tolist():
                    i = int(rows[j])
                    d = _csr_dict_slow(buf[i], mode, uri_chain, NL[:, j], HE[:, j],
                                       SS[:, j], VS[:, j], VL[:, j], DC[:, j], ND[:, j])
                    if d is None:
                        failed.add(i)
                    slow_dicts[i] = d
                attrs_memo: Dict[str, dict] = {}
                for fid, p in flist:
                    ov = overrides[fid]
                    if p.comp == "*":
                        ov.update(segs.dicts())
                        ov.update((i, d) for i, d in slow_dicts.items() if d is not None)
                    elif isinstance(p.attr, tuple):
                        # A remapped screen resolution: the last segment's
                        # value split on the separator.
                        texts = segs.last_values(p.comp)
                        texts.update((i, d.get(p.comp)) for i, d in slow_dicts.items() if d)
                        for i, text in texts.items():
                            value = _sres_value(p.attr, text)
                            if value is not None:
                                ov[i] = _apply_setter_casts(
                                    value, *self._cast_flags.get(fid, (False, False)))
                    elif p.attr:
                        akey = ("expires_epoch" if p.attr == "expires"
                                and fid.startswith("TIME.EPOCH:") else p.attr)
                        texts = segs.last_values(p.comp)
                        texts.update((i, d.get(p.comp)) for i, d in slow_dicts.items() if d)
                        for i, text in texts.items():
                            if not text:
                                continue
                            attrs = attrs_memo.get(text)
                            if attrs is None:
                                attrs = attrs_memo[text] = parse_attrs(text)
                            if akey in attrs:
                                ov[i] = attrs[akey]
                    else:
                        segs.fill_column(columns[fid], ov, p.comp)
                        ov.update((i, d.get(p.comp) if d else None)
                                  for i, d in slow_dicts.items())
        return failed


class _PinnedAlloc:
    """``encode_blob``'s ``alloc`` hook: the framer writes straight into
    pinned host memory, so the H2D copy needs no staging copy."""

    def __init__(self) -> None:
        self.buf: Optional[torch.Tensor] = None
        self.lengths: Optional[torch.Tensor] = None

    def __call__(self, n: int, L: int):
        self.buf = torch.empty((n, L), dtype=torch.uint8, pin_memory=True)
        self.lengths = torch.empty(n, dtype=torch.int32, pin_memory=True)
        return self.buf.numpy(), self.lengths.numpy()


class _Batch:
    """One encoded batch on its way through the device: its lines, the
    framed buffer, the pinned host and device copies of it, and the stage
    seconds so far."""

    def __init__(self, lines, buf: np.ndarray, lengths: np.ndarray,
                 overflow: List[int], framer_name: str, encode_s: float,
                 alloc: Optional[_PinnedAlloc]):
        self.lines = lines
        self.buf, self.lengths, self.overflow = buf, lengths, overflow
        self.framer = framer_name
        self.stage: Dict[str, float] = {"encode": encode_s}
        self.host = None   # (buf, lengths) pinned tensors
        if (alloc is not None and alloc.buf is not None and buf.shape[0]
                and buf.ctypes.data == alloc.buf.data_ptr()):
            self.host = (alloc.buf[:buf.shape[0]], alloc.lengths[:buf.shape[0]])
        self.dbuf: Optional[torch.Tensor] = None
        self.dlen: Optional[torch.Tensor] = None
        self.h2d = None    # the two events around the H2D copy
        self._h2d_counted = False
        self.host_kill: Optional[np.ndarray] = None

    def add(self, key: str, seconds: float) -> None:
        self.stage[key] = self.stage.get(key, 0.0) + seconds

    def pinned(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.host is None:
            self.host = (torch.from_numpy(self.buf).pin_memory(),
                         torch.from_numpy(self.lengths).pin_memory())
        return self.host

    def count_h2d(self) -> None:
        """Add the finished H2D copy's seconds (once)."""
        if not self._h2d_counted:
            self.add("h2d", self.h2d[0].elapsed_time(self.h2d[1]) / 1e3)
            self._h2d_counted = True


class _Pending:
    """A dispatched batch: the slot count it ran at and, on the card, its
    events and the pinned buffer its D2H copy lands in (an aggregate's
    executor, spec and device partials)."""

    def __init__(self, batch: _Batch, emit_views: Optional[bool], slots: int):
        self.batch, self.emit_views, self.slots = batch, emit_views, slots
        self.events: Optional[List[Any]] = None
        self.host_out: Optional[torch.Tensor] = None
        self.packed: Optional[np.ndarray] = None
        self.spec = self.executor = self.out = None


class _BlobLines:
    """Lazy per-line view of a newline-delimited blob: ``parse_blob``
    never builds a line list; a line materializes as bytes only when
    indexed (an aggregate's fold rows).  Framing is ``encode_blob``'s: a
    final empty segment after a trailing newline is dropped and one
    trailing ``\\r`` per line is stripped."""

    __slots__ = ("_blob", "_n", "_starts", "_ends")

    def __init__(self, blob: bytes):
        self._blob = blob
        self._n = _count_lines(blob)
        self._starts: Optional[np.ndarray] = None
        self._ends: Optional[np.ndarray] = None

    def _index(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._starts is None:
            arr = np.frombuffer(self._blob, dtype=np.uint8)
            nl = np.flatnonzero(arr == 0x0A)
            starts = np.concatenate([[0], nl + 1]).astype(np.int64)
            ends = np.concatenate([nl, [len(arr)]]).astype(np.int64)
            if len(arr) and arr[-1] == 0x0A:
                starts, ends = starts[:-1], ends[:-1]
            cr = (arr[np.maximum(ends - 1, 0)] == 0x0D) & (ends > starts)
            self._starts, self._ends = starts, ends - cr
        return self._starts, self._ends

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        starts, ends = self._index()
        return self._blob[starts[i]:ends[i]]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class _SliceLines:
    """Row-window view of a lines sequence (a list or a _BlobLines): rows
    materialize through the parent only when indexed."""

    __slots__ = ("_parent", "_start", "_n")

    def __init__(self, parent, start: int, n: int):
        self._parent, self._start, self._n = parent, start, n

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self._n))]
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        return self._parent[self._start + i]

    def __iter__(self):
        for i in range(self._n):
            yield self[i]


def _fix_uri_part(value: str, mode: str) -> str:
    """Per-row URI repair of a device ``fix`` span: the host's encode step
    and %-repair (twice, like the host), then for a path or userinfo the
    java.net.URI percent-decode."""
    value = _encode_bad_uri_chars(value)
    value = _BAD_ESCAPE_PATTERN.sub(r"%25\1", value)
    value = _BAD_ESCAPE_PATTERN.sub(r"%25\1", value)
    if mode in ("path", "userinfo"):
        value = _percent_decode(value)
    return value


def _raw_line_bytes(line) -> bytes:
    """One line as ingested bytes (strings UTF-8, surrogates escaped)."""
    if isinstance(line, bytes):
        return line
    if isinstance(line, (bytearray, memoryview)):
        return bytes(line)
    return str(line).encode("utf-8", errors="surrogateescape")


def _sres_value(attr, text: Optional[str]) -> Optional[str]:
    """ScreenResolutionDissector on one value: the part before / after the
    separator; None (nothing delivered) without one."""
    _, sep, part = attr
    if text and sep in text:
        parts = text.split(sep)
        return parts[0] if part == "width" else parts[1]
    return None


def _apply_setter_casts(value, has_long: bool, has_double: bool):
    """The record setter's dispatch: LONG, then DOUBLE, then the value as
    it is."""
    if has_long:
        try:
            return int(value)
        except (TypeError, ValueError):
            pass
    if has_double:
        try:
            return float(value)
        except (TypeError, ValueError):
            pass
    return value


class _CollectingRecord:
    """The oracle's record: every delivered value by field id."""

    def __init__(self) -> None:
        self.values: Dict[str, Any] = {}

    def set_value(self, name: str, value) -> None:
        self.values[name] = value


# Octet -> its decimal text, for dotted quads.
_OCTETS = np.array([str(i) for i in range(256)], dtype=object)

# Hex digit -> value (255 = not a hex digit).
_HEX_VAL = np.full(256, 255, dtype=np.uint8)
for _c in b"0123456789":
    _HEX_VAL[_c] = _c - ord("0")
for _c in b"abcdef":
    _HEX_VAL[_c] = _c - ord("a") + 10
for _c in b"ABCDEF":
    _HEX_VAL[_c] = _c - ord("A") + 10
del _c


def _qs_value_decode(bts: np.ndarray, off: np.ndarray):
    """'+' / percent decode of n concatenated value segments (``off`` the
    [n+1] offsets): '+' -> 0x20, '%' + two same-segment hex digits -> the
    byte, anything else verbatim.  Returns (decoded bytes, offsets)."""
    n = len(off) - 1
    total = int(off[-1])
    if total == 0:
        return np.zeros(0, dtype=np.uint8), np.zeros(n + 1, dtype=np.int64)
    lens = np.diff(off)
    seg_id = np.repeat(np.arange(n, dtype=np.int64), lens)
    seg_end = np.repeat(off[1:], lens)
    pos = np.arange(total, dtype=np.int64)
    hexv = _HEX_VAL[bts]
    is_hex = hexv < 16
    i1 = np.minimum(pos + 1, total - 1)
    i2 = np.minimum(pos + 2, total - 1)
    start = (bts == 0x25) & (pos + 2 < seg_end) & is_hex[i1] & is_hex[i2]
    consumed = np.zeros(total, dtype=bool)
    consumed[1:] |= start[:-1]
    consumed[2:] |= start[:-2]
    out = np.where(bts == 0x2B, np.uint8(0x20), bts)
    out = np.where(start, (hexv[i1].astype(np.uint8) << 4) | hexv[i2], out).astype(np.uint8)
    keep = ~consumed
    new_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(seg_id[keep], minlength=n), out=new_off[1:])
    return out[keep], new_off


class _QuerySegments:
    """The emitted segments of rows whose names need no repair, in row
    and slot order: their row, value span, decode flag, lower-cased name
    and value ('+' / %XX-decoded as latin-1 when flagged, else the raw
    bytes as UTF-8)."""

    def __init__(self, buf, rows, emit, SS, NL, VS, VL, DC):
        self.rows = rows
        pr, pk = np.nonzero(emit.T)
        sub = (pk, pr)
        self.seg_row, self.vs, self.vl, self.dec = rows[pr], VS[sub], VL[sub], DC[sub]
        ss, nl = SS[sub], NL[sub]
        self.names = [bytes(buf[r, s:s + n]).decode("utf-8", "replace").lower()
                      for r, s, n in zip(self.seg_row.tolist(), ss.tolist(), nl.tolist())]
        self.values = [bytes(buf[r, v:v + n]).decode("utf-8", "replace")
                       for r, v, n in zip(self.seg_row.tolist(), self.vs.tolist(),
                                          self.vl.tolist())]
        idx = np.nonzero(self.dec)[0]
        if idx.size:
            lens = self.vl[idx]
            off = np.zeros(idx.size + 1, dtype=np.int64)
            np.cumsum(lens, out=off[1:])
            flat = np.concatenate([buf[r, v:v + n] for r, v, n in
                                   zip(self.seg_row[idx], self.vs[idx], lens)])
            darr, d_off = _qs_value_decode(flat, off)
            for m, j in enumerate(idx.tolist()):
                self.values[j] = bytes(darr[d_off[m]:d_off[m + 1]]).decode("latin-1")
        self._dicts: Optional[Dict[int, Dict[str, str]]] = None

    def dicts(self) -> Dict[int, Dict[str, str]]:
        """{row: {name: value}}; a later segment of the same name wins."""
        if self._dicts is None:
            self._dicts = {int(i): {} for i in self.rows.tolist()}
            for r, name, value in zip(self.seg_row.tolist(), self.names, self.values):
                self._dicts[r][name] = value
        return self._dicts

    def last_values(self, comp: str) -> Dict[int, str]:
        """{row: value of the row's last segment named ``comp``}."""
        return {r: v for r, n, v in zip(self.seg_row.tolist(), self.names, self.values)
                if n == comp}

    def fill_column(self, col, ov, comp: str) -> None:
        """A concrete key: the span of the last segment of that name, None
        where there is none; a decoded value goes to the overrides."""
        col["ok"][self.rows] = True
        col["null"][self.rows] = True
        m = np.array([j for j, n in enumerate(self.names) if n == comp], dtype=np.int64)
        if m.size == 0:
            return
        mr = self.seg_row[m]
        col["starts"][mr] = self.vs[m]
        col["ends"][mr] = self.vs[m] + self.vl[m]
        col["null"][mr] = False
        last = np.ones(m.size, dtype=bool)
        last[:-1] = mr[:-1] != mr[1:]
        for j in m[last & self.dec[m]].tolist():
            ov[int(self.seg_row[j])] = self.values[j]


def _csr_dict_slow(line, mode, uri_chain, NL, HE, SS, VS, VL, DC, ND
                   ) -> Optional[Dict[str, str]]:
    """One row's segments the reference's per-row way: a Set-Cookie
    cookie's name trimmed and lower-cased, its whole text the value; else
    a flagged URI query name repaired, a cookie's name and value trimmed,
    a flagged value (repaired first on a URI query) resilientUrlDecode'd
    -- None when that raises: the host fails the line."""
    d: Dict[str, str] = {}
    for k in range(len(NL)):
        nlen, has_eq = int(NL[k]), bool(HE[k])
        if mode == "setcookie":
            s0 = int(SS[k])
            name = bytes(line[s0:s0 + nlen]).decode("utf-8", "replace").strip().lower()
            if has_eq and name:
                v0 = int(VS[k])
                d[name] = bytes(line[v0:v0 + int(VL[k])]).decode("utf-8", "replace")
            continue
        if nlen == 0 and not has_eq:
            continue
        s0 = int(SS[k])
        name = bytes(line[s0:s0 + nlen]).decode("utf-8", "replace")
        if uri_chain and ND[k]:
            name = _fix_uri_part(name, "")
        if mode == "cookie":
            name = name.strip()
        name = name.lower()
        if name == "":
            continue
        if not has_eq:
            d[name] = ""
            continue
        v0 = int(VS[k])
        value = bytes(line[v0:v0 + int(VL[k])]).decode("utf-8", "replace")
        if mode == "cookie":
            value = value.strip()
        if DC[k]:
            try:
                value = resilient_url_decode(_fix_uri_part(value, "") if uri_chain
                                             else value)
            except ValueError:
                return None
        d[name] = value
    return d


def _log_formats(log_format: str) -> List[Union[ApacheLogFormat, NginxLogFormat]]:
    """One format per non-blank, first-seen line: Apache when it looks
    like one (any ``%`` or a named format), else NGINX when it holds a
    ``$``; a line that is neither is skipped, as the reference does."""
    seen: List[str] = []
    formats: List[Union[ApacheLogFormat, NginxLogFormat]] = []
    for fmt in log_format.splitlines():
        if not fmt.strip() or fmt in seen:
            continue
        seen.append(fmt)
        if looks_like_apache_format(fmt):
            formats.append(ApacheLogFormat(fmt))
        elif looks_like_nginx_format(fmt):
            formats.append(NginxLogFormat(fmt))
    return formats


def _consumer_table(nginx: bool, extra_dissectors: Sequence[Any]):
    """Input type -> [(consumer, outputs, dissector or None)]: the fixed
    edges, an NGINX format's additional dissectors, and the extra
    dissectors, one per (input type, class) in registration order as in
    the reference's consumer registry."""
    table: Dict[str, list] = {t: [(c, outs, None) for c, outs in edges]
                              for t, edges in _CONSUMERS.items()}
    if nginx:
        for t, edges in additional_consumers().items():
            table.setdefault(t, []).extend(edges)
    seen = set()
    for d in extra_dissectors:
        key = (d.get_input_type(), type(d))
        if key in seen:
            continue
        seen.add(key)
        outputs = [tuple(o.split(":", 1)) for o in d.get_possible_output()]
        consumer = "geo" if isinstance(d, AbstractGeoIPDissector) else "extra"
        table.setdefault(d.get_input_type(), []).append((consumer, outputs, d))
    return table


def _plan_group(plan: FieldPlan) -> str:
    """Merge group: plans in the same group share column arrays."""
    if plan.kind in ("span", "ulist"):
        return "span"
    if plan.kind == "muid":
        return "obj" if plan.comp == "ip" else "numeric"
    if plan.kind in ("long", "secmillis"):
        return "numeric"
    if plan.kind == "ts":
        return "numeric" if timefields.is_numeric_output(plan.comp) else "obj"
    if plan.kind == "geo":
        return "obj"
    if plan.kind == "qscsr":
        return "wild"
    return "host"


def _empty_column(group: str, B: int) -> Dict[str, Any]:
    """A column's arrays before any unit fills them (a "host" column is
    never filled: every value is an oracle override)."""
    if group in ("span", "wild", "host"):
        col = {"kind": "span", "starts": np.zeros(B, dtype=np.int32),
               "ends": np.zeros(B, dtype=np.int32),
               "ok": np.zeros(B, dtype=bool), "null": np.zeros(B, dtype=bool)}
        if group == "span":
            col.update(amp=np.zeros(B, dtype=bool), fix=np.zeros(B, dtype=bool))
        return col
    if group == "obj":
        return {"kind": "obj", "values": np.full(B, None, dtype=object),
                "ok": np.zeros(B, dtype=bool)}
    return {"kind": "numeric", "values": np.zeros(B, dtype=np.int64),
            "null": np.zeros(B, dtype=bool), "null_zero": np.zeros(B, dtype=bool),
            "ok": np.zeros(B, dtype=bool)}


class BatchResult:
    """Columnar parse result over one batch.

    ``valid[i]`` is the line's verdict, the host oracle's on the rows it
    visited; ``needs_host`` (the reference's ``oracle_row_ids``) lists the
    rows the oracle visited -- lines the device could not accept but some
    format could still match, truncated lines, and lines won by a format
    that cannot supply every requested field -- and their values are the
    oracle's; ``format_index[i]`` is the winning format (-1 = none).
    ``reject_reasons`` maps every invalid row to "implausible",
    "oracle_reject" or "oracle_error"; ``rescue_reasons`` counts the
    visited rows by why they left the device ("overflow",
    "device_reject", "host_fields"); ``rescue_wall_s`` is the oracle's
    wall time."""

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
        self.good_lines = int(np.count_nonzero(valid))
        self.bad_lines = self.lines_read - self.good_lines
        self.reject_reasons: Dict[int, str] = {}
        self.rescue_reasons: Dict[str, int] = {}
        self.rescue_wall_s = 0.0
        self.stage_seconds: Dict[str, float] = {}
        self.d2h_bytes = 0
        self.csr_regrows = 0
        self.framer: Optional[str] = None   # "native" or "numpy"

    @property
    def oracle_row_ids(self) -> np.ndarray:
        """The reference's name for ``needs_host``."""
        return self.needs_host

    @property
    def oracle_rows(self) -> int:
        """How many rows the oracle visited."""
        return len(self.needs_host)

    def raw_line(self, i: int) -> bytes:
        """The raw bytes of line ``i`` as ingested (strings UTF-8)."""
        return _raw_line_bytes(self._lines[i])

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
                if col.get("amp") is not None and col["amp"][i] and raw[:1] == b"?":
                    raw = b"&" + raw[1:]  # the ?& query normalization
                value = raw.decode("utf-8", errors="replace")
                if col.get("fix") is not None and col["fix"][i]:
                    value = _fix_uri_part(value, col["fix_mode"])
                out.append(value)
        return out

    def to_dict(self) -> Dict[str, List[Any]]:
        return {fid: self.to_pylist(fid) for fid in self._columns}

    def to_arrow(self, include_validity: bool = True, strings: str = "view"):
        """A pyarrow Table with the reference's column rules
        (``arrow_bridge.batch_to_arrow``): int64 numbers (null where the
        row is invalid, not ok, a CLF null, or outside int64), a
        ``map<string, string>`` per wildcard field, span columns as
        ``string`` (``strings="copy"``) or ``string_view``
        (``strings="view"``, built by copying: the zero-copy views over
        the batch buffer are a later slice), other columns typed from
        their values; with ``include_validity`` a last ``__valid__: bool``
        column."""
        import pyarrow as pa

        if strings not in ("view", "copy"):
            raise ValueError(f"strings must be 'view' or 'copy', not {strings!r}")
        arrays = {fid: self._arrow_column(pa, fid, col, strings)
                  for fid, col in self._columns.items()}
        if include_validity:
            arrays["__valid__"] = pa.array(np.asarray(self.valid, dtype=bool))
        return pa.table(arrays)

    def _arrow_column(self, pa, fid: str, col, strings: str):
        B = self.lines_read
        overrides = self._overrides.get(fid, {})
        if fid.endswith(".*"):
            return pa.array([None if v is None else list(v.items())
                             for v in self.to_pylist(fid)],
                            type=pa.map_(pa.string(), pa.string()))
        kind = col["kind"]
        if kind == "numeric" and not any(isinstance(v, (str, dict))
                                         for v in overrides.values()):
            values = col["values"][:B].astype(np.int64)
            null, null_zero = col["null"][:B], col["null_zero"][:B]
            values[null & null_zero] = 0
            mask = ~(self.valid[:B] & col["ok"][:B]) | (null & ~null_zero)
            for i, v in overrides.items():
                if v is None or not -2**63 <= v < 2**63:
                    mask[i] = True   # the reference's Long.parseLong null
                else:
                    values[i] = v
                    mask[i] = False
            return pa.array(values, mask=mask, type=pa.int64())
        values = self.to_pylist(fid)
        if kind == "obj":
            arr = pa.array(values, from_pandas=True)
            if not (pa.types.is_null(arr.type) or pa.types.is_boolean(arr.type)):
                return arr
        non_null = [v for v in values if v is not None]
        if kind == "span" and not overrides:
            arr = pa.array(values, type=pa.string())
        elif non_null and all(isinstance(v, int) and not isinstance(v, bool)
                              for v in non_null):
            return pa.array(values, type=pa.int64())
        elif non_null and all(isinstance(v, (int, float)) and not isinstance(v, bool)
                              for v in non_null):
            return pa.array([None if v is None else float(v) for v in values],
                            type=pa.float64())
        else:
            arr = pa.array([None if v is None else str(v) for v in values],
                           type=pa.string())
        if kind == "span" and strings == "view":
            arr = arr.cast(pa.string_view())
        return arr
