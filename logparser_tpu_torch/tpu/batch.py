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
    makes a one-device mesh of ``device``.  ``assembly_workers`` is the
    reference's keyword too: the width of the delivery path's host pool
    (``hostpool.AssemblyPool``; default min(8, cpu_count)), which fans
    ``to_arrow``'s columns out, budgets the native passes' threads and
    runs the host oracle beside the query-string columns; 1 is serial."""

    def __init__(self, log_format: str, fields: Sequence[str],
                 device: Union[str, torch.device, None] = None,
                 extra_dissectors: Optional[Sequence[Any]] = None,
                 type_remappings: Optional[Dict[str, Any]] = None,
                 data_parallel: Optional[int] = None,
                 assembly_workers: Optional[int] = None):
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchBatchParser: CUDA was asked for but is not available "
                "(pass device='cpu' to run the plain PyTorch versions)"
            )
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.data_parallel = data_parallel
        self.assembly_workers = assembly_workers
        self._assembly_pool = None
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

    def assembly_pool(self):
        """The delivery path's host worker pool (built at first use);
        every BatchResult carries it, so ``to_arrow`` keeps the width
        wherever the result goes."""
        if self._assembly_pool is None:
            from .hostpool import AssemblyPool

            self._assembly_pool = AssemblyPool(self.assembly_workers)
        return self._assembly_pool

    def close(self) -> None:
        """Release the host worker pool; results already made still
        deliver (their pool runs serially once closed)."""
        if self._assembly_pool is not None:
            self._assembly_pool.close()
        self._assembly_pool = None

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
                    # A non-geo fill: the bridge's dictionary / typed
                    # paths see only geo-written state.
                    col["mixed_fill"] = True
                    col["values"] = np.where(sel, values, col["values"])
                    col["ok"] = np.where(sel, ok, col["ok"])
                elif plan.kind == "muid":
                    key = muid_group_key(plan)
                    ok = get(key, "ok") != 0
                    row = {"epoch": "time", "ip": "ip", "processid": "pid",
                           "counter": "counter", "threadindex": "thread"}[plan.comp]
                    u32 = get(key, row).astype(np.int64) & 0xFFFFFFFF
                    col["mixed_fill"] = True   # see the ts branch
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
                        vocab = table.vocab_arrays[column]
                        values = vocab[arr]
                        # The vocabulary codes, for the bridge's
                        # dictionary.take(codes); a second vocabulary in
                        # one column (two databases) turns that path off.
                        if "dict_codes" not in col:
                            col["dict_codes"] = np.full(B, -1, dtype=np.int64)
                            col["dict_values"] = vocab
                        if col.get("dict_values") is vocab:
                            col["dict_codes"] = np.where(sel, arr.astype(np.int64),
                                                         col["dict_codes"])
                        else:
                            col["dict_values"] = None
                    else:   # float NaN / int -1: the miss
                        kind_ch = "f" if arr.dtype.kind == "f" else "i"
                        miss = np.isnan(arr) if kind_ch == "f" else arr < 0
                        values = arr.astype(object)
                        values[miss] = None
                        _geo_typed_fill(col, sel, arr.astype(
                            np.float64 if kind_ch == "f" else np.int64), miss, kind_ch)
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
        overrides: Dict[str, Any] = {
            fid: _LazyWildcard() if fid.endswith(".*") else {} for fid in columns}
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
        # The oracle's pass over those rows starts first: on a pool of more
        # than one worker it runs on a pool thread while the query-string
        # and cookie columns materialize.
        t_submit = time.perf_counter()
        rescue_rows = sorted(need_oracle)
        collect_rescue = self._start_rescue(rescue_rows, lines)
        rescue_wall = time.perf_counter() - t_submit
        # Query parameters; a value whose decode fails fails the line on
        # the host, so those rows go there (parsed after the pass above).
        extra_rows: List[int] = []
        for i in self._materialize_csr(packed, winner, valid, columns, overrides,
                                       buf, B):
            valid[i] = False
            winner[i] = -1
            for ov in overrides.values():
                ov.pop(i, None)
            invalid_rows.add(i)
            if i not in need_oracle:
                need_oracle.add(i)
                extra_rows.append(i)
        overflow_rows = {int(i) for i in overflow if 0 <= int(i) < B}
        rescue_reasons = {"overflow": 0, "device_reject": 0, "host_fields": 0}
        if need_oracle:
            rescue_reasons["overflow"] = len(overflow_rows & need_oracle)
            rescue_reasons["device_reject"] = len(invalid_rows - overflow_rows)
            rescue_reasons["host_fields"] = len(need_oracle - invalid_rows - overflow_rows)
        t_oracle = time.perf_counter()
        oracle_rows = sorted(need_oracle)
        by_row = dict(zip(rescue_rows, collect_rescue()))
        extra_rows.sort()
        by_row.update(zip(extra_rows, self._run_oracle_many([lines[i] for i in extra_rows])))
        plans: Dict[Tuple[bool, int], tuple] = {}
        for i in oracle_rows:
            values = by_row[i]
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
        rescue_wall += time.perf_counter() - t_oracle
        # The device's view rows (4 a span field, after the unit rows) go
        # to the Arrow bridge, which interleaves them into string_view
        # structs without reading the batch buffer; only that block is
        # kept (a contiguous copy).  Truncated rows are dirty: the device
        # judged a prefix, so their views are zeroed and patched.
        view_block = device_views = dirty_rows = None
        k0 = packed_row_count(self.units)
        n_views = VIEW_ROWS_PER_FIELD * len(self.view_specs)
        if packed is not None and n_views and packed.shape[0] >= k0 + n_views:
            view_block = packed[k0:k0 + n_views].copy()
            device_views = {fid: VIEW_ROWS_PER_FIELD * i
                            for i, (fid, _) in enumerate(self.view_specs)}
            dirty_rows = np.asarray([i for i in overflow if i < B], dtype=np.int64)
        result = BatchResult(lines, buf, lengths, valid, columns, overrides,
                             np.asarray(oracle_rows, dtype=np.int64), winner,
                             packed=view_block, device_views=device_views,
                             dirty_rows=dirty_rows, assembly_pool=self.assembly_pool())
        result.good_lines = B - bad
        result.bad_lines = bad
        result.reject_reasons = reject_reasons
        result.rescue_reasons = rescue_reasons
        result.rescue_wall_s = rescue_wall
        return result

    def _start_rescue(self, rows: List[int], lines):
        """Begin the oracle's pass over ``rows`` (sorted): a callable that
        returns its results in row order.  On a pool of more than one
        worker the pass runs on a pool thread, overlapping the caller's
        column materialization."""
        if not rows:
            return lambda: []
        batch_lines = [lines[i] for i in rows]
        pool = self.assembly_pool()
        if pool.workers > 1:
            fut = pool.submit(lambda: self._run_oracle_many(batch_lines))
            if fut is not None:
                return fut.result
        return lambda: self._run_oracle_many(batch_lines)

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
        packed segment tables (the reference's vectorized
        _materialize_csr), for the rows each unit claims.

        The emitted segments are flattened with numpy gathers into one
        name buffer and one value buffer; a concrete name fills its span
        column with the value of the last segment of that name (an
        override where that value was decoded); a ``.*`` field gets the
        flat buffers as a ``_LazyWildcard`` chunk; a Set-Cookie attribute
        or a remapped screen resolution parses the last matching value.
        Only rows whose segments need per-value Python take the per-row
        path (``_csr_dict_slow``): a URI query name that needs %-repair, a
        flagged value of a direct capture or a cookie that the
        left-to-right decode cannot prove, a cookie with a whitespace /
        non-ASCII byte at a name or value edge (the host trims), a
        Set-Cookie name with such an edge.  The other flagged values
        decode vectorized; where the reference takes a cookie's flagged
        values one by one, this gives the same strings.  Returns the rows
        whose value decode failed."""
        failed: set = set()
        if packed is None:
            return failed
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
                self._csr_group(u, block, key, flist, rows, buf, flat_buf, L, B,
                                columns, overrides, failed)
        return failed

    def _csr_group(self, u, block, key, flist, rows, buf, flat_buf, L, B,
                   columns, overrides, failed) -> None:
        """One segment table (one query string, cookie or Set-Cookie
        header of a unit) over the unit's ``rows``.  Only the emitted
        segments are decoded, one entry each; a row on the per-row path
        decodes its own slots."""
        mode = flist[0][1].meta
        uri_chain = bool(flist[0][1].steps)
        cookie, setcookie = mode == "cookie", mode == "setcookie"
        slots = u.layout.slots[key]
        K = u.layout.csr_slots
        # Each slot packs into two rows (start, nlen, eq, dec, ndec in the
        # "start" word; vstart, vlen in the "vstart" word): gather both
        # [K, rows] word blocks once.
        words = [block[[slots[f"s{k}_{part}"][0] for k in range(K)]][:, rows]
                 for part in ("start", "vstart")]

        def field(comp, w):
            _, shift, bits = slots[f"s0_{comp}"]
            return (w >> shift) & ((1 << bits) - 1)

        ok = u.layout.get(block, key, "ok")[:B][rows] != 0
        # A segment is emitted iff its name is non-empty (an empty slot
        # packs nlen 0; "=value" matches nothing); a Set-Cookie cookie
        # also needs its '='.
        emit = (field("nlen", words[0]) > 0) & ok[None, :]
        if setcookie:
            emit &= field("eq", words[0]) != 0
        # The emitted segments in row and slot order: their row position,
        # row, spans and flags.
        pr, pk = np.nonzero(emit.T)
        w0, w1 = words[0][pk, pr], words[1][pk, pr]
        s_row = rows[pr]
        s_ss = field("start", w0).astype(np.int64)
        s_nl = field("nlen", w0).astype(np.int64)
        s_vs = field("vstart", w1).astype(np.int64)
        s_vl = field("vlen", w1).astype(np.int64)
        s_he = field("eq", w0) != 0
        s_dc = field("dec", w0) != 0

        def edge(S, N):
            # A byte <= 0x20 or >= 0x80 at either end of a span.
            a = s_row * L + S
            first = flat_buf[np.where(N > 0, a, 0)]
            last = flat_buf[np.where(N > 0, a + N - 1, 0)]
            return (N > 0) & ((first <= 0x20) | (first >= 0x80)
                              | (last <= 0x20) | (last >= 0x80))

        def hard(sel):
            # Flagged values the vectorized decode cannot prove
            # (_qs_value_decode's ``bad``).
            out = np.zeros(pr.size, dtype=bool)
            idx = np.nonzero(sel)[0]
            if idx.size:
                seg, f_off = _flat_segments(flat_buf, L, s_row[idx], s_vs[idx],
                                            np.where(s_he[idx], s_vl[idx], 0))
                out[idx[_qs_value_decode(seg, f_off)[2]]] = True
            return out

        if setcookie:
            flag = edge(s_ss, s_nl)
        elif cookie:
            # The host trims a cookie's name and value before it decodes
            # the value: a span with a trimmable edge takes the per-row path.
            flag = edge(s_ss, s_nl) | edge(s_vs, s_vl) | hard(s_dc)
        elif uri_chain:
            # Names that need %-repair take the per-row path; flagged
            # values decode below (a device-valid URI query is clean ASCII,
            # so the left-to-right rule is exact).
            flag = field("ndec", w0) != 0
        else:
            flag = hard(s_dc)
        row_flag = np.zeros(rows.size, dtype=bool)
        row_flag[pr[flag]] = True
        vrows, py_rows = rows[~row_flag], rows[row_flag]
        need_dicts = any(p.comp == "*" for _, p in flist)

        # ---- the flat path: the fast rows' segments.
        fast = ~row_flag[pr]
        n_seg = int(np.count_nonzero(fast))
        s_row, s_ss, s_nl, s_vs, s_dc = (a[fast] for a in (s_row, s_ss, s_nl, s_vs, s_dc))
        s_vl = np.where(s_he[fast] | setcookie, s_vl[fast], 0)
        nb_np, non = _flat_segments(flat_buf, L, s_row, s_ss, s_nl)
        seg_high = np.zeros(n_seg, dtype=bool)
        if nb_np.size:   # every emitted name is non-empty
            seg_high = np.add.reduceat((nb_np >= 0x80).astype(np.int64), non[:-1]) > 0
        vb_np, nov = (_flat_segments(flat_buf, L, s_row, s_vs, s_vl) if need_dicts
                      else (np.zeros(0, dtype=np.uint8), np.zeros(1, dtype=np.int64)))

        # Flagged values of a query string ('%', '+', encode-set bytes) or a
        # cookie decode here, the exact (repair +) resilientUrlDecode result
        # for the segments proven above.
        dec_pos = np.full(n_seg, -1, dtype=np.int64)
        darr, d_off = np.zeros(0, dtype=np.uint8), np.zeros(1, dtype=np.int64)
        if n_seg and not setcookie:
            dec_idx = np.nonzero(s_dc)[0]
            if dec_idx.size:
                dec_pos[dec_idx] = np.arange(dec_idx.size)
                seg, f_off = _flat_segments(flat_buf, L, s_row[dec_idx], s_vs[dec_idx],
                                            s_vl[dec_idx])
                darr, d_off, _ = _qs_value_decode(seg, f_off)
                if need_dicts:
                    # The decoded bytes (as UTF-8) replace the raw spans in
                    # the flat value buffer.
                    uarr, u_off = _latin1_to_utf8(darr, d_off)
                    lens = np.diff(nov)
                    lens2 = lens.copy()
                    lens2[dec_idx] = np.diff(u_off)
                    nov2 = np.zeros_like(nov)
                    np.cumsum(lens2, out=nov2[1:])
                    new_vb = np.empty(int(nov2[-1]), dtype=np.uint8)
                    keep_i = np.nonzero(~s_dc)[0]
                    _seg_scatter(new_vb, nov2[keep_i], vb_np, nov[keep_i], lens[keep_i])
                    _seg_scatter(new_vb, nov2[dec_idx], uarr, u_off[:-1], lens2[dec_idx])
                    vb_np, nov = new_vb, nov2
        nb = nb_np.tobytes()

        def decoded(j: int) -> str:
            jj = int(dec_pos[j])
            return bytes(darr[d_off[jj]:d_off[jj + 1]]).decode("latin-1")

        def match_comp(comp: str) -> np.ndarray:
            # The segments named ``comp``, a byte-wise match with ASCII case
            # fold; a name with a byte >= 0x80 decodes one by one (its
            # lower() can change the UTF-8 length).
            comp_b = comp.encode("utf-8")
            if n_seg == 0 or not comp_b:
                return np.empty(0, dtype=np.int64)
            out = np.nonzero((s_nl == len(comp_b)) & ~seg_high)[0]
            if out.size:
                g = flat_buf[(s_row * L + s_ss)[out][:, None] + np.arange(len(comp_b))]
                folded = np.where((g >= 0x41) & (g <= 0x5A), g | 0x20, g)
                out = out[(folded == np.frombuffer(comp_b, dtype=np.uint8)).all(axis=1)]
            extra = [j for j in np.nonzero(seg_high)[0].tolist()
                     if nb[non[j]:non[j + 1]].decode("utf-8", "replace").lower() == comp]
            if extra:
                out = np.sort(np.concatenate([out, np.asarray(extra, dtype=np.int64)]))
            return out

        def last_texts(m):
            # (row, text) of the last matched segment of each row: the host
            # dissects only the last of same-name segments.
            last: Dict[int, int] = {}
            for j in m.tolist():
                last[int(s_row[j])] = j
            for row, j in last.items():
                if dec_pos[j] >= 0:
                    yield row, decoded(j)
                else:
                    v0 = int(s_vs[j])
                    yield row, bytes(buf[row, v0:v0 + int(s_vl[j])]).decode("utf-8",
                                                                           "replace")

        matches: Dict[str, np.ndarray] = {}
        attrs_memo: Dict[str, dict] = {}
        for fid, p in flist:
            if p.comp == "*":
                continue
            m = matches.get(p.comp)
            if m is None:
                m = matches[p.comp] = match_comp(p.comp)
            ov = overrides[fid]
            if isinstance(p.attr, tuple):
                # A remapped screen resolution: the value split on the
                # separator.
                for row, text in last_texts(m):
                    value = _sres_value(p.attr, text)
                    if value is not None:
                        ov[row] = _apply_setter_casts(
                            value, *self._cast_flags.get(fid, (False, False)))
                continue
            if p.attr:
                akey = _setcookie_attr_key(fid, p.attr)
                for row, text in last_texts(m):
                    attrs = attrs_memo.get(text)
                    if attrs is None:
                        attrs = attrs_memo[text] = parse_attrs(text)
                    if akey in attrs:
                        ov[row] = attrs[akey]
                continue
            # A concrete name: span column writes (numpy's fancy assignment
            # keeps the last segment of a row, the host's overwrite order).
            col = columns[fid]
            col["ok"][vrows] = True
            col["null"][vrows] = True
            if m.size:
                mr = s_row[m]
                col["starts"][mr] = s_vs[m]
                col["ends"][mr] = s_vs[m] + s_vl[m]
                col["null"][mr] = False
                # A row whose last match was decoded delivers the decoded
                # value as an override (a span points at raw bytes).
                last = np.ones(m.size, dtype=bool)
                last[:-1] = mr[:-1] != mr[1:]
                for j in m[last & (dec_pos[m] >= 0)].tolist():
                    ov[int(s_row[j])] = decoded(j)

        def row_slots(j):
            # Row position j's K slots: (NL, HE, SS, VS, VL, DC, ND).
            a, v = words[0][:, j], words[1][:, j]
            return (field("nlen", a), field("eq", a) != 0, field("start", a),
                    field("vstart", v), field("vlen", v), field("dec", a) != 0,
                    field("ndec", a) != 0)

        dicts = self._csr_slow_rows(py_rows, rows, row_slots, mode, uri_chain, buf, flist,
                                    overrides, attrs_memo, failed)
        if need_dicts:
            for fid, p in flist:
                if p.comp != "*":
                    continue
                tgt = overrides[fid]
                if vrows.size:
                    tgt.add_chunk(vrows, s_row, nb, non, vb_np.tobytes(), nov, seg_high)
                tgt.eager.update(dicts)

    def _csr_slow_rows(self, py_rows, rows, row_slots, mode, uri_chain, buf, flist,
                       overrides, attrs_memo, failed) -> Dict[int, dict]:
        """The per-row path of one segment table: each row's dict the
        reference's per-value way (``_csr_dict_slow``), its concrete and
        attribute fields delivered as overrides; a row whose value decode
        fails joins ``failed``.  Returns {row: dict} of the rows that did
        not fail."""
        dicts: Dict[int, dict] = {}
        pos_of = {int(r): j for j, r in enumerate(rows.tolist())}
        for i in py_rows.tolist():
            d = _csr_dict_slow(buf[i], mode, uri_chain, *row_slots(pos_of[i]))
            if d is None:
                failed.add(i)
            else:
                dicts[i] = d
            for fid, p in flist:
                if p.comp == "*":
                    continue
                ov = overrides[fid]
                text = d.get(p.comp) if d else None
                if isinstance(p.attr, tuple):
                    value = _sres_value(p.attr, text)
                    if value is not None:
                        ov[i] = _apply_setter_casts(
                            value, *self._cast_flags.get(fid, (False, False)))
                elif p.attr:
                    if text:
                        attrs = attrs_memo.get(text)
                        if attrs is None:
                            attrs = attrs_memo[text] = parse_attrs(text)
                        akey = _setcookie_attr_key(fid, p.attr)
                        if akey in attrs:
                            ov[i] = attrs[akey]
                else:
                    ov[i] = text
        return dicts


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


def _setcookie_attr_key(fid: str, attr: str) -> str:
    """The ``parse_attrs`` key of a requested Set-Cookie attribute: the
    TIME.EPOCH twin of ``expires`` reads the epoch, any other its name."""
    if attr == "expires" and fid.startswith("TIME.EPOCH:"):
        return "expires_epoch"
    return attr


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
    byte, anything else verbatim -- the left-to-right rule of repair, then
    URL-decode, on a query value.  Returns (decoded bytes, offsets, bad):
    ``bad[k]`` marks a segment the rule does not cover for a direct token
    capture, a '%' without two in-segment hex digits (the host's decoder
    may chop it, raise, or read a %uXXXX escape) or a raw byte >= 0x80."""
    n = len(off) - 1
    total = int(off[-1])
    if total == 0:
        return (np.zeros(0, dtype=np.uint8), np.zeros(n + 1, dtype=np.int64),
                np.zeros(n, dtype=bool))
    lens = np.diff(off)
    seg_id = np.repeat(np.arange(n, dtype=np.int64), lens)
    seg_end = np.repeat(off[1:], lens)
    pos = np.arange(total, dtype=np.int64)
    hexv = _HEX_VAL[bts]
    is_hex = hexv < 16
    is_pct = bts == 0x25
    i1 = np.minimum(pos + 1, total - 1)
    i2 = np.minimum(pos + 2, total - 1)
    start = is_pct & (pos + 2 < seg_end) & is_hex[i1] & is_hex[i2]
    consumed = np.zeros(total, dtype=bool)
    consumed[1:] |= start[:-1]
    consumed[2:] |= start[:-2]
    out = np.where(bts == 0x2B, np.uint8(0x20), bts)
    out = np.where(start, (hexv[i1].astype(np.uint8) << 4) | hexv[i2], out).astype(np.uint8)
    bad_b = (is_pct & ~start) | (bts >= 0x80)
    bad = np.zeros(n, dtype=bool)
    if bad_b.any():
        bad = np.bincount(seg_id[bad_b], minlength=n) > 0
    keep = ~consumed
    new_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(seg_id[keep], minlength=n), out=new_off[1:])
    return out[keep], new_off, bad


def _latin1_to_utf8(bts: np.ndarray, off: np.ndarray):
    """Decoded (latin-1) segment bytes as UTF-8, so that they ride the
    wildcard's flat value buffer (read as UTF-8): a byte < 0x80 passes,
    a byte >= 0x80 becomes the two-byte form of U+0080..U+00FF."""
    hi = bts >= 0x80
    if not hi.any():
        return bts, off
    n = len(off) - 1
    lens = np.diff(off)
    seg_id = np.repeat(np.arange(n, dtype=np.int64), lens)
    width = 1 + hi.astype(np.int64)
    dst = np.cumsum(width) - width
    out = np.empty(int(dst[-1] + width[-1]) if len(dst) else 0, dtype=np.uint8)
    out[dst] = np.where(hi, 0xC0 | (bts >> 6), bts)
    out[dst[hi] + 1] = 0x80 | (bts[hi] & 0x3F)
    extra = np.bincount(seg_id[hi], minlength=n)
    new_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens + extra, out=new_off[1:])
    return out, new_off


def _seg_scatter(dst, dst_off, src, src_off, lens) -> None:
    """Copy n segments ``src[src_off[k]:+lens[k]]`` to
    ``dst[dst_off[k]:+lens[k]]`` with one gather / scatter pair."""
    total = int(lens.sum())
    if total == 0:
        return
    cum = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=cum[1:])
    ar = np.arange(total, dtype=np.int64)
    dst[np.repeat(dst_off - cum[:-1], lens) + ar] = src[np.repeat(src_off - cum[:-1], lens) + ar]


def _flat_segments(flat_buf, L, rows, starts, lens):
    """n segments ``buf[rows[k], starts[k]:+lens[k]]`` of a [B, L] buffer
    as (bytes, offsets [n+1])."""
    off = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    idx = np.repeat(rows * L + starts - off[:-1], lens) + np.arange(int(off[-1]),
                                                                     dtype=np.int64)
    return flat_buf[idx], off


def _dedup_names(seg_row, folded, nb_off, vb, vb_off):
    """A row's segments as its dict holds them: a name seen twice keeps
    the place of its first segment and the value of its last (``d[name] =
    value`` in segment order).  Segments are grouped by row and a
    signature of the folded name (length, byte sum, first and last byte),
    and every group's members are checked byte for byte; a false
    collision returns None (the dict path decides).  Returns (seg_row,
    folded, values, name_lens, val_lens), the arrays unchanged where no
    name repeats."""
    n = len(seg_row)
    name_lens, val_lens = np.diff(nb_off), np.diff(vb_off)
    sums = np.add.reduceat(folded.astype(np.int64), nb_off[:-1])
    sig = ((name_lens << 40) | (sums << 16) | (folded[nb_off[:-1]].astype(np.int64) << 8)
           | folded[nb_off[1:] - 1])
    order = np.lexsort((sig, seg_row))   # stable: by row, signature, position
    same = (seg_row[order][1:] == seg_row[order][:-1]) & (sig[order][1:] == sig[order][:-1])
    if not same.any():
        return seg_row, folded, vb, name_lens, val_lens
    first = np.ones(n, dtype=bool)
    first[1:] = ~same
    last = np.ones(n, dtype=bool)
    last[:-1] = ~same
    # Every member's bytes equal its group's first member's.
    lead = order[np.maximum.accumulate(np.where(first, np.arange(n), 0))]
    members, leads = order[~first], lead[~first]
    ml = name_lens[members]
    if ml.sum():
        ramp = np.arange(int(ml.sum()), dtype=np.int64) - np.repeat(np.cumsum(ml) - ml, ml)
        if not np.array_equal(folded[np.repeat(nb_off[members], ml) + ramp],
                              folded[np.repeat(nb_off[leads], ml) + ramp]):
            return None
    value_of = np.empty(n, dtype=np.int64)
    value_of[order[first]] = order[last]
    kept = np.sort(order[first])
    src = value_of[kept]
    name_lens_k, val_lens_k = name_lens[kept], val_lens[src]

    def gather(data, off, rows, lens):
        total = int(lens.sum())
        ramp = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(lens) - lens, lens)
        return data[np.repeat(off[rows], lens) + ramp]

    return (seg_row[kept], gather(folded, nb_off, kept, name_lens_k),
            gather(vb, vb_off, src, val_lens_k), name_lens_k, val_lens_k)


class _LazyWildcard:
    """The overrides of a wildcard (``.*``) field.

    The flat segment buffers of each unit's fast rows are kept as they are
    (``chunks``: the rows, each segment's row, and the name and value
    bytes with their offsets); the per-row dicts of ``to_pylist`` are built
    at the first dict-style access, and ``to_arrow_map`` builds the Arrow
    map column straight from the buffers.  ``eager`` holds dicts delivered
    one by one (slow rows, the oracle's) and wins over chunk data for its
    row; ``dropped`` holds the rows popped since (a row failed by another
    group of the line), which shadow chunk data too."""

    __slots__ = ("eager", "chunks", "_dense", "dropped")

    def __init__(self) -> None:
        self.eager: Dict[int, Any] = {}
        # (vrows, seg_row, name_bytes, name_off, val_bytes, val_off, high)
        self.chunks: List[tuple] = []
        self._dense: Optional[Dict[int, Any]] = None
        self.dropped: set = set()

    def add_chunk(self, vrows, seg_row, nb, non, vb, nov, seg_high) -> None:
        self.chunks.append((vrows, seg_row, nb, non, vb, nov, seg_high))
        self._dense = None

    def _materialize(self) -> Dict[int, Any]:
        if self._dense is None:
            dense: Dict[int, Any] = {}
            for vrows, seg_row, nb, non, vb, nov, _hi in self.chunks:
                for r in vrows.tolist():
                    dense[r] = {}
                rl = seg_row.tolist()
                for j in range(len(rl)):
                    name = nb[non[j]:non[j + 1]].decode("utf-8", "replace").lower()
                    dense[rl[j]][name] = vb[nov[j]:nov[j + 1]].decode("utf-8", "replace")
            dense.update(self.eager)
            for i in self.dropped:
                dense.pop(i, None)
            self._dense = dense
        return self._dense

    def __contains__(self, i) -> bool:
        return i in self._materialize()

    def __getitem__(self, i):
        return self._materialize()[i]

    def __setitem__(self, i, value) -> None:
        self.eager[i] = value
        self.dropped.discard(i)
        if self._dense is not None:
            self._dense[i] = value

    def pop(self, i, default=None):
        self.dropped.add(i)
        if self._dense is not None:
            self._dense.pop(i, None)
        return self.eager.pop(i, default)

    def __bool__(self) -> bool:
        return (bool(self.eager) or any(len(c[0]) for c in self.chunks)
                or bool(self._dense))

    def sliced(self, start: int, stop: int) -> "_LazyWildcard":
        """The rows [start, stop) rebased to 0 (``BatchResult.slice``): eager
        rows and tombstones rebase, each chunk keeps the window's segments
        with its byte runs re-packed -- the one-chunk layout a solo parse
        of those rows builds, so ``to_arrow_map`` stays taken."""
        out = _LazyWildcard()
        out.eager = {i - start: v for i, v in self.eager.items() if start <= i < stop}
        out.dropped = {i - start for i in self.dropped if start <= i < stop}
        for vrows, seg_row, nb, non, vb, nov, seg_high in self.chunks:
            vrows = np.asarray(vrows, dtype=np.int64)
            seg_row = np.asarray(seg_row, dtype=np.int64)
            vsel = (vrows >= start) & (vrows < stop)
            ssel = (seg_row >= start) & (seg_row < stop)
            if not vsel.any() and not ssel.any():
                continue
            name_lens = np.diff(np.asarray(non, dtype=np.int64))
            val_lens = np.diff(np.asarray(nov, dtype=np.int64))
            nb_np = np.frombuffer(nb, dtype=np.uint8)
            vb_np = np.frombuffer(vb, dtype=np.uint8)
            new_non = np.zeros(int(ssel.sum()) + 1, dtype=np.int64)
            np.cumsum(name_lens[ssel], out=new_non[1:])
            new_nov = np.zeros(int(ssel.sum()) + 1, dtype=np.int64)
            np.cumsum(val_lens[ssel], out=new_nov[1:])
            out.add_chunk(vrows[vsel] - start, seg_row[ssel] - start,
                          nb_np[np.repeat(ssel, name_lens)].tobytes(), new_non,
                          vb_np[np.repeat(ssel, val_lens)].tobytes(), new_nov,
                          np.asarray(seg_high, dtype=bool)[ssel])
        return out

    def to_arrow_map(self, B: int):
        """A pyarrow ``map<string, string>`` array built from the flat
        buffers; None where the dict path must decide (several chunks --
        several formats --, a name with a byte >= 0x80, whose ``lower()``
        can differ from the ASCII fold, or many eager rows).  A name twice
        in a row collapses as in the dicts (``_dedup_names``); eager and
        dropped rows are spliced into the flat layout."""
        if self._dense is not None or len(self.chunks) != 1:
            return None
        if len(self.eager) > max(64, B // 32):
            return None   # heavy one-by-one traffic: splicing stops paying
        import pyarrow as pa

        vrows, seg_row, nb, non, vb, nov, seg_high = self.chunks[0]
        seg_row = np.asarray(seg_row, dtype=np.int64)
        seg_high = np.asarray(seg_high, dtype=bool)
        n_seg = len(seg_row)
        name_lens = np.diff(non)
        val_lens = np.diff(nov)
        nb_np = np.frombuffer(nb, dtype=np.uint8)
        vb_np = np.frombuffer(vb, dtype=np.uint8)
        upper = (nb_np >= 0x41) & (nb_np <= 0x5A)
        folded = np.where(upper, nb_np | 0x20, nb_np)

        # Segments of rows delivered one by one (eager wins) or popped
        # leave before the checks below, so that a shadowed row cannot
        # cost the column its flat path.
        shadow = set(self.dropped)
        shadow.update(self.eager)
        if shadow:
            seg_keep = ~np.isin(seg_row, np.fromiter(shadow, dtype=np.int64))
            if not seg_keep.all():
                folded = folded[np.repeat(seg_keep, name_lens)]
                vb_np = vb_np[np.repeat(seg_keep, val_lens)]
                seg_row, seg_high = seg_row[seg_keep], seg_high[seg_keep]
                name_lens, val_lens = name_lens[seg_keep], val_lens[seg_keep]
                n_seg = len(seg_row)

        if bool(seg_high.any()):
            return None
        nb_off = np.zeros(n_seg + 1, dtype=np.int64)
        np.cumsum(name_lens, out=nb_off[1:])
        vb_off = np.zeros(n_seg + 1, dtype=np.int64)
        np.cumsum(val_lens, out=vb_off[1:])
        if n_seg:
            dedup = _dedup_names(seg_row, folded, nb_off, vb_np, vb_off)
            if dedup is None:
                return None
            seg_row, folded, vb_np, name_lens, val_lens = dedup
            n_seg = len(seg_row)
            nb_off = np.zeros(n_seg + 1, dtype=np.int64)
            np.cumsum(name_lens, out=nb_off[1:])
            vb_off = np.zeros(n_seg + 1, dtype=np.int64)
            np.cumsum(val_lens, out=vb_off[1:])

        counts = np.zeros(B, dtype=np.int64)
        left = np.searchsorted(seg_row, vrows, side="left")
        right = np.searchsorted(seg_row, vrows, side="right")
        counts[vrows] = right - left
        covered = np.zeros(B, dtype=bool)
        covered[vrows] = True
        for i in self.dropped:
            if 0 <= i < B:
                covered[i] = False
                counts[i] = 0

        # The eager rows' items spliced in row order (Python per row, the
        # segments stay vectorized).
        spliced = False
        if self.eager:
            cut_n = cut_v = cut_seg = 0
            inserts = []
            for i in sorted(self.eager):
                if not (0 <= i < B) or i in self.dropped:
                    continue   # dropped wins over eager, as in _materialize
                d = self.eager[i]
                if d is None:
                    covered[i] = False
                    counts[i] = 0
                    continue
                covered[i] = True
                counts[i] = len(d)
                inserts.append((i, [str(k).encode("utf-8") for k in d.keys()],
                                [str(v).encode("utf-8") for v in d.values()]))
            if inserts:
                spliced = True
                name_pieces, val_pieces, nlen_pieces, vlen_pieces = [], [], [], []
                for i, keys_b, vals_b in inserts:
                    at = int(np.searchsorted(seg_row, i, side="left"))
                    name_pieces.append(folded[cut_n:int(nb_off[at])])
                    val_pieces.append(vb_np[cut_v:int(vb_off[at])])
                    nlen_pieces.append(name_lens[cut_seg:at])
                    vlen_pieces.append(val_lens[cut_seg:at])
                    if keys_b:
                        name_pieces.append(np.frombuffer(b"".join(keys_b), dtype=np.uint8))
                        val_pieces.append(np.frombuffer(b"".join(vals_b), dtype=np.uint8))
                        nlen_pieces.append(np.array([len(k) for k in keys_b], dtype=np.int64))
                        vlen_pieces.append(np.array([len(v) for v in vals_b], dtype=np.int64))
                    cut_n, cut_v, cut_seg = int(nb_off[at]), int(vb_off[at]), at
                name_pieces.append(folded[cut_n:])
                val_pieces.append(vb_np[cut_v:])
                nlen_pieces.append(name_lens[cut_seg:])
                vlen_pieces.append(val_lens[cut_seg:])
                folded = np.concatenate(name_pieces)
                vb_np = np.concatenate(val_pieces)
                name_lens = np.concatenate(nlen_pieces)
                val_lens = np.concatenate(vlen_pieces)
                n_seg = len(name_lens)

        if spliced:   # the splice changed the lengths
            non32 = np.zeros(n_seg + 1, dtype=np.int64)
            np.cumsum(name_lens, out=non32[1:])
            nov32 = np.zeros(n_seg + 1, dtype=np.int64)
            np.cumsum(val_lens, out=nov32[1:])
        else:
            non32, nov32 = nb_off, vb_off
        if max(int(non32[-1]), int(nov32[-1])) > np.iinfo(np.int32).max:
            return None
        offsets64 = np.zeros(B + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets64[1:])
        mask = np.concatenate([~covered, [False]])
        try:
            keys = pa.StringArray.from_buffers(
                n_seg, pa.py_buffer(non32.astype(np.int32)),
                pa.py_buffer(np.ascontiguousarray(folded)))
            items = pa.StringArray.from_buffers(
                n_seg, pa.py_buffer(nov32.astype(np.int32)),
                pa.py_buffer(np.ascontiguousarray(vb_np)))
            arr = pa.MapArray.from_arrays(
                pa.array(offsets64.astype(np.int32), type=pa.int32(), mask=mask),
                keys, items)
            arr.validate(full=True)   # the UTF-8 check
        except (pa.lib.ArrowException, TypeError, ValueError):
            return None   # the dict path is always exact
        return arr


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


def _geo_typed_fill(col, sel, typed, miss, kind_ch: str) -> None:
    """A numeric GeoIP column's raw values and miss mask beside its object
    values, for the bridge's typed array; fills of two numeric kinds in
    one column turn that path off (``typed_kind`` None)."""
    B = len(typed)
    if "typed_values" not in col:
        col["typed_values"] = np.zeros(B, dtype=np.float64 if kind_ch == "f" else np.int64)
        col["typed_miss"] = np.ones(B, dtype=bool)
        col["typed_kind"] = kind_ch
    if col.get("typed_kind") == kind_ch:
        col["typed_values"] = np.where(sel, typed, col["typed_values"])
        col["typed_miss"] = np.where(sel, miss, col["typed_miss"])
    else:
        col["typed_kind"] = None


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
                "ok": np.zeros(B, dtype=bool), "null": np.zeros(B, dtype=bool)}
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
    "device_reject", "host_fields"); ``rescue_wall_s`` is the wall time
    the oracle added.

    ``packed`` is the device's trailing view block only (4 int32 rows a
    span field, copied out of the fetch); ``device_views`` maps a field to
    the row of its merged span word there (the next three rows are its
    first 12 bytes); ``dirty_view_rows`` (truncated lines) are zeroed and
    patched on the host.  ``assembly_pool`` is the parser's host pool,
    which ``to_arrow`` and the native passes read their width from."""

    def __init__(self, lines, buf, lengths, valid, columns, overrides,
                 needs_host, format_index, packed=None, device_views=None,
                 dirty_rows=None, assembly_pool=None):
        self._lines = lines
        self.buf = buf
        self.lengths = lengths
        self.valid = valid
        self._columns = columns
        self._overrides = overrides
        self.needs_host = needs_host
        self.format_index = format_index
        self.packed = packed
        self.device_views = device_views or {}
        self.dirty_view_rows = (dirty_rows if dirty_rows is not None
                                else np.empty(0, dtype=np.int64))
        self.assembly_pool = assembly_pool
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
        self._ascii_only: Optional[bool] = None

    @property
    def oracle_row_ids(self) -> np.ndarray:
        """The reference's name for ``needs_host``."""
        return self.needs_host

    @property
    def oracle_rows(self) -> int:
        """How many rows the oracle visited."""
        return len(self.needs_host)

    @property
    def ascii_only(self) -> bool:
        """Every byte of the batch buffer < 0x80: then every gathered span
        is valid UTF-8 and the bridge skips its validate pass (one max over
        the buffer, computed once)."""
        if self._ascii_only is None:
            B = self.lines_read
            self._ascii_only = bool(B == 0 or int(self.buf[:B].max(initial=0)) < 0x80)
        return self._ascii_only

    def raw_line(self, i: int) -> bytes:
        """The raw bytes of line ``i`` as ingested (strings UTF-8)."""
        return _raw_line_bytes(self._lines[i])

    def field_ids(self) -> List[str]:
        return list(self._columns)

    def column(self, field_id: str) -> Dict[str, Any]:
        """A column's arrays: a span column's starts / ends / ok / null
        (with amp / fix / fix_mode for a device span), a numeric one's
        values / null / null_zero / ok, an object one's values / ok."""
        return self._columns[cleanup_field_value(field_id)]

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

    def span_bytes(self, field_id: str, include_fix: bool = False, threads: int = 0):
        """A device span column as flat bytes: (data uint8, offsets int64
        [B+1], valid bool [B]); row r's raw value is
        ``data[offsets[r]:offsets[r+1]]`` where ``valid[r]``.  None where
        the column has host overrides, or URI-repair (``fix``) rows unless
        ``include_fix`` (the bridge gathers those raw and splices the
        repaired values in).  ``threads`` caps the native gather."""
        from ..native import gather_spans

        inputs = self._span_flat_inputs(field_id, include_fix=include_fix)
        if inputs is None:
            return None
        starts, lens, valid = inputs
        data, offsets = gather_spans(self.buf[:self.lines_read], starts, lens,
                                     threads=threads)
        self._amp_normalize(field_id, data, offsets, lens, valid)
        return data, offsets, valid

    def _span_flat_inputs(self, field_id: str, include_fix: bool = False):
        """(starts, lens, valid) of a column the flat gather can take; None
        where it needs the per-row path."""
        field_id = cleanup_field_value(field_id)
        col = self._columns[field_id]
        if col["kind"] != "span" or self._overrides.get(field_id):
            return None
        B = self.lines_read
        fix = col.get("fix")
        if not include_fix and fix is not None and fix[:B].any():
            return None
        valid = (np.asarray(self.valid[:B]).astype(bool)
                 & np.asarray(col["ok"][:B]).astype(bool)
                 & ~np.asarray(col["null"][:B]).astype(bool))
        starts = np.asarray(col["starts"][:B], dtype=np.int32)
        lens = np.where(valid, np.asarray(col["ends"][:B]) - starts, 0).astype(np.int64)
        return starts, lens, valid

    def _amp_normalize(self, field_id, data, offsets, lens, valid) -> None:
        """The ?& query normalization on gathered bytes, in place (column
        offsets, B + 1 of them)."""
        amp = self._columns[cleanup_field_value(field_id)].get("amp")
        B = self.lines_read
        if amp is not None and amp[:B].any():
            swap = valid & np.asarray(amp[:B]).astype(bool) & (lens > 0)
            at = offsets[:-1][swap]
            at = at[data[at] == np.uint8(ord("?"))]
            data[at] = np.uint8(ord("&"))

    def span_bytes_many(self, field_ids, include_fix: bool = False, threads: int = 0):
        """Several span columns in one native gather: {field_id: (data,
        offsets, valid)} for the columns ``span_bytes`` would take (repair
        rows included with ``include_fix``); the others are absent.
        ``threads`` defaults to the assembly pool's budget."""
        from ..native import gather_spans_multi

        if not threads and self.assembly_pool is not None:
            threads = self.assembly_pool.workers
        B = self.lines_read
        elig = []
        for fid in field_ids:
            inputs = self._span_flat_inputs(fid, include_fix=include_fix)
            if inputs is not None:
                elig.append((cleanup_field_value(fid), inputs))
        if not elig:
            return {}
        starts = np.stack([e[1][0] for e in elig])
        lens = np.stack([e[1][1] for e in elig])
        data, goff = gather_spans_multi(self.buf[:B], starts, lens, threads=threads)
        out = {}
        for k, (fid, (_, lens_k, valid_k)) in enumerate(elig):
            base = goff[k * B]
            offsets = goff[k * B:k * B + B + 1] - base
            col_data = data[base:int(goff[(k + 1) * B])]
            self._amp_normalize(fid, col_data, offsets, lens_k, valid_k)
            out[fid] = (col_data, offsets, valid_k)
        return out

    def to_arrow(self, include_validity: bool = True, strings: str = "view"):
        """A pyarrow Table (``arrow_bridge.batch_to_arrow``): int64 numbers
        (null where the row is invalid, not ok, a CLF null, or outside
        int64), a ``map<string, string>`` per wildcard field, span columns
        as ``string_view`` (``strings="view"``: views over this batch's
        buffer, no value byte copied for a clean row; built from the
        device's view rows where the batch has them) or ``string``
        (``strings="copy"``), other columns typed from their values; with
        ``include_validity`` a last ``__valid__: bool`` column."""
        from .arrow_bridge import batch_to_arrow

        if strings not in ("view", "copy"):
            raise ValueError(f"strings must be 'view' or 'copy', not {strings!r}")
        return batch_to_arrow(self, include_validity=include_validity, strings=strings)

    # Column entries that are not per-row arrays (shared metadata and
    # vocabularies): never row-sliced, even where a vocabulary's length
    # equals the batch's.
    _NON_ROW_KEYS = frozenset(("kind", "fix_mode", "mixed_fill", "typed_kind",
                               "dict_values"))

    def slice(self, start: int, stop: int) -> "BatchResult":
        """The rows [start, stop) (clamped) as a result of their own, with
        nothing materialized again: column arrays and the buffer are numpy
        views, overrides, ``needs_host`` and ``reject_reasons`` rebase to
        the window, wildcard chunks re-pack to its segments.  Every
        delivery of the slice equals a parse of the window's lines alone
        (each row's verdict is its own).  The device's view rows are
        dropped (``strings="view"`` builds views on the host), and the
        batch-level rescue figures stay on the parent."""
        B = self.lines_read
        start = max(0, min(int(start), B))
        stop = max(start, min(int(stop), B))
        columns = {fid: {k: (v if k in self._NON_ROW_KEYS or not isinstance(v, np.ndarray)
                             else v[start:stop]) for k, v in col.items()}
                   for fid, col in self._columns.items()}
        overrides: Dict[str, Any] = {}
        for fid, ov in self._overrides.items():
            if isinstance(ov, _LazyWildcard):
                overrides[fid] = ov.sliced(start, stop)
            else:
                overrides[fid] = {i - start: v for i, v in ov.items() if start <= i < stop}
        ids = self.needs_host
        lo = int(np.searchsorted(ids, start, side="left"))
        hi = int(np.searchsorted(ids, stop, side="left"))
        out = BatchResult(_SliceLines(self._lines, start, stop - start),
                          self.buf[start:stop], self.lengths[start:stop],
                          self.valid[start:stop], columns, overrides, ids[lo:hi] - start,
                          self.format_index[start:stop], assembly_pool=self.assembly_pool)
        out.reject_reasons = {i - start: r for i, r in self.reject_reasons.items()
                              if start <= i < stop}
        out.framer = self.framer
        return out
