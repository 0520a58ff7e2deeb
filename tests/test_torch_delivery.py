"""The port's columnar delivery against the JAX package's, on the CPU.

On the headline, URI chain and geoip_chain configurations (the
reference's own field sets over ``demolog`` corpora, a few hundred lines
plus each configuration's edge lines; cookies_uniqueid runs the same
tests in ``test_torch_delivery_cookies.py``), the ``BatchResult`` of
``TorchBatchParser(device="cpu")`` is held to ``TpuBatchParser``'s:

- ``column`` (every array of the reference's column dict), ``ascii_only``,
  ``span_bytes`` (with and without ``include_fix``) and
  ``span_bytes_many``;
- ``to_arrow(strings="view")`` and ``to_arrow(strings="copy")``, compared
  with ``Table.equals`` (types included);
- the device's view rows: ``device_views`` equal, the port's view block
  equal to the reference's ``packed`` block bit for bit (the plain
  ``pack_rows`` emits it here), every view column of the table
  interleaved from it (``native.views_interleave``), and the table equal
  to the one built without view rows;
- ``_LazyWildcard.to_arrow_map`` taken (not None) for the wildcard fields
  on the generated lines, and equal to the reference's column;
- ``slice(a, b)`` for several windows -- ``(a, a)``, clamped bounds,
  windows over rows the oracle rescued -- equal to the reference's slice
  and to the port's own parse of the window alone (``to_dict``,
  ``valid``, ``needs_host``, ``reject_reasons``, copy-mode Arrow);
- ``parse_to_ipc``: the bytes equal across list and blob input and across
  ``assembly_workers`` 1 and 4 (with the pooled paths forced on), the
  tables equal across pool widths, and the decoded table equal to the
  reference's table (on the headline also to the reference's own
  ``parse_to_ipc``);
- a view table held while the next batch is parsed keeps its values.

One module-scoped reference parser per configuration, grown before its
first batch to the query slots its corpus needs (one compile): 32 for the
URI chain, whose corpus here leaves out the edge line past the 128-slot
cap (a 128-slot reference compile alone takes about a minute on one CPU
process; that line's host rescue is held to the reference by
``test_torch_arrow.py`` and ``test_torch_uri.py``).
"""
import os

import numpy as np
import pyarrow as pa
import pytest

from logparser_tpu.geoip import GeoIPASNDissector as RefASN
from logparser_tpu.geoip import GeoIPCityDissector as RefCity
from logparser_tpu.tpu.arrow_bridge import table_from_ipc_bytes as ref_from_ipc
from logparser_tpu.tpu.batch import TpuBatchParser
from logparser_tpu_torch import TorchBatchParser, native
from logparser_tpu_torch.geoip import GeoIPASNDissector, GeoIPCityDissector
from logparser_tpu_torch.tools import demolog, geoip_testdata
from logparser_tpu_torch.tpu import arrow_bridge, hostpool
from logparser_tpu_torch.tpu.arrow_bridge import (
    batch_to_arrow,
    parse_to_ipc,
    table_from_ipc_bytes,
    table_to_ipc_bytes,
)
from logparser_tpu_torch.tpu.batch import _LazyWildcard
from test_torch_harness import EDGE_LINES

N = 250
CONFIGS = ["headline", "uri_chain", "geoip_chain"]
WILDCARDS = {"uri_chain": ["STRING:request.firstline.uri.query.*",
                           "STRING:request.referer.query.*"],
             "cookies_uniqueid": ["HTTP.COOKIE:request.cookies.*",
                                  "HTTP.SETCOOKIE:response.cookies.*"]}


def _config(name):
    """(format, fields, lines, reference kwargs, port kwargs, query slots)."""
    remap = {"type_remappings": demolog.COOKIE_REMAPPINGS}
    if name == "headline":
        return ("combined", demolog.HEADLINE_FIELDS,
                demolog.generate_combined_lines(N, seed=42, garbage_fraction=0.01)
                + EDGE_LINES, {}, {}, 16)
    if name == "uri_chain":
        edge = [ln for ln in demolog.uri_edge_lines() if ln.count("&") < 128]
        return ("combined", demolog.URI_CHAIN_FIELDS,
                demolog.generate_combined_lines(N, seed=53) + edge, {}, {}, 32)
    if name == "cookies_uniqueid":
        edge = [ln for ln in demolog.cookie_edge_lines() if len(ln) < 512]
        return (demolog.COOKIE_FORMAT, demolog.COOKIE_FIELDS,
                demolog.cookie_lines(N) + edge, remap, remap, 64)
    fixtures = geoip_testdata.ensure_test_databases()
    city = os.path.join(fixtures, "GeoIP2-City-Test.mmdb")
    asn = os.path.join(fixtures, "GeoLite2-ASN-Test.mmdb")
    return ("combined", demolog.GEOIP_FIELDS,
            demolog.geoip_chain_lines(N) + demolog.geoip_edge_lines(),
            {"extra_dissectors": [RefCity(city), RefASN(asn)]},
            {"extra_dissectors": [GeoIPCityDissector(city), GeoIPASNDissector(asn)]},
            16)


def _grow(parser, slots):
    while parser.csr_slots < slots and parser._grow_csr_slots():
        pass


class Case:
    """One configuration: both parsers, its lines, and a result of each
    kept fresh (no dict-style access) for the checks that need it."""

    def __init__(self, name):
        fmt, fields, lines, ref_kw, our_kw, slots = _config(name)
        self.name, self.lines, self.slots = name, lines, slots
        self.ref = TpuBatchParser(fmt, list(fields), **ref_kw)
        self.ours = TorchBatchParser(fmt, fields, device="cpu", **our_kw)
        _grow(self.ref, slots)
        _grow(self.ours, slots)
        self.make_ours = lambda **kw: TorchBatchParser(fmt, fields, device="cpu",
                                                       **our_kw, **kw)
        self.want = self.ref.parse_batch(lines)
        self.got = self.ours.parse_batch(lines)
        assert self.ref.csr_slots == slots, "the corpus regrew the reference"
        self._plain = None

    def plain(self):
        """The port's parse of the lines without view rows (one, shared)."""
        if self._plain is None:
            self._plain = self.ours.parse_batch(self.lines, emit_views=False)
        return self._plain


_CASES = {}


def get_case(name):
    """The configuration's Case, built once per process."""
    if name not in _CASES:
        _CASES[name] = Case(name)
    return _CASES[name]


@pytest.fixture(scope="module", params=CONFIGS)
def case(request):
    return get_case(request.param)


@pytest.fixture(scope="module", autouse=True)
def _close_parsers():
    yield
    for c in _CASES.values():
        c.ours.close()
        c.ref.close()


def _equal_arrays(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == object or b.dtype == object:
        return a.shape == b.shape and all(
            (x is None and y is None) or (x == y or (x != x and y != y))
            for x, y in zip(a.tolist(), b.tolist()))
    return np.array_equal(a, b)


def _tables_equal(got, want):
    assert got.schema.equals(want.schema), (got.schema, want.schema)
    assert got.equals(want), [n for n in want.column_names
                              if not got.column(n).equals(want.column(n))]


def test_column_and_ascii_only_match_reference(case):
    """Every array of the reference's column dicts, on the rows whose
    value the arrays decide (a row with an override in either result
    delivers the override; the port decodes some of those rows'
    segments where the reference takes them one by one)."""
    got, want = case.got, case.want
    assert got.field_ids() == want.field_ids()
    assert got.ascii_only == want.ascii_only
    B = got.lines_read
    for fid in want.field_ids():
        g, w = got.column(fid), want.column(fid)
        assert g["kind"] == w["kind"], fid
        rows = np.ones(B, dtype=bool)
        for ov in (got._overrides.get(fid, {}), want._overrides.get(fid, {})):
            if not hasattr(ov, "chunks"):
                rows[list(ov)] = False
        for key, wv in w.items():
            if key in ("kind", "fix_mode", "mixed_fill", "typed_kind"):
                assert g.get(key) == wv, (fid, key)
            elif key == "dict_values":
                assert _equal_arrays(g[key], wv), (fid, key)
            else:
                assert _equal_arrays(np.asarray(g[key])[rows], np.asarray(wv)[rows]), (fid, key)


def test_span_bytes_match_reference(case):
    got, want = case.got, case.want
    span_ids = [f for f in want.field_ids() if want.column(f)["kind"] == "span"]
    for fid in span_ids:
        for include_fix in (False, True):
            g = got.span_bytes(fid, include_fix=include_fix)
            w = want.span_bytes(fid, include_fix=include_fix)
            assert (g is None) == (w is None), (fid, include_fix)
            if w is not None:
                for x, y in zip(g, w):
                    assert np.array_equal(x, y), (fid, include_fix)
    for include_fix in (False, True):
        g = got.span_bytes_many(span_ids, include_fix=include_fix)
        w = want.span_bytes_many(span_ids, include_fix=include_fix)
        assert list(g) == list(w)
        for fid in w:
            for x, y in zip(g[fid], w[fid]):
                assert np.array_equal(x, y), fid


def test_to_arrow_matches_reference_in_both_modes(case):
    for strings in ("copy", "view"):
        _tables_equal(case.got.to_arrow(strings=strings),
                      case.want.to_arrow(include_validity=True, strings=strings))
    _tables_equal(case.got.to_arrow(include_validity=False),
                  case.want.to_arrow(include_validity=False))


def test_device_view_rows_equal_reference_and_are_read(case, monkeypatch):
    got, want = case.got, case.want
    assert got.device_views == want.device_views and got.device_views
    B = got.lines_read
    assert got.packed.shape[0] == want.packed.shape[0]
    assert np.array_equal(got.packed[:, :B], np.asarray(want.packed)[:, :B])
    assert np.array_equal(got.dirty_view_rows, want.dirty_view_rows)
    seen = []
    real = native.views_interleave

    def counting(packed, field_rows, *args, **kw):
        seen.append(len(field_rows))
        return real(packed, field_rows, *args, **kw)

    monkeypatch.setattr(native, "views_interleave", counting)
    table = got.to_arrow()
    assert seen == [len(got.device_views)]
    for fid in got.device_views:
        assert table.schema.field(fid).type == pa.string_view()
    # Without view rows (emit_views=False) the host builds the same views.
    plain = case.plain()
    assert plain.packed is None and not plain.device_views
    _tables_equal(plain.to_arrow(), table)
    assert seen == [len(got.device_views)]


def check_wildcard_maps(case):
    """On the generated lines every wildcard map is built from the flat
    buffers and equals the reference's column."""
    fresh = case.ours.parse_batch(case.lines[:N])
    want = case.want.to_arrow(strings="copy")
    for fid in WILDCARDS[case.name]:
        ov = fresh._overrides[fid]
        assert isinstance(ov, _LazyWildcard)
        arr = ov.to_arrow_map(N)
        assert arr is not None, fid
        assert arr.equals(want.column(fid).combine_chunks().slice(0, N)), fid


def test_wildcard_maps_come_from_the_flat_buffers():
    check_wildcard_maps(get_case("uri_chain"))


def _windows(res):
    B = res.lines_read
    rescued = res.needs_host.tolist()
    wins = [(0, 0), (7, 7), (-5, 40), (B - 30, B + 100), (B, B + 3), (0, B)]
    if rescued:
        r = rescued[len(rescued) // 2]
        wins += [(max(r - 9, 0), r + 1), (r, r + 1), (rescued[0], rescued[-1] + 1)]
    return wins


def _same_delivery(a, b):
    assert a.lines_read == b.lines_read
    assert a.to_dict() == b.to_dict()
    assert np.asarray(a.valid).tolist() == np.asarray(b.valid).tolist()
    assert np.asarray(a.oracle_row_ids).tolist() == np.asarray(b.oracle_row_ids).tolist()
    assert a.reject_reasons == b.reject_reasons
    assert a.good_lines == b.good_lines and a.bad_lines == b.bad_lines


def test_slice_equals_reference_and_a_solo_parse(case):
    got, want = case.got, case.want
    B = got.lines_read
    for a, b in _windows(got):
        s, r = got.slice(a, b), want.slice(a, b)
        lo, hi = max(0, min(a, B)), max(max(0, min(a, B)), min(b, B))
        assert s.lines_read == hi - lo and not s.device_views and s.packed is None
        _same_delivery(s, r)
        _tables_equal(s.to_arrow(strings="copy"), r.to_arrow(strings="copy"))
        _tables_equal(s.to_arrow(), r.to_arrow())
        if hi > lo and (lo, hi) != (0, B):   # the whole batch is case.got itself
            solo = case.ours.parse_batch(case.lines[lo:hi])
            _same_delivery(s, solo)
            _tables_equal(s.to_arrow(strings="copy"), solo.to_arrow(strings="copy"))


def test_parse_to_ipc_equal_across_inputs_and_pool_widths(case, monkeypatch):
    """parse_to_ipc of the lines on a 1-wide pool and of the blob on a
    4-wide one give the same bytes (the pooled paths -- the column
    fan-out, the oracle on a pool thread -- forced on at this size), the
    bytes of the result's own copy table; the result's tables are equal
    at both widths; the decoded table is the reference's."""
    monkeypatch.setattr(hostpool, "MIN_POOLED_ROWS", 1)
    monkeypatch.setattr(hostpool, "VIEW_POOL_MIN_WORKERS", 2)
    blob = "\n".join(case.lines).encode() + b"\n"
    ipc = {}
    for workers, data in ((1, case.lines), (4, blob)):
        p = case.make_ours(assembly_workers=workers)
        _grow(p, case.slots)
        assert p.assembly_pool().workers == workers
        ipc[workers] = parse_to_ipc(p, data)
        p.close()
    assert ipc[1] == ipc[4]
    tables = {}
    for workers in (1, 4):
        pool = hostpool.AssemblyPool(workers)
        tables[workers] = [batch_to_arrow(case.got, strings=mode, pool=pool)
                           for mode in ("view", "copy")]
        pool.close()
    for a, b in zip(tables[1], tables[4]):
        _tables_equal(a, b)
    assert table_to_ipc_bytes(batch_to_arrow(case.plain(), strings="copy")) == ipc[1]
    table = table_from_ipc_bytes(ipc[1])
    _tables_equal(table, case.want.to_arrow(strings="copy"))
    if case.name == "headline":
        from logparser_tpu.tpu.arrow_bridge import parse_to_ipc as ref_parse_to_ipc

        _tables_equal(table, ref_from_ipc(ref_parse_to_ipc(case.ref, case.lines)))


def test_view_table_survives_the_next_batch(case):
    """A view table held while the next batch is parsed still reads its
    own values (the view arrays and the batch buffer are not reused)."""
    table = case.got.to_arrow()
    saved = table.to_pylist()
    case.ours.parse_batch(case.lines[::-1]).to_arrow()
    assert table.to_pylist() == saved


def test_arrow_bridge_helpers_match_reference():
    from logparser_tpu.tpu import arrow_bridge as ref_bridge

    valid = np.array([True, False, True, True, False, True, True, True, False])
    assert np.array_equal(arrow_bridge._null_bitmap(valid), ref_bridge._null_bitmap(valid))
    assert arrow_bridge._null_bitmap(np.ones(5, dtype=bool)) is None
    vocab = np.array(["a", "b", "ü"], dtype=object)
    assert arrow_bridge._pa_vocab(vocab) is arrow_bridge._pa_vocab(vocab)
    assert arrow_bridge._pa_vocab(vocab).equals(ref_bridge._pa_vocab(vocab))
