"""Arrow delivery equals the reference.

``BatchResult.to_arrow`` of ``TorchBatchParser(device="cpu")`` against
``TpuBatchParser``'s ``to_arrow(include_validity=True, ...)`` on every
configuration ``chip_smoke.py`` runs (headline, URI chain,
combinedio_strftime, strftime_zonetext, geoip_chain, nginx_uri,
nginx_timing, cookies_uniqueid), a few hundred generated lines plus each
configuration's edge lines: with ``strings="copy"`` the tables are equal
(``Table.equals``: types, nulls, values, the ``__valid__`` column), with
``strings="view"`` the schemas and values are, on every row, the rows
the host oracle rescues (``needs_host``) included.  Also the three faults this repairs: a long
at or past 2^63 reads null in the int64 column, a query-string wildcard
is a ``map<string, string>``, and the signature has the reference's
parameters.
"""
import os

import pyarrow as pa
import pytest

from logparser_tpu.geoip import GeoIPASNDissector as RefASN
from logparser_tpu.geoip import GeoIPCityDissector as RefCity
from logparser_tpu.tpu.batch import TpuBatchParser
from logparser_tpu_torch import TorchBatchParser
from logparser_tpu_torch.geoip import GeoIPASNDissector, GeoIPCityDissector
from logparser_tpu_torch.tools import demolog, geoip_testdata
from test_torch_harness import EDGE_LINES, assert_results_equal

_E = '1.2.3.4 - - [01/Jan/2024:10:00:00 +0000] "GET /x HTTP/1.1" 200 '
BIG_LINES = [_E + '9223372036854775808 "-" "u"', _E + '12345678901234567890 "-" "u"']
N = 300


def _configs():
    """{name: (format, fields, lines, reference kwargs, port kwargs, grow)}."""
    fixtures = geoip_testdata.ensure_test_databases()
    city = os.path.join(fixtures, "GeoIP2-City-Test.mmdb")
    asn = os.path.join(fixtures, "GeoLite2-ASN-Test.mmdb")
    remap = {"type_remappings": demolog.COOKIE_REMAPPINGS}
    return {
        "headline": ("combined", demolog.HEADLINE_FIELDS,
                     demolog.generate_combined_lines(N, seed=42, garbage_fraction=0.01)
                     + BIG_LINES + EDGE_LINES, {}, {}, False),
        "uri_chain": ("combined", demolog.URI_CHAIN_FIELDS,
                      demolog.generate_combined_lines(N, seed=53) + demolog.uri_edge_lines(),
                      {}, {}, True),
        "combinedio_strftime": (demolog.COMBINEDIO_STRFTIME_FORMAT,
                                demolog.COMBINEDIO_STRFTIME_FIELDS,
                                demolog.combinedio_strftime_lines(N)
                                + demolog.strftime_edge_lines(), {}, {}, False),
        "strftime_zonetext": (demolog.ZONETEXT_FORMAT, demolog.ZONETEXT_FIELDS,
                              demolog.zonetext_lines(N) + demolog.strftime_edge_lines(),
                              {}, {}, False),
        "geoip_chain": ("combined", demolog.GEOIP_FIELDS,
                        demolog.geoip_chain_lines(N) + demolog.geoip_edge_lines(),
                        {"extra_dissectors": [RefCity(city), RefASN(asn)]},
                        {"extra_dissectors": [GeoIPCityDissector(city),
                                              GeoIPASNDissector(asn)]}, False),
        "nginx_uri": (demolog.NGINX_URI_FORMAT, demolog.NGINX_URI_FIELDS,
                      demolog.nginx_uri_lines(N) + demolog.nginx_edge_lines(), {}, {}, False),
        "nginx_timing": (demolog.NGINX_TIMING_FORMAT, demolog.NGINX_TIMING_FIELDS,
                         demolog.nginx_timing_lines(N) + demolog.nginx_edge_lines(),
                         {}, {}, False),
        "cookies_uniqueid": (demolog.COOKIE_FORMAT, demolog.COOKIE_FIELDS,
                             demolog.cookie_lines(N) + demolog.cookie_edge_lines(),
                             remap, remap, True),
    }


def _pair(name):
    fmt, fields, lines, ref_kw, our_kw, grow = _configs()[name]
    ref = TpuBatchParser(fmt, list(fields), **ref_kw)
    ours = TorchBatchParser(fmt, fields, device="cpu", **our_kw)
    if grow:
        # Grown to the 128-slot cap before the first batch: one reference
        # compile instead of four (values do not depend on the slot count).
        while ref._grow_csr_slots():
            pass
        while ours._grow_csr_slots():
            pass
    return ref.parse_batch(lines), ours.parse_batch(lines), lines


@pytest.mark.parametrize("name", ["headline", "uri_chain", "combinedio_strftime",
                                  "strftime_zonetext", "geoip_chain", "nginx_uri",
                                  "nginx_timing", "cookies_uniqueid"])
def test_to_arrow_matches_reference(name):
    ref, ours, lines = _pair(name)
    assert_results_equal(ours, ref)
    got = ours.to_arrow(strings="copy")
    want = ref.to_arrow(include_validity=True, strings="copy")
    assert got.column_names == want.column_names and got.column_names[-1] == "__valid__"
    assert got.equals(want), [
        n for n in want.column_names if not got.column(n).equals(want.column(n))]
    got_v, want_v = ours.to_arrow(), ref.to_arrow()
    assert got_v.schema.equals(want_v.schema)
    assert got_v.to_pylist() == want_v.to_pylist()


def test_longs_past_int64_read_null():
    """C1: the byte count 2^63 and a 20-digit one are null in the int64
    column (the reference's Long.parseLong null) and Python ints in
    to_dict()."""
    res = TorchBatchParser("combined", demolog.HEADLINE_FIELDS, device="cpu").parse_batch(
        BIG_LINES)
    col = res.to_arrow(strings="copy").column("BYTES:response.body.bytes")
    assert col.type == pa.int64() and col.to_pylist() == [None, None]
    assert res.to_pylist("BYTES:response.body.bytes") == [9223372036854775808,
                                                            12345678901234567890]


def test_query_wildcard_is_a_map():
    """C2: a query-string wildcard builds map<string, string> in the
    reference's key order; rows without parameters map to {} and
    invalid rows to null."""
    fields = ["IP:connection.client.host", "STRING:request.firstline.uri.query.*"]
    lines = demolog.generate_combined_lines(50, seed=53) + ["garbage"]
    ours = TorchBatchParser("combined", fields, device="cpu").parse_batch(lines)
    ref = TpuBatchParser("combined", fields).parse_batch(lines)
    col = ours.to_arrow(strings="copy").column(fields[1])
    assert col.type == pa.map_(pa.string(), pa.string())
    assert col.equals(ref.to_arrow(strings="copy").column(fields[1]))
    assert col.to_pylist()[-1] is None


def test_signature_and_validity_column():
    """C3: include_validity and strings, with the reference's defaults."""
    lines = demolog.generate_combined_lines(20, seed=2, garbage_fraction=0.2)
    res = TorchBatchParser("combined", demolog.HEADLINE_FIELDS, device="cpu").parse_batch(lines)
    t = res.to_arrow()
    assert t.column_names == res.field_ids() + ["__valid__"]
    assert t.column("__valid__").to_pylist() == res.valid.tolist()
    assert t.schema.field("HTTP.URI:request.referer").type == pa.string_view()
    assert res.to_arrow(include_validity=False).column_names == res.field_ids()
    with pytest.raises(ValueError):
        res.to_arrow(strings="bytes")
