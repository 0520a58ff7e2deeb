"""The port's compiled parser state equals the reference's.

Tokenizer, split program, field plans, packed layout and timestamp
layout of logparser_tpu_torch, for ``combined`` / ``common`` and several
field sets, against logparser_tpu's; the plain-data carry round trip; and
the port's copy of the corpus generator.
"""
import numpy as np
import pytest

from logparser_tpu.dissectors.tokenformat import FixedStringToken as RefFixedStringToken
from logparser_tpu.httpd.apache import ApacheHttpdLogFormatDissector
from logparser_tpu.tools import demolog as ref_demolog
from logparser_tpu_torch import TorchBatchParser, UnsupportedFieldError
from logparser_tpu_torch.dissectors.tokenformat import (
    FixedStringToken,
    UnsupportedFormatError,
)
from logparser_tpu_torch.httpd.apache import ApacheLogFormat
from logparser_tpu_torch.tools import demolog
from logparser_tpu_torch.tools.demolog import (
    COMBINEDIO_STRFTIME_FIELDS,
    COMBINEDIO_STRFTIME_FORMAT,
    URI_CHAIN_FIELDS,
    ZONETEXT_FIELDS,
    ZONETEXT_FORMAT,
)
from logparser_tpu_torch.tpu.carry import unit_to_plain, units_from_reference
from test_torch_harness import (
    assert_parse_matches_reference,
    assert_plain_equal,
    jax_unit_plain,
    reference_parser,
)

HEADLINE = ref_demolog.HEADLINE_FIELDS
STRFTIME_PAIR = ('%h [%{begin:%d/%B/%Y:%I:%M:%S %p}t] [%{end:%Y-%m-%dT%H:%M:%S%z}t] '
                 '%>s')

FIELD_SETS = [
    ("combined", HEADLINE),
    ("common", ["IP:connection.client.host", "NUMBER:connection.client.logname",
                "BYTES:response.body.bytes", "BYTESCLF:response.body.bytes",
                "STRING:request.status.last"]),
    ("combined", ["HTTP.PROTOCOL_VERSION:request.firstline.protocol",
                  "TIME.YEAR:request.receive.time.year",
                  "TIME.MONTHNAME:request.receive.time.monthname",
                  "TIME.DATE:request.receive.time.date_utc",
                  "TIME.EPOCH:request.receive.time.epoch",
                  "HTTP.USERAGENT:request.user-agent"]),
    ('[%t] "%r" %>s', ["TIME.EPOCH:request.receive.time.epoch",
                       "STRING:request.status.last",
                       "HTTP.METHOD:request.firstline.method"]),
    ("combined\ncommon", ["IP:connection.client.host",
                          "BYTES:response.body.bytes",
                          "TIME.EPOCH:request.receive.time.epoch"]),
    # The URI chain: URI / protocol splits, query-string groups, the port.
    ("combined", URI_CHAIN_FIELDS),
    ('%h "%r" "%{Referer}i" "%{Cookie}i"',
     ["HTTP.PATH:request.firstline.uri.path", "HTTP.REF:request.referer.ref",
      "HTTP.USERINFO:request.referer.userinfo", "STRING:request.referer.query.a.b",
      "HTTP.PROTOCOL:request.firstline.protocol"]),
    # The strftime timestamps: %z, %Z zone text, begin: / end: tokens, full
    # month names with a 12-hour clock, and mod_logio's %I / %O.
    (COMBINEDIO_STRFTIME_FORMAT, COMBINEDIO_STRFTIME_FIELDS),
    (ZONETEXT_FORMAT, ZONETEXT_FIELDS),
    (STRFTIME_PAIR, ["TIME.EPOCH:request.receive.time.begin.epoch",
                     "TIME.DATE:request.receive.time.end.date",
                     "TIME.HOUR:request.receive.time.begin.hour_utc",
                     "STRING:request.status.last"]),
    ("combinedio", ["BYTES:request.bytes", "BYTES:response.bytes",
                    "TIME.EPOCH:request.receive.time.epoch"]),
]


@pytest.mark.parametrize("fmt", ["combined", "common", '[%t] "%r" %>s %%',
                                 "combinedio", COMBINEDIO_STRFTIME_FORMAT,
                                 ZONETEXT_FORMAT, STRFTIME_PAIR + " %{%Y}t"])
def test_tokenizer_matches_reference(fmt):
    ours = ApacheLogFormat(fmt).log_format_tokens
    ref = ApacheHttpdLogFormatDissector(fmt).log_format_tokens
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert isinstance(a, FixedStringToken) == isinstance(b, RefFixedStringToken)
        assert a.regex == b.regex and a.length == b.length and a.prio == b.prio
        assert [(f.type, f.name, {c.name for c in f.casts}) for f in a.output_fields] == [
            (f.type, f.name, {c.name for c in f.casts}) for f in b.output_fields
        ]


@pytest.mark.parametrize("fmt,fields", FIELD_SETS)
def test_compiled_units_match_reference(fmt, fields):
    ref = reference_parser(fmt, fields)
    ours = TorchBatchParser(fmt, fields, device="cpu")
    assert len(ours.units) == len(ref.units)
    for u_ours, u_ref in zip(ours.units, ref.units):
        assert_plain_equal(unit_to_plain(u_ours), jax_unit_plain(u_ref))
    assert ours.view_specs == [(f, tuple(u)) for f, u in ref._view_specs()]


@pytest.mark.parametrize("fmt,fields", FIELD_SETS[:2] + FIELD_SETS[5:6])
def test_units_from_reference_round_trips(fmt, fields):
    plain = [jax_unit_plain(u) for u in reference_parser(fmt, fields).units]
    carried = units_from_reference(plain)
    for p, u in zip(plain, carried):
        assert_plain_equal(unit_to_plain(u), p)
    # The port's own compile equals the carried-across units.
    own = TorchBatchParser(fmt, fields, device="cpu").units
    for a, b in zip(own, carried):
        assert_plain_equal(unit_to_plain(a), unit_to_plain(b))


def test_timestamp_layout_matches_reference():
    ref = reference_parser("combined", HEADLINE).units[0]
    ours = TorchBatchParser("combined", HEADLINE, device="cpu").units[0]
    fid = "TIME.EPOCH:request.receive.time.epoch"
    a = unit_to_plain(ours)["plans"]
    b = jax_unit_plain(ref)["plans"]
    (pa,) = [p for p in a if p[0] == fid]
    (pb,) = [p for p in b if p[0] == fid]
    assert_plain_equal(pa[5], pb[5], "DeviceTimeLayout")
    assert pa[5]["seg_widths"] == (21,) and pa[5]["tail"] == "offset"


@pytest.mark.parametrize("seed", [1, 42, 1234])
def test_generator_copy_emits_the_same_lines(seed):
    for garbage in (0.0, 0.01, 0.3):
        assert demolog.generate_combined_lines(300, seed, garbage) == \
            ref_demolog.generate_combined_lines(300, seed, garbage)
    assert demolog.HEADLINE_FIELDS == ref_demolog.HEADLINE_FIELDS


@pytest.mark.parametrize("fmt", [
    "%h %D",                               # an Apache token not on this slice
    '%h %{X-Forwarded-For}i "%r"',         # generic request header
    "$remote_addr$status",                 # nginx: adjacent value tokens
    "%h%u",                                # adjacent value tokens
    "neither apache nor nginx",            # no format at all
])
def test_unported_formats_raise(fmt):
    with pytest.raises(UnsupportedFormatError):
        TorchBatchParser(fmt, ["IP:connection.client.host"], device="cpu")


@pytest.mark.parametrize("fmt,field,where", [
    ("%h [%{%d/%b/%Y}t]", "TIME.LOCALIZEDSTRING:request.receive.time",
     "TIME.LOCALIZEDSTRING values"),
    ("$remote_addr [$time_iso8601]", "TIME.EPOCH:request.receive.time.epoch",
     "compile_java_pattern"),
    ('%h %t "%r" %>s %b', "STRING:no.such.field", "no producer"),
])
def test_unported_fields_raise_naming_the_slice(fmt, field, where):
    with pytest.raises(UnsupportedFieldError, match=where):
        TorchBatchParser(fmt, [field], device="cpu")


def test_binary_ip_resolves_to_a_host_plan():
    """$binary_remote_addr's IP has no device plan: a host plan, every line
    won by the format visits the oracle, and the values are the
    reference's."""
    p = TorchBatchParser("$binary_remote_addr $status", ["IP:connection.client.host"],
                         device="cpu")
    assert p.plan_by_id["IP:connection.client.host"].kind == "host"
    assert p._unit_oracle_fields == [["IP:connection.client.host"]]
    lines = ["\\x01\\x02\\x03\\x04 200", "\\xff\\xfe\\x00\\x10 200", "- 200"]
    ours = assert_parse_matches_reference("$binary_remote_addr $status",
                                          ["IP:connection.client.host"], lines)
    assert ours.to_pylist("IP:connection.client.host")[:2] == ["1.2.3.4", "-1.-2.0.16"]


def test_charset_tables_are_bool_copies():
    ours = TorchBatchParser("combined", HEADLINE, device="cpu").units[0].program
    ref = reference_parser("combined", HEADLINE).units[0].program
    assert ours.charset_table.dtype == np.bool_
    assert np.array_equal(ours.charset_table, ref.charset_table)
