"""The strftime configurations end to end on the CPU against the reference.

``combinedio_strftime`` (mod_logio's ``combinedio`` with a strftime
``%{...%z}t`` timestamp) and ``strftime_zonetext`` (``%Z`` zone names)
from the reference package's bench.py: the port's tokenizer and strftime
compiler, its packed ``[K + 4V, B]`` rows against the reference executor
(bit for bit, a mismatch named through ``PackedLayout.slots``), and
``to_dict()`` / ``needs_host`` against ``TpuBatchParser`` on generated
lines plus ``demolog.strftime_edge_lines()``.  One reference parser per
configuration (module-scoped): each jit compile costs tens of seconds.
"""
import pytest
import torch

from logparser_tpu.dissectors.strftime_stamp import (
    UnsupportedStrfField as RefUnsupportedStrfField,
    compile_strftime as ref_compile_strftime,
)
from logparser_tpu.tpu.batch import TpuBatchParser
from logparser_tpu_torch import TorchBatchParser, UnsupportedFieldError
from logparser_tpu_torch.dissectors.strftime_stamp import (
    UnsupportedStrfField,
    compile_strftime,
)
from logparser_tpu_torch.tools import demolog
from logparser_tpu_torch.tpu import pipeline
from logparser_tpu_torch.tpu.carry import units_from_reference
from logparser_tpu_torch.tpu.runtime import encode_batch
from test_torch_harness import assert_results_equal, first_mismatch, jax_unit_plain, reference_packed

CONFIGS = {
    "combinedio_strftime": (demolog.COMBINEDIO_STRFTIME_FORMAT,
                            demolog.COMBINEDIO_STRFTIME_FIELDS,
                            demolog.combinedio_strftime_lines),
    "strftime_zonetext": (demolog.ZONETEXT_FORMAT, demolog.ZONETEXT_FIELDS,
                          demolog.zonetext_lines),
}
# The zone token ends the line: its peek byte is the zero past the end.
ZONE_LAST = ('%h %>s %{%d/%b/%Y:%H:%M:%S %Z}t',
             ["TIME.EPOCH:request.receive.time.epoch",
              "TIME.HOUR:request.receive.time.hour_utc", "STRING:request.status.last"])


@pytest.fixture(scope="module")
def reference():
    """{config: (TpuBatchParser, its parse of the config's lines)}, built
    lazily once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            fmt, fields, _ = CONFIGS[name]
            parser = TpuBatchParser(fmt, list(fields))
            lines = _lines(name)
            cache[name] = (parser, lines, parser.parse_batch(lines))
        return cache[name]
    return get


def _lines(name):
    _, _, gen = CONFIGS[name]
    return gen(300) + demolog.strftime_edge_lines()


def _compare(ours, ref, lines):
    return assert_results_equal(ours, ref)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_matches_reference(reference, name):
    _, lines, ref = reference(name)
    fmt, fields, _ = CONFIGS[name]
    ours = TorchBatchParser(fmt, fields, device="cpu").parse_batch(lines)
    _compare(ours, ref, lines)
    assert ours.valid[:300].sum() >= 290
    # Of the generated lines only garbage goes to the host: every zone of
    # the zone-text corpus is in the device vocabulary.
    assert all("[" not in lines[i] for i in ours.needs_host if i < 300)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("line_len", [128, 384])
def test_packed_rows_match_reference(reference, name, line_len):
    parser, lines, _ = reference(name)
    specs = parser._view_specs()
    units = units_from_reference([jax_unit_plain(u) for u in parser.units])
    ex = pipeline.UnitsExecutor(units, specs)
    buf, lengths, _ = encode_batch(lines, line_len=line_len)
    want = reference_packed(parser.units, specs, buf, lengths)
    got = ex(torch.from_numpy(buf), torch.from_numpy(lengths)).numpy()
    assert first_mismatch(parser.units, specs, got, want) is None
    # The port's own compile packs the same.
    fmt, fields, _ = CONFIGS[name]
    own = TorchBatchParser(fmt, fields, device="cpu").executor
    got = own(torch.from_numpy(buf), torch.from_numpy(lengths)).numpy()
    assert first_mismatch(parser.units, specs, got, want) is None


def test_edge_lines_take_the_reference_routes(reference):
    """Clock hour 24 is midnight, 25 and offsets at +-24 h reject, CEST
    in January is +1 h through CET's table, DST zones past their tables
    and pre-1970 rows go to the host while 2040 UTC stays on the card."""
    edge = demolog.strftime_edge_lines()
    fmt, fields, _ = CONFIGS["strftime_zonetext"]
    res = TorchBatchParser(fmt, fields, device="cpu").parse_batch(edge)
    epoch = dict(zip(edge, res.to_pylist("TIME.EPOCH:request.receive.time.epoch")))
    host = {edge[i] for i in res.needs_host}

    def zt(ts):
        return f'1.2.3.4 - - [{ts}] "GET /x HTTP/1.1" 200 5'

    assert epoch[zt("01/Jan/2024:24:00:00 UTC")] == 1704067200000
    assert epoch[zt("01/Jan/2024:10:00:00 CEST")] == 1704099600000
    assert epoch[zt("01/Jul/2040:10:00:00 UTC")] == 2224749600000
    for ts in ("01/Jan/2024:25:00:00 UTC", "01/Jul/2040:10:00:00 CET",
               "31/Dec/1969:23:00:00 UTC", "01/Jan/2024:10:00:00 UTCX",
               "01/Jan/2024:10:00:00 europe/paris"):
        assert zt(ts) in host, ts
    fmt, fields, _ = CONFIGS["combinedio_strftime"]
    res = TorchBatchParser(fmt, fields, device="cpu").parse_batch(edge)
    year = dict(zip(edge, res.to_pylist("TIME.YEAR:request.receive.time.year")))
    got = dict(zip(edge, res.to_pylist("BYTES:request.bytes")))
    io = [x for x in edge if x.endswith('"u" 12345678901234567890 7')][0]
    assert got[io] == 12345678901234567890
    assert year[edge[0]] == 2024 and year[edge[5]] == 2024
    assert {edge[1], edge[7], edge[8]} <= {edge[i] for i in res.needs_host}


def test_zone_token_that_ends_the_line():
    fmt, fields = ZONE_LAST
    lines = [f"1.2.3.4 200 {ts}" for ts in (
        "01/Jan/2024:10:00:00 UTC", "01/Jan/2024:10:00:00 Europe/Paris",
        "01/Jul/2024:10:00:00 CET", "01/Jan/2024:10:00:00 UTC2",
        "01/Jan/2024:10:00:00 Z", "01/Jan/2024:10:00:00 ", "01/Jan/2024:10:00:00")]
    lines += ["9.9.9.9 404 " + ln[ln.index("[") + 1:ln.index("]")]
              for ln in demolog.zonetext_lines(60) if "[" in ln]
    ref = TpuBatchParser(fmt, list(fields)).parse_batch(lines)
    ours = TorchBatchParser(fmt, fields, device="cpu").parse_batch(lines)
    _compare(ours, ref, lines)
    assert ours.valid[:3].all() and not ours.valid[3] and ours.valid[7:].all()


def test_corpora_are_the_benchmarks():
    import bench

    configs = {c[0]: c for c in bench.build_configs()}
    for name, (fmt, fields, gen) in CONFIGS.items():
        _, ref_fmt, ref_fields, ref_gen, _ = configs[name]
        assert fmt == ref_fmt and fields == ref_fields
        assert gen(500) == ref_gen(500)


@pytest.mark.parametrize("fmt", [
    "%d/%b/%Y:%H:%M:%S %z", "%d/%b/%Y:%H:%M:%S %Z", "%Y-%m-%dT%H:%M:%S%z",
    "%F %T", "%D %r", "%a %e %b %Y", "%G-W%V-%u", "%s", "%R %Ey %Od",
    "%%%n%t%j", "%B %d %l:%M %P", "%k.msec_frac", "%H:%M:%S.%usec_frac",
    "%c", "%x", "%Q", "trailing %", "%h %C",
])
def test_compile_strftime_matches_reference(fmt):
    try:
        want = ref_compile_strftime(fmt)
    except RefUnsupportedStrfField as exc:
        with pytest.raises(UnsupportedStrfField, match=str(exc).split("'")[1]):
            compile_strftime(fmt)
        return
    got = compile_strftime(fmt)
    if want is None:
        assert got is None
        return
    assert [tuple(i) for i in got.items] == [tuple(i) for i in want.items]
    assert got.default_zone == want.default_zone


def test_localized_string_and_raw_type():
    """TIME.LOCALIZEDSTRING (the reference's LocalizedTimeDissector) is a
    host value; the raw TIME.STRFTIME_... type is a span."""
    fmt = demolog.ZONETEXT_FORMAT
    with pytest.raises(UnsupportedFieldError, match="LOCALIZEDSTRING"):
        TorchBatchParser(fmt, ["TIME.LOCALIZEDSTRING:request.receive.time"], device="cpu")
    from logparser_tpu_torch.httpd.apache import ApacheLogFormat

    (ftype,) = ApacheLogFormat(fmt).strftime_types
    p = TorchBatchParser(fmt, [f"{ftype}:request.receive.time"], device="cpu")
    line = '1.2.3.4 - - [01/Jan/2024:10:00:00 CET] "GET / HTTP/1.1" 200 5'
    assert p.parse_batch([line]).to_dict()[f"{ftype}:request.receive.time"] == [
        "01/Jan/2024:10:00:00 CET"]
    # A format with no layout (an unsupported directive): no timestamp fields.
    with pytest.raises(UnsupportedFieldError, match="no producer"):
        TorchBatchParser("%h [%{%c}t]", ["TIME.EPOCH:request.receive.time.epoch"],
                         device="cpu")
