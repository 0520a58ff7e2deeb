"""End to end on the CPU: TorchBatchParser equals TpuBatchParser.

``to_dict()`` of the port (plain versions of the kernels on the CPU) must
equal the reference's on every row, the rows its host oracle rescues
included, and ``needs_host`` must be exactly the rows the reference
routes to its oracle (``valid``, ``reject_reasons`` and
``rescue_reasons`` equal too).  The corpus is the benchmark's (in-repo generator, seed 42, 1%
garbage) plus crafted edge lines; the URI chain adds the seed-53 corpus,
its own edge lines, a batch that regrows the query-string slots and one
that overflows at the 128-slot cap.
"""
import pytest
import torch

from logparser_tpu.tools.demolog import HEADLINE_FIELDS, generate_combined_lines
from logparser_tpu.tpu.batch import TpuBatchParser
from logparser_tpu_torch import TorchBatchParser, UnsupportedFieldError
from logparser_tpu_torch.tools.demolog import URI_CHAIN_FIELDS, uri_edge_lines
from test_torch_harness import (
    EDGE_LINES,
    assert_parse_matches_reference,
    assert_results_equal,
    corpus,
    reference_parser,
)

CONFIGS = [
    ("combined", HEADLINE_FIELDS),
    ("combined", ["TIME.YEAR:request.receive.time.year",
                  "TIME.MONTHNAME:request.receive.time.monthname",
                  "TIME.DATE:request.receive.time.date_utc",
                  "TIME.ZONE:request.receive.time.timezone",
                  "HTTP.PROTOCOL_VERSION:request.firstline.protocol",
                  "BYTESCLF:response.body.bytes",
                  "NUMBER:connection.client.logname"]),
    ("combined\ncommon", ["IP:connection.client.host", "BYTES:response.body.bytes",
                          "TIME.EPOCH:request.receive.time.epoch",
                          "HTTP.URI:request.firstline.uri"]),
    ("combined", URI_CHAIN_FIELDS),
]


def _grows(fields) -> bool:
    return any(".query." in f for f in fields)


_GROWN = {}


def _grown_reference(fmt, fields, slots):
    """One reference parser per (format, fields) whose query-string slots
    may grow, grown to ``slots`` before its first batch (one jit compile
    instead of one per slot count; values do not depend on the slot
    count) and shared by this file's tests: growing mutates a parser, so
    the read-only shared parsers are not used for these."""
    ref = _GROWN.get((fmt, tuple(fields)))
    if ref is None:
        ref = _GROWN[(fmt, tuple(fields))] = TpuBatchParser(fmt, list(fields))
    while ref.csr_slots < slots and ref._grow_csr_slots():
        pass
    return ref


def _compare(fmt, fields, lines, slots=32):
    ref_parser = _grown_reference(fmt, fields, slots) if _grows(fields) \
        else reference_parser(fmt, fields)
    ref = ref_parser.parse_batch(lines)
    ours = TorchBatchParser(fmt, fields, device="cpu").parse_batch(lines)
    assert_results_equal(ours, ref)
    if _grows(fields):
        assert ours.buf.shape == ref.buf.shape
    return ours, ref


def test_headline_corpus_matches_reference():
    lines = generate_combined_lines(2000, seed=42, garbage_fraction=0.01) + EDGE_LINES
    ours, ref = _compare("combined", HEADLINE_FIELDS, lines)
    assert ours.valid.sum() > 1900
    # The edge lines reach every route: escaped quote decoded on device,
    # escaped quote in %r to the host, the >19-digit %b patched exactly.
    assert len(ours.needs_host) >= 3
    by = dict(zip(lines, ours.to_pylist("BYTES:response.body.bytes")))
    assert 12345678901234567890 in by.values()
    assert 9223372036854775808 in by.values()


@pytest.mark.parametrize("fmt,fields", CONFIGS)
def test_mixed_corpus_matches_reference(fmt, fields):
    lines = corpus(31)
    lines += [ln.rsplit(' "', 2)[0] for ln in generate_combined_lines(40, seed=31)]
    _compare(fmt, fields, lines)


def test_to_arrow_carries_the_columns():
    pa = pytest.importorskip("pyarrow")
    lines = generate_combined_lines(50, seed=2, garbage_fraction=0.1)
    res = TorchBatchParser("combined", HEADLINE_FIELDS, device="cpu").parse_batch(lines)
    table = res.to_arrow(include_validity=False, strings="copy")
    assert table.num_rows == 50 and table.column_names == res.field_ids()
    assert table.schema.field("BYTES:response.body.bytes").type == pa.int64()
    assert table.schema.field("HTTP.URI:request.referer").type == pa.string()
    assert table.column("HTTP.URI:request.referer").to_pylist() == \
        res.to_pylist("HTTP.URI:request.referer")


def test_stage_seconds_are_recorded():
    res = TorchBatchParser("combined", HEADLINE_FIELDS, device="cpu").parse_batch(
        generate_combined_lines(20, seed=3))
    assert {"encode", "kernels", "materialize"} <= set(res.stage_seconds)
    assert res.d2h_bytes == (14 + 4 * 7) * 20 * 4


@pytest.mark.parametrize("fmt,field,item", [
    # strftime TIME.LOCALIZEDSTRING (time layouts)
    ("%h [%{%d/%b/%Y}t] %>s", "TIME.LOCALIZEDSTRING:request.receive.time", 5),
    # NGINX $time_iso8601 (compile_java_pattern)
    ("$remote_addr [$time_iso8601] $status", "TIME.EPOCH:request.receive.time.epoch", 5),
])
def test_unsupported_field_raises(fmt, field, item):
    with pytest.raises(UnsupportedFieldError, match=f"ROADMAP queue A item {item}"):
        TorchBatchParser(fmt, ["STRING:request.status.last", field], device="cpu")


BINARY_IP_LINES = ["\\x7F\\x00\\x00\\x01 200", "\\xC0\\xA8\\x01\\x80 404",
                   "\\xc0\\xa8\\x01 500", "1.2.3.4 200", "- 301", "", "x"]


def test_binary_ip_is_delivered_by_the_host_oracle():
    """$binary_remote_addr's IP (BinaryIPDissector, a host plan) equals the
    reference on every line; the status stays a device span."""
    fields = ["STRING:request.status.last", "IP:connection.client.host"]
    ours = assert_parse_matches_reference("$binary_remote_addr $status", fields,
                                          BINARY_IP_LINES)
    assert ours.to_pylist(fields[1])[:2] == ["127.0.0.1", "-64.-88.1.-128"]
    assert ours.rescue_reasons["host_fields"] == 5


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBatchParser("combined", HEADLINE_FIELDS)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBatchParser("combined", HEADLINE_FIELDS, device="cuda")


def test_empty_and_overlong_lines():
    lines = ["", "x" * 9000] + generate_combined_lines(3, seed=4)
    ours, _ = _compare("combined", HEADLINE_FIELDS, lines)
    assert 1 in ours.needs_host.tolist()    # truncated: the host decides
    assert not ours.valid[0]


def test_uri_chain_regrows_like_the_reference():
    """The seed-53 corpus plus the URI edge lines that fit 16 -> 32 slots
    (a 20-parameter query, a URI past the 192-byte window): one regrow on
    both sides, the 20-parameter line delivered from the device."""
    lines = generate_combined_lines(300, seed=53) + uri_edge_lines()[:-1]
    ours, ref = _compare("combined", URI_CHAIN_FIELDS, lines)
    assert ours.csr_regrows == 1 and ours.buf.shape[1] == 384
    twenty = lines.index(next(x for x in lines if "k19=v19" in x))
    assert ours.valid[twenty]
    assert ours.to_pylist("STRING:request.firstline.uri.query.*")[twenty]["k19"] == "v19"
    q = ours.to_pylist("STRING:request.firstline.uri.query.q")
    assert "café".encode().decode("latin-1") in q   # the reference's mojibake
    assert ours.to_pylist("HTTP.PORT:request.referer.port").count(81) == 1


def test_query_overflow_at_the_cap_goes_to_the_host():
    """More parameters than the 128-slot cap (156 in a 384-byte line, 200
    in a longer one), and a URI past the 1,536-byte window at the cap:
    three regrows, then those lines stay in needs_host.  The 5,000-byte
    URI puts the batch in the 8191-byte bucket."""
    fields = ["HTTP.PATH:request.firstline.uri.path",
              "STRING:request.firstline.uri.query.*",
              "STRING:request.firstline.uri.query.a"]
    edge = uri_edge_lines()
    lines = generate_combined_lines(100, seed=53) + edge + [
        edge[0].replace("/x/y?", "/p?" + "&".join(f"k{i}" for i in range(200)) + "&"),
        edge[0].replace("/x/y?", "/" + "z" * 5000 + "?"),
    ]
    ours, ref = _compare("combined", fields, lines, slots=128)
    assert ours.csr_regrows == 3 and ours.buf.shape[1] == 8191
    assert {len(lines) - 3, len(lines) - 2, len(lines) - 1} <= set(ours.needs_host.tolist())


def test_uri_chain_at_the_smallest_bucket():
    """A 128-byte bucket (both scan windows past L: the unwindowed
    split) with the request line and the referer alone."""
    fmt = '"%r" %>s "%{Referer}i"'
    fields = ["HTTP.PATH:request.firstline.uri.path",
              "HTTP.QUERYSTRING:request.firstline.uri.query",
              "STRING:request.firstline.uri.query.*",
              "HTTP.PROTOCOL.VERSION:request.firstline.protocol.version",
              "HTTP.HOST:request.referer.host", "HTTP.PORT:request.referer.port"]
    lines = []
    for ln in generate_combined_lines(200, seed=53) + uri_edge_lines()[:12]:
        parts = ln.split('"')
        lines.append(f'"{parts[1]}" 200 "{parts[3]}"'[:128])
    ours, _ = _compare(fmt, fields, lines)
    assert ours.buf.shape[1] == 128 and ours.csr_regrows == 0
