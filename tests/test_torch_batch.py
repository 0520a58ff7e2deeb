"""End to end on the CPU: TorchBatchParser equals TpuBatchParser.

``to_dict()`` of the port (plain versions of the kernels on the CPU) must
equal the reference's on every row the reference decodes on device, and
``needs_host`` must be exactly the rows the reference routes to its host
oracle.  The corpus is the benchmark's (in-repo generator, seed 42, 1%
garbage) plus crafted edge lines.
"""
import numpy as np
import pytest
import torch

from logparser_tpu.tools.demolog import HEADLINE_FIELDS, generate_combined_lines
from logparser_tpu_torch import TorchBatchParser, UnsupportedFieldError
from test_torch_harness import EDGE_LINES, corpus, reference_parser

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
]


def _compare(fmt, fields, lines):
    ref = reference_parser(fmt, fields).parse_batch(lines)
    ours = TorchBatchParser(fmt, fields, device="cpu").parse_batch(lines)
    assert ours.needs_host.tolist() == ref.oracle_row_ids.tolist()
    host = set(ours.needs_host.tolist())
    got, want = ours.to_dict(), ref.to_dict()
    assert list(got) == list(want)
    for fid in want:
        for i, (a, b) in enumerate(zip(got[fid], want[fid])):
            if i in host:
                assert a is None and not ours.valid[i], (fid, i)
            else:
                assert a == b and type(a) is type(b), (fid, i, a, b)
    on_device = ~np.isin(np.arange(len(lines)), ours.needs_host)
    np.testing.assert_array_equal(ours.valid[on_device], ref.valid[on_device])
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
    table = res.to_arrow()
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


@pytest.mark.parametrize("field", [
    "HTTP.PATH:request.firstline.uri.path",
    "HTTP.QUERYSTRING:request.firstline.uri.query",
    "HTTP.PROTOCOL.VERSION:request.firstline.protocol.version",
])
def test_unsupported_field_raises(field):
    with pytest.raises(UnsupportedFieldError):
        TorchBatchParser("combined", ["IP:connection.client.host", field], device="cpu")


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
