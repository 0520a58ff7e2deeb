"""The port's blob, aggregate-blob and stream entry points, on the CPU.

- ``TorchBatchParser.parse_blob`` against ``TpuBatchParser.parse_blob`` on
  the same blob (CRLF on some lines, a trailing newline): ``needs_host``
  is the reference's oracle rows, and ``to_dict()``, ``valid`` and
  ``to_arrow(strings="copy")`` equal the reference's on every row
  -- on headline and on the URI chain, where the port regrows its CSR
  slots 16 -> 32 inside the call (the reference parser is grown to 32
  before its first batch: one compile, values do not depend on the slot
  count; the URI edge line past the 128-slot cap is left to the stream
  tests, which regrow to 128 on the port alone);
- ``aggregate_blob`` against the reference's ``aggregate_blob`` over the
  same lines, the host oracle's rows folded in (state, counts,
  ``oracle_rows``, ``reject_items``);
- ``parse_batch_stream`` at depth 1 and 2, with the staged H2D on and off,
  and ``aggregate_batch_stream(depth=2)`` against one ``parse_batch`` /
  ``aggregate_batch`` per batch, across a mid-stream regrow;
- ``emit_views=False`` and the lazy line views.

Inputs come from the seeded generator; every comparison is exact.
"""
import pytest

from logparser_tpu.tpu.batch import TpuBatchParser
from logparser_tpu.tpu.batch import _BlobLines as RefBlobLines
from logparser_tpu_torch import TorchBatchParser
from logparser_tpu_torch.tools import demolog
from logparser_tpu_torch.tpu import batch as batch_mod
from logparser_tpu_torch.tpu.batch import _BlobLines, _SliceLines
from test_torch_harness import EDGE_LINES, assert_results_equal, reference_parser

N = 600


def _blob(lines, crlf_every=5):
    raw = [ln.encode() if isinstance(ln, str) else ln for ln in lines]
    return b"".join(r + (b"\r\n" if i % crlf_every == 2 else b"\n")
                    for i, r in enumerate(raw))


CONFIGS = {
    "headline": (demolog.HEADLINE_FIELDS,
                 lambda: demolog.generate_combined_lines(N, seed=81, garbage_fraction=0.02)
                 + EDGE_LINES),
    "uri_chain": (demolog.URI_CHAIN_FIELDS,
                  lambda: demolog.generate_combined_lines(N, seed=82)
                  # all but the edge line of 155 parameters (past the cap)
                  + [ln for ln in demolog.uri_edge_lines() if ln.count("&") < 100]),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def blob_pair(request):
    """(lines, blob, the reference's parse_blob, the port's parse_blob, the
    port parser) of one configuration."""
    fields, make = CONFIGS[request.param]
    lines = make()
    blob = _blob(lines)
    if request.param == "headline":
        ref = reference_parser("combined", fields)
    else:
        ref = TpuBatchParser("combined", list(fields))
        ref._grow_csr_slots()   # 32 slots: what the port regrows to
    ours = TorchBatchParser("combined", fields, device="cpu")
    return request.param, lines, blob, ref.parse_blob(blob), ours.parse_blob(blob), ours


def test_parse_blob_equals_the_reference(blob_pair):
    name, lines, blob, want, got, parser = blob_pair
    assert got.framer == "native" and got.lines_read == want.lines_read == len(lines)
    assert got.csr_regrows == (1 if name == "uri_chain" else 0)
    host = assert_results_equal(got, want)
    assert len(host) < 0.1 * len(lines)
    got_t = got.to_arrow(strings="copy")
    want_t = want.to_arrow(include_validity=True, strings="copy")
    assert got_t.equals(want_t)


def test_parse_blob_equals_parse_batch_of_its_lines(blob_pair):
    """The same parser's parse_batch over the framed lines (CR stripped);
    with emit_views=False the values are the same and the D2H smaller."""
    name, lines, blob, _, got, parser = blob_pair
    framed = [ln[:-1] if ln.endswith("\r") else ln for ln in lines]
    assert [ln.decode() for ln in _BlobLines(blob)] == framed
    want = parser.parse_batch(framed)
    plain = parser.parse_blob(blob, emit_views=False)
    for other in (want, plain):
        assert other.to_dict() == got.to_dict()
        assert other.needs_host.tolist() == got.needs_host.tolist()
    assert plain.to_arrow().equals(got.to_arrow())
    assert plain.d2h_bytes < got.d2h_bytes == want.d2h_bytes


def test_aggregate_blob_equals_the_reference():
    lines = (demolog.generate_combined_lines(1500, seed=83, garbage_fraction=0.02)
             + demolog.aggregate_edge_lines())
    ours = TorchBatchParser("combined", demolog.HEADLINE_FIELDS, device="cpu")
    out = ours.aggregate_blob(_blob(lines, crlf_every=3), demolog.DASHBOARD_OPS)
    assert len(out.needs_host) and out.fold_rows >= 4
    same = ours.aggregate_batch(lines, demolog.DASHBOARD_OPS)
    assert out.state == same.state and out.needs_host.tolist() == same.needs_host.tolist()
    ref = reference_parser("combined", demolog.HEADLINE_FIELDS)
    want = ref.aggregate_blob(_blob(lines, crlf_every=3), demolog.DASHBOARD_OPS)
    assert out.state.summary() == want.state.summary()
    assert out.state.to_ipc_bytes() == want.state.to_ipc_bytes()
    assert (out.good_lines, out.bad_lines, out.oracle_rows) == \
        (want.good_lines, want.bad_lines, want.oracle_rows)
    assert out.reject_items == want.reject_items
    assert out.good_lines + out.bad_lines == len(lines)


@pytest.mark.parametrize("blob", [b"", b"\n", b"a\r\n\r\nb", b"a\nb\n", b"x\r", b"\r\n\r\n"])
def test_blob_lines_view_equals_the_reference(blob):
    ours, ref = _BlobLines(blob), RefBlobLines(blob)
    assert len(ours) == len(ref) and list(ours) == list(ref)
    assert ours[:] == ref[:] and [ours[i] for i in range(len(ours))] == list(ref)
    view = _SliceLines(ours, 1, max(len(ours) - 1, 0))
    assert list(view) == list(ref)[1:] and view[:] == list(ref)[1:]
    if len(view):
        assert view[-1] == ref[len(ref) - 1]
    with pytest.raises(IndexError):
        view[len(view)]


def test_parse_blob_falls_back_when_the_framer_disagrees(monkeypatch):
    """A framer count that is not the line view's sends the blob's lines
    through parse_batch, as the reference does."""
    lines = demolog.generate_combined_lines(50, seed=84)
    parser = TorchBatchParser("combined", demolog.HEADLINE_FIELDS, device="cpu")
    want = parser.parse_batch(lines)
    real = batch_mod.encode_blob
    monkeypatch.setattr(batch_mod, "encode_blob",
                        lambda data, **kw: tuple(a[:-1] if i < 2 else a for i, a in
                                                 enumerate(real(data, **kw))))
    got = parser.parse_blob(_blob(lines))
    assert got.to_dict() == want.to_dict() and got.lines_read == len(lines)


def test_parse_blob_of_an_empty_blob():
    res = TorchBatchParser("combined", demolog.HEADLINE_FIELDS, device="cpu").parse_blob(b"")
    assert res.lines_read == 0 and res.needs_host.tolist() == []
    assert all(v == [] for v in res.to_dict().values())


def _stream_batches():
    """Headline, headline, the URI chain with its edge lines (one passes
    the 128-slot cap: 16 -> 128 mid-stream), headline."""
    return [demolog.generate_combined_lines(250, seed=85, garbage_fraction=0.02),
            demolog.generate_combined_lines(250, seed=86) + ["", "x\r"],
            demolog.generate_combined_lines(250, seed=87) + demolog.uri_edge_lines(),
            demolog.generate_combined_lines(250, seed=88, garbage_fraction=0.02)]


@pytest.fixture(scope="module")
def serial_results():
    batches = _stream_batches()
    parser = TorchBatchParser("combined", demolog.URI_CHAIN_FIELDS, device="cpu")
    return batches, [parser.parse_batch(b) for b in batches]


@pytest.mark.parametrize("depth,stage_h2d", [(1, None), (1, False), (2, True), (2, False)])
def test_parse_batch_stream_equals_parse_batch(serial_results, depth, stage_h2d):
    batches, want = serial_results
    parser = TorchBatchParser("combined", demolog.URI_CHAIN_FIELDS, device="cpu")
    got = list(parser.parse_batch_stream(batches, depth=depth, stage_h2d=stage_h2d))
    assert len(got) == len(batches) and parser.csr_slots == 128
    assert [r.csr_regrows for r in got] == [r.csr_regrows for r in want] == [0, 0, 3, 0]
    for g, w in zip(got, want):
        assert g.lines_read == w.lines_read
        assert g.to_dict() == w.to_dict()
        assert g.needs_host.tolist() == w.needs_host.tolist()
    assert [r.framer for r in got] == ["native", "numpy", "native", "native"]


def test_aggregate_batch_stream_at_depth_2_equals_aggregate_batch():
    batches = [demolog.generate_combined_lines(400, seed=s, garbage_fraction=0.02)
               + demolog.aggregate_edge_lines() for s in (89, 90, 91)]
    parser = TorchBatchParser("combined", demolog.HEADLINE_FIELDS, device="cpu")
    got = list(parser.aggregate_batch_stream(batches, demolog.DASHBOARD_OPS, depth=2))
    assert len(got) == len(batches)
    for b, out in zip(batches, got):
        want = parser.aggregate_batch(b, demolog.DASHBOARD_OPS)
        assert out.state == want.state
        assert out.needs_host.tolist() == want.needs_host.tolist()
        assert (out.good_lines, out.bad_lines, out.device_rows, out.fold_rows) == \
            (want.good_lines, want.bad_lines, want.device_rows, want.fold_rows)
